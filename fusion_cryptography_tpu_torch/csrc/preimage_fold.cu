// The three preimage folds of the hash pipeline, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of fusion_cryptography_tpu/ops/fold_pallas.py:
//   signer_fold_a <- _signer_a_call  (kernel 5: the str(vk) chunk and the
//                                     padded challenge preimage)
//   signer_fold_b <- _signer_b_call  (kernel 6: the triple
//                                     str((vk, i, challenge)))
//   agg_fold      <- _agg_fold_call  (kernel 7: N triples -> the padded
//                                     aggregation preimage)
//
// Layouts, the op tables and the per-lane op walk (Writer, Source,
// render_dec, run_ops) are in preimage_ops.cuh, shared with
// assemble_spec.cu.  The text comes from an op table
// (interop/device_serial.FoldTable), never from constants compiled in here:
// the parameter set's dst, degree and root are bytes of its pool.
//
// Design.  The TPU kernels evaluate the str() formats as log-depth merge
// trees of barrel shifts and rolls, because a TPU lane cannot place bytes
// at a data-dependent offset.  A GPU thread can, so:
//   * signer_fold_a / signer_fold_b run one thread per lane.  The thread
//     walks the op table once, renders each value in decimal (sign in
//     unsigned arithmetic, no leading zeros), and streams the bytes through
//     a 64-bit accumulator that stores whole words in order (a funnel shift
//     for unaligned appends).  signer_fold_a streams str(vk) into both of
//     its outputs in the same pass.  Threads index the batch, so a warp's
//     loads of a value row are one contiguous segment, and its stores land
//     on neighbouring lanes of nearby word rows.
//   * agg_fold is a shifted copy: every output word comes from at most a
//     few segments (const, triple, separator) at offsets known from the N
//     triple lengths.  So a thread computes a run of kAggWords words of one
//     group, and the grid covers groups x word runs: 8,192 groups give
//     ~344k threads instead of 8,192 serial lanes.  The N triple buffers are
//     read through a pointer table and strides, so a caller's strided views
//     of one [W, groups*N] buffer need no copy.
//
// What bounds it: memory.  At G=8192, N=4, secpar=256 (B=32,768 signers),
// counting full widths: signer_fold_a reads ~70 MB and writes ~475 MB,
// signer_fold_b reads ~270 MB and writes ~350 MB, agg_fold reads ~350 MB and
// writes ~351 MB: 0.16, 0.19 and 0.21 ms at 3.35 TB/s.  The decimal
// rendering is ~70 integer operations per value, far below that.  The
// per-lane kernels have only B threads (~250 per SM at B=32,768), so their
// stores are latency-bound; splitting a lane's values across threads needs
// a prefix sum of the rendered lengths and is left to a later change.
#include "preimage_ops.cuh"  // FCT_HD, Writer, Source, run_ops

namespace {

// Lane b of signer_fold_a: writer 0 = challenge preimage, writer 1 = str(vk);
// extra 0 = the prehash digits.
FCT_HD void signer_fold_a_lane(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const int32_t* vk2d_t, const uint32_t* pre_w,
                               int pre_rows, const int32_t* pre_len, int64_t batch,
                               int64_t b, uint32_t* ch_out, int ch_width,
                               int32_t* ch_total, uint32_t* vk_out, int vk_width,
                               int32_t* vk_len) {
  Writer ws[2] = {make_writer(ch_out + b, batch, ch_width),
                  make_writer(vk_out + b, batch, vk_width)};
  const Source ex[1] = {make_source(pre_w + b, batch, pre_rows, pre_len[b])};
  run_ops<2>(ops, n_ops, pool, vk2d_t + b, batch, ex, ws);
  finish(ws[0]);
  finish(ws[1]);
  ch_total[b] = ws[0].total;
  vk_len[b] = ws[1].total;
}

// Lane b of signer_fold_b: writer 0 = the triple; extra 0 = str(vk),
// extra 1 = the prehash digits; values = c_hat centered.
FCT_HD void signer_fold_b_lane(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const uint32_t* vk_buf, int vk_rows, const int32_t* vk_len,
                               const uint32_t* pre_w, int pre_rows, const int32_t* pre_len,
                               const int32_t* c_hat_t, int64_t batch, int64_t b,
                               uint32_t* tri_out, int tri_width, int32_t* tri_total) {
  Writer ws[1] = {make_writer(tri_out + b, batch, tri_width)};
  const Source ex[2] = {make_source(vk_buf + b, batch, vk_rows, vk_len[b]),
                        make_source(pre_w + b, batch, pre_rows, pre_len[b])};
  run_ops<1>(ops, n_ops, pool, c_hat_t + b, batch, ex, ws);
  finish(ws[0]);
  tri_total[b] = ws[0].total;
}

// agg_fold's view of group g: triple k is tb[k][w * row_stride + g * col_stride],
// its length tl[k][g * len_stride].
struct AggGroup {
  const int32_t* ops;
  int n_ops;
  const uint32_t* pool;
  const uint32_t* const* tb;
  const int32_t* const* tl;
  int64_t row_stride;
  int64_t col_off;
  int64_t len_off;
  int tri_rows;
};

FCT_HD int agg_seg_len(const AggGroup& a, int j) {
  const int32_t* op = a.ops + j * kOpFields;
  if (op[0] == kOpConst) return op[3];
  return clamp_int(a.tl[op[2]][a.len_off], 0, 4 * a.tri_rows);
}

// Word i of segment j (``len`` bytes), zero outside the segment.
FCT_HD uint32_t agg_seg_word(const AggGroup& a, int j, int len, int i) {
  if (i < 0 || 4 * i >= len) return 0u;
  const int32_t* op = a.ops + j * kOpFields;
  const uint32_t v = op[0] == kOpConst ? a.pool[op[2] + i]
                                       : a.tb[op[2]][(int64_t)i * a.row_stride + a.col_off];
  return keep_bytes(v, len - 4 * i);
}

// Output words [w0, w1) of one group (``out`` at its word 0, ``stride``
// elements between words): each word ORs the segments it overlaps, each
// shifted to its byte offset.
FCT_HD void agg_fold_words(const AggGroup& a, int w0, int w1, uint32_t* out,
                           int64_t stride) {
  int j = 0;
  int s = 0;
  int len = a.n_ops > 0 ? agg_seg_len(a, 0) : 0;
  for (int w = w0; w < w1; ++w) {
    const int lo = 4 * w;
    while (j < a.n_ops && s + len <= lo) {
      s += len;
      ++j;
      if (j < a.n_ops) len = agg_seg_len(a, j);
    }
    uint32_t v = 0u;
    int k = j;
    int sk = s;
    int lk = len;
    while (k < a.n_ops && sk < lo + 4) {
      const int rel = lo - sk;
      if (rel >= 0) {
        const int i = rel >> 2;
        const int r = 8 * (rel & 3);
        uint32_t x = agg_seg_word(a, k, lk, i) >> r;
        if (r) x |= agg_seg_word(a, k, lk, i + 1) << (32 - r);
        v |= x;
      } else {
        v |= agg_seg_word(a, k, lk, 0) << (8 * -rel);
      }
      sk += lk;
      ++k;
      if (k < a.n_ops) lk = agg_seg_len(a, k);
    }
    out[(int64_t)w * stride] = v;
  }
}

FCT_HD int32_t agg_total(const AggGroup& a) {
  int32_t t = 0;
  for (int j = 0; j < a.n_ops; ++j) t += agg_seg_len(a, j);
  return t;
}

FCT_HD AggGroup make_agg_group(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const uint32_t* const* tb, const int32_t* const* tl,
                               int64_t row_stride, int64_t col_stride,
                               int64_t len_stride, int tri_rows, int64_t g) {
  AggGroup a;
  a.ops = ops;
  a.n_ops = n_ops;
  a.pool = pool;
  a.tb = tb;
  a.tl = tl;
  a.row_stride = row_stride;
  a.col_off = g * col_stride;
  a.len_off = g * len_stride;
  a.tri_rows = tri_rows;
  return a;
}

#ifdef __CUDACC__
constexpr int kLaneThreads = 64;  // B=32,768 lanes -> 512 blocks over 132 SMs
constexpr int kAggThreads = 128;
constexpr int kAggWords = 256;    // output words per agg_fold thread

__global__ void __launch_bounds__(kLaneThreads)
signer_fold_a_kernel(const int32_t* __restrict__ ops, int n_ops,
                     const uint32_t* __restrict__ pool,
                     const int32_t* __restrict__ vk2d_t,
                     const uint32_t* __restrict__ pre_w, int pre_rows,
                     const int32_t* __restrict__ pre_len, int64_t batch,
                     uint32_t* __restrict__ ch_out, int ch_width,
                     int32_t* __restrict__ ch_total, uint32_t* __restrict__ vk_out,
                     int vk_width, int32_t* __restrict__ vk_len) {
  const int64_t b = (int64_t)blockIdx.x * kLaneThreads + threadIdx.x;
  if (b < batch) {
    signer_fold_a_lane(ops, n_ops, pool, vk2d_t, pre_w, pre_rows, pre_len, batch, b,
                       ch_out, ch_width, ch_total, vk_out, vk_width, vk_len);
  }
}

__global__ void __launch_bounds__(kLaneThreads)
signer_fold_b_kernel(const int32_t* __restrict__ ops, int n_ops,
                     const uint32_t* __restrict__ pool,
                     const uint32_t* __restrict__ vk_buf, int vk_rows,
                     const int32_t* __restrict__ vk_len,
                     const uint32_t* __restrict__ pre_w, int pre_rows,
                     const int32_t* __restrict__ pre_len,
                     const int32_t* __restrict__ c_hat_t, int64_t batch,
                     uint32_t* __restrict__ tri_out, int tri_width,
                     int32_t* __restrict__ tri_total) {
  const int64_t b = (int64_t)blockIdx.x * kLaneThreads + threadIdx.x;
  if (b < batch) {
    signer_fold_b_lane(ops, n_ops, pool, vk_buf, vk_rows, vk_len, pre_w, pre_rows,
                       pre_len, c_hat_t, batch, b, tri_out, tri_width, tri_total);
  }
}

__global__ void __launch_bounds__(kAggThreads)
agg_fold_kernel(const int32_t* __restrict__ ops, int n_ops,
                const uint32_t* __restrict__ pool, const uint32_t* const* tb,
                const int32_t* const* tl, int64_t row_stride, int64_t col_stride,
                int64_t len_stride, int tri_rows, int64_t groups,
                uint32_t* __restrict__ out, int out_width,
                int32_t* __restrict__ total) {
  const int64_t g = (int64_t)blockIdx.x * kAggThreads + threadIdx.x;
  if (g >= groups) return;
  const AggGroup a = make_agg_group(ops, n_ops, pool, tb, tl, row_stride, col_stride,
                                    len_stride, tri_rows, g);
  const int w0 = blockIdx.y * kAggWords;
  const int w1 = w0 + kAggWords < out_width ? w0 + kAggWords : out_width;
  agg_fold_words(a, w0, w1, out + g, groups);
  if (blockIdx.y == 0) total[g] = agg_total(a);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns cudaGetLastError().  ops int32[n_ops, 6] and pool int32[...] are a
// FoldTable; every other array is described in the lane functions above.
extern "C" int fct_signer_fold_a(const int32_t* ops, int n_ops, const uint32_t* pool,
                                 const int32_t* vk2d_t, const uint32_t* pre_w,
                                 int pre_rows, const int32_t* pre_len, int64_t batch,
                                 uint32_t* ch_out, int ch_width, int32_t* ch_total,
                                 uint32_t* vk_out, int vk_width, int32_t* vk_len,
                                 void* stream) {
  if (batch <= 0) return 0;
  const unsigned grid = (unsigned)((batch + kLaneThreads - 1) / kLaneThreads);
  signer_fold_a_kernel<<<grid, kLaneThreads, 0, (cudaStream_t)stream>>>(
      ops, n_ops, pool, vk2d_t, pre_w, pre_rows, pre_len, batch, ch_out, ch_width,
      ch_total, vk_out, vk_width, vk_len);
  return (int)cudaGetLastError();
}

extern "C" int fct_signer_fold_b(const int32_t* ops, int n_ops, const uint32_t* pool,
                                 const uint32_t* vk_buf, int vk_rows,
                                 const int32_t* vk_len, const uint32_t* pre_w,
                                 int pre_rows, const int32_t* pre_len,
                                 const int32_t* c_hat_t, int64_t batch,
                                 uint32_t* tri_out, int tri_width, int32_t* tri_total,
                                 void* stream) {
  if (batch <= 0) return 0;
  const unsigned grid = (unsigned)((batch + kLaneThreads - 1) / kLaneThreads);
  signer_fold_b_kernel<<<grid, kLaneThreads, 0, (cudaStream_t)stream>>>(
      ops, n_ops, pool, vk_buf, vk_rows, vk_len, pre_w, pre_rows, pre_len, c_hat_t,
      batch, tri_out, tri_width, tri_total);
  return (int)cudaGetLastError();
}

// ptrs: int64[2N] device array, N triple-buffer pointers then N length
// pointers; element (w, g) of triple k at ptrs[k] + w*row_stride + g*col_stride.
extern "C" int fct_agg_fold(const int32_t* ops, int n_ops, const uint32_t* pool,
                            const int64_t* ptrs, int n_signers, int64_t row_stride,
                            int64_t col_stride, int64_t len_stride, int tri_rows,
                            int64_t groups, uint32_t* out, int out_width,
                            int32_t* total, void* stream) {
  if (groups <= 0 || out_width <= 0) return 0;
  const dim3 grid((unsigned)((groups + kAggThreads - 1) / kAggThreads),
                  (unsigned)((out_width + kAggWords - 1) / kAggWords));
  const uint32_t* const* tb = reinterpret_cast<const uint32_t* const*>(ptrs);
  const int32_t* const* tl = reinterpret_cast<const int32_t* const*>(ptrs + n_signers);
  agg_fold_kernel<<<grid, kAggThreads, 0, (cudaStream_t)stream>>>(
      ops, n_ops, pool, tb, tl, row_stride, col_stride, len_stride, tri_rows, groups,
      out, out_width, total);
  return (int)cudaGetLastError();
}
#endif
