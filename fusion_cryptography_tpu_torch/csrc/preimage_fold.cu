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
// Layouts, the op tables and the tiled op walk (tile_run_ops, a warp a
// tile of lanes) are in preimage_ops.cuh, shared with assemble_spec.cu.
// The text comes from an op table (interop/device_serial.FoldTable), never
// from constants compiled in here: the parameter set's dst, degree and root
// are bytes of its pool.
//
// Design.  The TPU kernels evaluate the str() formats as log-depth merge
// trees of barrel shifts and rolls, because a TPU lane cannot place bytes
// at a data-dependent offset.  A GPU thread can, so:
//   * signer_fold_a / signer_fold_b run a warp per tile of consecutive
//     lanes (tile_run_ops): 32 lanes, one thread each, for signer_fold_b;
//     16 lanes, two threads each (one per output, each rendering every
//     other value and taking the other's by a shuffle), for signer_fold_a.
//     A thread walks the op table for its lane, renders each value in
//     decimal and streams the bytes into whole words.  A lane's rendered
//     lengths differ from its neighbours', so storing each word as soon as
//     it is complete would spread a warp's store over ~8 rows: ~0.7
//     32-byte sectors per word instead of 0.125.  So a
//     thread puts its words into its column of a ring of kRing rows in
//     shared memory, and after each group of items the warp stores every
//     row all of an output's threads have completed as one segment (128 B,
//     or two of 64 B), zero tails included.  Lanes that drift further than
//     the ring holds (rendered lengths of 1 against 11 bytes drift ~1,300
//     words apart in str(vk)) store the words outside it directly.  On
//     uniform values the lanes of a warp stay within ~25 words of each
//     other at secpar 256, so 64 rows never overflow there.  The values and
//     the extra words (str(vk), the prehash digits) are staged into shared
//     memory by cp.async 16 rows ahead of the rows being rendered.
//   * agg_fold is a shifted copy: every output word comes from at most a
//     few segments (const, triple, separator) at offsets known from the N
//     triple lengths, which differ from group to group.  Reading each
//     group's source words where it needs them scatters a warp's loads over
//     32 rows.  So a block takes a tile of 32 groups by kAggTW output rows.
//     It reads the tile's lengths into shared memory (one op per warp, one
//     group per lane, all at once); warp 0 turns them into each group's
//     segment offsets and lists the ops that overlap the tile's rows.  For a
//     triple the block copies the union of the source rows its groups need
//     into shared memory (cp.async), whole rows of the tile's 32 columns, in
//     one pass of up to kAggR rows, or, where the groups' offsets spread
//     wider, each group its own window (any spread is correct).  Each
//     thread ORs its group's words from shared memory into registers with
//     funnel shifts and stores out[w * G + g], a warp's stores one 128-B
//     segment.  The N triples are one strided view [words, N, G]: with
//     signer-major lanes (strides N*G, G and 1, as the pipeline lays them
//     out) a warp's copies of a row are one 128-B segment; with group-major
//     lanes (strides G*N, 1 and N) they span 32*N words.
//     A run of rows starts its walk at op 0 while the ops fit the lengths
//     a block holds (kAggOps: N <= 15).  With more (N=1,024 signers: 2,049
//     ops, ~22,000 runs of a ~2.8 M-word preimage) that walk would be O(N)
//     a run.  So a first launch (agg_prefix) sums each group's triple
//     lengths into prefix offsets, a block of warps a tile of groups, and
//     writes the totals; each run's warp 0 then finds, lane by lane, the
//     last op that starts at or before the run's first byte (galloping from
//     the run before it, or from the guess the group's total gives) and
//     the block walks from the least of them.
//
// What bounds them.  Their bytes, at G=8192, N=4, secpar=256 (B=32,768
// signers), counting full widths: signer_fold_a reads ~70 MB and writes ~475 MB,
// signer_fold_b reads ~270 MB and writes ~350 MB, agg_fold reads ~350 MB and
// writes ~351 MB: 0.16, 0.19 and 0.21 ms at 3.35 TB/s.  agg_fold re-reads
// only the spread of its tiles' windows (a few dozen rows per 128 on real
// triples, mostly from L2); its blocks wait on the lengths, the staged rows
// and their stores in turn, three blocks an SM overlapping them (PERF.md
// has its time against the bound).  The signer folds are bound by integer
// issue, not by memory: on an NVIDIA H100 80GB HBM3 at 700 W, at the verify
// call's inputs, signer_fold_a takes 2.4 and signer_fold_b 2.0 times its
// byte bound (PERF.md), and a copy of them without their global stores
// took as long.  Per value a thread issues ~50 instructions to render it
// (two 5-digit halves by reciprocal multiplies, no divisions or branches)
// and ~45 to append it (one 128-bit shift, four ring slots), most of them
// on the integer pipe, which takes two cycles a warp instruction.
#include "preimage_ops.cuh"  // FCT_HD, Source, TileWriter, tile_run_ops, cp.async

namespace {

// The signer folds: blocks of kTileWarps warps (preimage_ops.cuh), a warp a
// tile of 32 / G lanes, G threads a lane (signer_fold_a: G = 2, its two
// outputs; signer_fold_b: G = 1).

// The tile of 16 lanes whose lane 0 is batch lane b0, as L threads per
// caller from warp thread t0 (preimage_ops.cuh), with the warp's shared
// memory ``smem`` (a ring of R rows, then the stage buffers): thread t
// writes signer_fold_a's output t % 2 of lane t / 2 (0 = the challenge
// preimage, 1 = str(vk)); extra 0 = the prehash digits.
template <int L, int R>
FCT_HD void signer_fold_a_tile(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const int32_t* vk2d_t, const uint32_t* pre_w, int pre_rows,
                               const int32_t* pre_len, int64_t batch, int64_t b0, int t0,
                               uint32_t* smem, uint32_t* ch_out, int ch_width,
                               int32_t* ch_total, uint32_t* vk_out, int vk_width,
                               int32_t* vk_len) {
  constexpr int G = 2;
  TileWriter<L, R, G> w;
  uint32_t* const outs[G] = {ch_out, vk_out};
  const int widths[G] = {ch_width, vk_width};
  init_tile_writer(w, smem, outs, widths, batch, b0, t0);
  const int32_t* vals[L];
  Source ex[1][L];
  for (int l = 0; l < L; ++l) {
    const int64_t b = tile_lane_index(batch, b0, (t0 + l) / G);
    vals[l] = vk2d_t + b;
    ex[0][l] = make_source(pre_w + b, batch, pre_rows, pre_len[b]);
  }
  tile_run_ops(ops, n_ops, pool, vals, batch, ex, smem + R * kWarp, w);
  w.finish();
  int32_t* const totals[G] = {ch_total, vk_len};
  for (int l = 0; l < L; ++l) {
    if (w.live[l]) totals[(t0 + l) % G][b0 + (t0 + l) / G] = w.total[l];
  }
}

// signer_fold_b's tile of 32 lanes (``smem``: a ring of R rows, then the
// stage buffers): output 0 = the triple; extra 0 = str(vk), extra 1 = the
// prehash digits; values = c_hat centered.
template <int L, int R>
FCT_HD void signer_fold_b_tile(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const uint32_t* vk_buf, int vk_rows, const int32_t* vk_len,
                               const uint32_t* pre_w, int pre_rows, const int32_t* pre_len,
                               const int32_t* c_hat_t, int64_t batch, int64_t b0, int t0,
                               uint32_t* smem, uint32_t* tri_out, int tri_width,
                               int32_t* tri_total) {
  TileWriter<L, R, 1> w;
  uint32_t* const outs[1] = {tri_out};
  init_tile_writer(w, smem, outs, &tri_width, batch, b0, t0);
  const int32_t* vals[L];
  Source ex[2][L];
  for (int l = 0; l < L; ++l) {
    const int64_t b = tile_lane_index(batch, b0, t0 + l);
    vals[l] = c_hat_t + b;
    ex[0][l] = make_source(vk_buf + b, batch, vk_rows, vk_len[b]);
    ex[1][l] = make_source(pre_w + b, batch, pre_rows, pre_len[b]);
  }
  tile_run_ops(ops, n_ops, pool, vals, batch, ex, smem + R * kWarp, w);
  w.finish();
  for (int l = 0; l < L; ++l) {
    if (w.live[l]) tri_total[b0 + t0 + l] = w.total[l];
  }
}

// agg_fold, per group.  The aggregation preimage is a list of segments in
// op order: const (pool bytes) or extra e (group g's triple e).  Output
// word w of a group ORs the segments that overlap its bytes [4w, 4w + 4),
// each shifted to its byte offset.

// The N triples as strided views: group g's triple e has its packed word i
// at tb[i * row_stride + e * signer_stride + g * group_stride] and its
// length at tl[e * len_signer_stride + g * len_group_stride] bytes (clamped
// to the buffer's tri_rows words).
struct AggSrc {
  const uint32_t* tb;
  const int32_t* tl;
  int64_t row_stride, signer_stride, group_stride, len_signer_stride, len_group_stride;
  int tri_rows;
};

FCT_HD int agg_tri_len(const AggSrc& a, int e, int64_t g) {
  return clamp_int(a.tl[e * a.len_signer_stride + g * a.len_group_stride], 0, 4 * a.tri_rows);
}

// Bytes of op j for group g.
FCT_HD int agg_op_len(const int32_t* ops, int j, const AggSrc& a, int64_t g) {
  const int32_t* op = ops + j * kOpFields;
  return op[0] == kOpConst ? op[3] : agg_tri_len(a, op[2], g);
}

// With prefix offsets: op_at[2j], op_at[2j + 1] are the const bytes and the
// extras before op j (j <= n_ops; the extras in op order are triples 0, 1,
// ...), prefix[e * groups + g] group g's triple bytes up to triple e,
// inclusive.  Op j starts at op_at[2j] + prefix[(op_at[2j+1] - 1) * groups
// + g].
FCT_HD int agg_op_start(const int32_t* op_at, const int32_t* prefix, int64_t groups, int64_t g,
                        int j) {
  const int e = op_at[2 * j + 1];
  return op_at[2 * j] + (e ? prefix[(int64_t)(e - 1) * groups + g] : 0);
}

// The last op below n_ops that starts at or before byte b of group g (ops
// lie end to end from byte 0, so it holds byte b if any op does), galloping
// from op ``guess`` up or down, then halving the bracket.
FCT_HD int agg_last_op_at(const int32_t* op_at, const int32_t* prefix, int64_t groups,
                          int64_t g, int n_ops, int b, int guess) {
  guess = clamp_int(guess, 0, n_ops - 1);
  int lo, hi, step = 1;  // op lo starts at or before b; op hi after it, or hi == n_ops
  if (agg_op_start(op_at, prefix, groups, g, guess) <= b) {
    for (lo = guess;; step *= 2) {
      hi = lo + step;
      if (hi >= n_ops) {
        hi = n_ops;
        break;
      }
      if (agg_op_start(op_at, prefix, groups, g, hi) > b) break;
      lo = hi;
    }
  } else {
    for (hi = guess;; step *= 2) {
      lo = hi - step;
      if (lo <= 0) {
        lo = 0;
        break;
      }
      if (agg_op_start(op_at, prefix, groups, g, lo) <= b) break;
      hi = lo;
    }
  }
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (agg_op_start(op_at, prefix, groups, g, mid) <= b)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// The prefix launch's warps: warp ``part`` of ``parts`` takes a share of the
// N triples (agg_prefix_share), sums their clamped lengths for group g
// (agg_share_sum), then, given the sum of the shares before it, writes their
// inclusive prefix (agg_share_prefix).
FCT_HD void agg_prefix_share(int n_signers, int parts, int part, int& e0, int& e1) {
  const int per = (n_signers + parts - 1) / parts;
  e0 = part * per < n_signers ? part * per : n_signers;
  e1 = e0 + per < n_signers ? e0 + per : n_signers;
}

FCT_HD int agg_share_sum(const AggSrc& a, int e0, int e1, int64_t g) {
  int sum = 0;
  for (int e = e0; e < e1; ++e) sum += agg_tri_len(a, e, g);
  return sum;
}

FCT_HD void agg_share_prefix(const AggSrc& a, int e0, int e1, int64_t g, int64_t groups,
                             int before, int32_t* prefix) {
  for (int e = e0; e < e1; ++e) {
    before += agg_tri_len(a, e, g);
    prefix[(int64_t)e * groups + g] = before;
  }
}

// Does a segment of ``len`` bytes at byte ``s`` overlap the bytes [b0, b1)?
FCT_HD bool agg_overlaps(int s, int len, int b0, int b1) {
  return len > 0 && s < b1 && s + len > b0;
}

FCT_HD int floor4(int x) { return x >= 0 ? x / 4 : -((3 - x) / 4); }

// The segment's words [lo, hi] that output bytes [b0, b1) read (it overlaps
// them): the block's window of source rows for this group.
FCT_HD void agg_window_rows(int s, int len, int b0, int b1, int& lo, int& hi) {
  const int a = floor4(b0 - s);
  const int b = floor4(b1 - 1 - s);
  const int last = ((len + 3) >> 2) - 1;
  lo = a > 0 ? a : 0;
  hi = b < last ? b : last;
}

// Bits [8r, 8r + 32) of hi:lo (r in [0, 4)).
FCT_HD uint32_t funnel_r(uint32_t lo, uint32_t hi, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, 8 * r);
#else
  return r ? (lo >> (8 * r)) | (hi << (32 - 8 * r)) : lo;
#endif
}

// Word i of a segment of ``len`` bytes whose words [base, base + n) sit at
// src[(i - base) * stride]: zero outside the segment (and outside those
// words), the bytes past ``len`` masked off.
FCT_HD uint32_t agg_src_word(const uint32_t* src, int64_t stride, int base, int n, int len,
                             int i) {
  if (i < 0 || 4 * i >= len || i < base || i >= base + n) return 0u;
  return keep_bytes(src[(int64_t)(i - base) * stride], len - 4 * i);
}

// Output word w's bits from a segment at byte s of ``len`` bytes whose words
// [base, base + n) sit at src[(i - base) * stride] (zero where it does not
// overlap).  A word that straddles the edge of [base, base + n) gets only the
// bits of its source words inside; the pass over the next rows ORs in the
// rest.
FCT_HD uint32_t agg_word(int w, int s, int len, const uint32_t* src, int64_t stride, int base,
                         int n) {
  const int rel = 4 * w - s;  // the segment's byte at the word's byte 0
  if (rel >= len || rel <= -4) return 0u;
  const int i = floor4(rel);
  const int r = rel - 4 * i;
  return funnel_r(agg_src_word(src, stride, base, n, len, i),
                  agg_src_word(src, stride, base, n, len, i + 1), r);
}

// OR one segment into a thread's output words w_first + u * w_step (u < WPT)
// below w_end.  The segment's byte shift r is the same for all of them, so
// a word whose source words are whole and present takes one funnel shift of
// two loads; usually every word of the thread is such a word.  The others
// (the segment's ends, a pass's edges) are marked and composed one by one
// by agg_word, whose code is then instantiated once rather than per word.
template <int WPT>
FCT_HD void agg_compose(uint32_t* acc, int w_first, int w_step, int w_end, int s, int len,
                        const uint32_t* src, int64_t stride, int base, int n) {
  static_assert(WPT <= 32, "one bit per word");
  if (len <= 0) return;
  const int i0 = floor4(4 * w_first - s);
  const int r = 4 * w_first - s - 4 * i0;
  // fast words: source words i and (r ? i + 1 : i) in [lo, top) with all
  // four bytes live
  const int lo = base > 0 ? base : 0;
  const int whole = len >> 2;
  const int top = (base + n < whole ? base + n : whole) - (r ? 1 : 0);
  if (i0 >= lo && i0 + (WPT - 1) * w_step < top && w_first + (WPT - 1) * w_step < w_end) {
#pragma unroll
    for (int u = 0; u < WPT; ++u) {  // every word fast: the common case
      const uint32_t* p = src + (int64_t)(i0 + u * w_step - base) * stride;
      acc[u] |= funnel_r(p[0], r ? p[stride] : 0u, r);
    }
    return;
  }
  uint32_t slow = 0u;
#pragma unroll
  for (int u = 0; u < WPT; ++u) {
    const int i = i0 + u * w_step;
    if (w_first + u * w_step >= w_end) continue;
    if (i >= lo && i < top) {
      const uint32_t* p = src + (int64_t)(i - base) * stride;
      acc[u] |= funnel_r(p[0], r ? p[stride] : 0u, r);
    } else if (i >= -1 && 4 * i < len) {
      slow |= 1u << u;
    }
  }
  while (slow) {
    int k = 0;
    while (!((slow >> k) & 1u)) ++k;
    slow &= slow - 1u;
    const uint32_t v = agg_word(w_first + k * w_step, s, len, src, stride, base, n);
#pragma unroll
    for (int u = 0; u < WPT; ++u) acc[u] |= u == k ? v : 0u;
  }
}

// agg_fold: a block is a tile of kAggTG groups (one warp's lanes: one 128-B
// segment of an output row) by kAggTW output rows, kAggWarps warps, staging
// up to kAggR source rows of one triple at a time.  The block reads the
// lengths of kAggOps ops at once into shared memory (one op per warp, one
// group per lane); warp 0 walks them and lists those that overlap the
// block's rows.  kAggMinBlocks: three blocks an SM fit 80
// registers a thread without spills (four spill and ran slower on an H100).
constexpr int kAggTG = 32;
constexpr int kAggWarps = 8;
constexpr int kAggTW = 128;
constexpr int kAggR = 256;
static_assert(kAggTW + 1 <= kAggR, "a group's window of a run fits one pass");
constexpr int kAggOps = 32;
constexpr int kAggOpsWide = 8;  // with prefix offsets, ops held at once: a run meets 2 to 4
constexpr int kAggMinBlocks = 3;
constexpr int kPrefixWarps = 32;  // the prefix launch's warps a tile (shares of the N triples)

// A tile's staging buffer, rows [c_lo, c_lo + c_n) of one triple for the
// tile's TG groups (stage[r * TG + lane]); thread (row0, lane) copies rows
// row0, row0 + row_step, ...  On the card the copies are asynchronous
// (cp.async: every row of the pass in flight at once, no registers); the
// caller waits for them.  A warp's copies of a row are one contiguous
// 4*TG-byte segment when the groups' columns are (group_stride 1).  Where
// the tile's groups spread over more rows than a pass holds (hundreds at
// N=1,024: their offsets drift apart triple by triple), each group stages
// only its own window instead, from its own first row c_lo: the warp's
// copies of a row are then scattered, but one pass holds every window.
template <int TG>
FCT_HD void agg_stage_rows(uint32_t* stage, const AggSrc& a, int e, int64_t g, bool live,
                           int c_lo, int c_n, int row0, int row_step, int lane) {
  if (!live) return;
  const int64_t row_stride = a.row_stride;
  const uint32_t* p = a.tb + e * a.signer_stride + g * a.group_stride;
  for (int r = row0; r < c_n; r += row_step) {
#ifdef __CUDA_ARCH__
    __pipeline_memcpy_async(stage + r * TG + lane, p + (int64_t)(c_lo + r) * row_stride, 4);
#else
    stage[r * TG + lane] = p[(int64_t)(c_lo + r) * row_stride];
#endif
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kTileWarps * kWarp)
signer_fold_a_kernel(const int32_t* __restrict__ ops, int n_ops,
                     const uint32_t* __restrict__ pool,
                     const int32_t* __restrict__ vk2d_t,
                     const uint32_t* __restrict__ pre_w, int pre_rows,
                     const int32_t* __restrict__ pre_len, int64_t batch,
                     uint32_t* __restrict__ ch_out, int ch_width,
                     int32_t* __restrict__ ch_total, uint32_t* __restrict__ vk_out,
                     int vk_width, int32_t* __restrict__ vk_len) {
  extern __shared__ uint32_t tile_smem[];
  const int warp = threadIdx.x / kWarp;
  const int64_t b0 = ((int64_t)blockIdx.x * kTileWarps + warp) * (kWarp / 2);
  if (b0 >= batch) return;  // a whole warp past the batch
  signer_fold_a_tile<1, kRing>(ops, n_ops, pool, vk2d_t, pre_w, pre_rows, pre_len, batch, b0,
                               threadIdx.x % kWarp, tile_smem + warp * kTileSmemWords, ch_out,
                               ch_width, ch_total, vk_out, vk_width, vk_len);
}

__global__ void __launch_bounds__(kTileWarps * kWarp)
signer_fold_b_kernel(const int32_t* __restrict__ ops, int n_ops,
                     const uint32_t* __restrict__ pool,
                     const uint32_t* __restrict__ vk_buf, int vk_rows,
                     const int32_t* __restrict__ vk_len,
                     const uint32_t* __restrict__ pre_w, int pre_rows,
                     const int32_t* __restrict__ pre_len,
                     const int32_t* __restrict__ c_hat_t, int64_t batch,
                     uint32_t* __restrict__ tri_out, int tri_width,
                     int32_t* __restrict__ tri_total) {
  extern __shared__ uint32_t tile_smem[];
  const int warp = threadIdx.x / kWarp;
  const int64_t b0 = ((int64_t)blockIdx.x * kTileWarps + warp) * kWarp;
  if (b0 >= batch) return;
  signer_fold_b_tile<1, kRing>(ops, n_ops, pool, vk_buf, vk_rows, vk_len, pre_w, pre_rows,
                               pre_len, c_hat_t, batch, b0, threadIdx.x % kWarp,
                               tile_smem + warp * kTileSmemWords, tri_out, tri_width,
                               tri_total);
}

// A block's shared state: the lengths of a window of ops, their byte
// offsets in each group, and what warp 0 lists, the ops that overlap the
// block's rows.
struct AggTile {
  int lens[kAggOps][kAggTG];    // lengths of ops [jbase, jbase + kAggOps)
  int starts[kAggOps][kAggTG];  // their byte offsets
  int n;                        // ops listed: jbase + first, ...
  int first;
  int more;                     // go on from op ``next``
  int next;                     // (with prefix offsets, first the run's first op)
  int u_lo[kAggOps];            // a listed triple's source rows that the tile's groups read
  int u_hi[kAggOps];
  uint32_t stage[kAggR * kAggTG];
};

// Warp 0, lane = group of the tile: the byte offsets of the ``hold`` (at
// most kAggOps) ops held from s (op jbase's offset in this lane's group; on
// return the offset of op ``next``), and the list: the ops from the first
// to the last that overlaps the bytes [b0, b1) of some group, with each
// triple's union of source rows.  ``more`` when the held ops ran out before
// every group passed b1.
__device__ __forceinline__ void agg_walk(AggTile& sh, int n_ops, int jbase, int hold, bool live,
                                         int b0, int b1, int lane, int& s) {
  const int count = n_ops - jbase < hold ? n_ops - jbase : hold;
  int first = kAggOps, last = -1;
  for (int k = 0; k < count; ++k) {
    const int len = sh.lens[k][lane];
    sh.starts[k][lane] = s;
    if (live && agg_overlaps(s, len, b0, b1)) {
      first = first < k ? first : k;
      last = k;
    }
    s += len;
  }
  first = __reduce_min_sync(kAllThreads, first);
  last = __reduce_max_sync(kAllThreads, last);
  const int n = last < first ? 0 : last - first + 1;
  for (int q = 0; q < n; ++q) {
    const int k = first + q;
    const int len = sh.lens[k][lane], at = sh.starts[k][lane];
    int lo = 0x7fffffff, hi = -0x7fffffff - 1;
    if (live && agg_overlaps(at, len, b0, b1)) agg_window_rows(at, len, b0, b1, lo, hi);
    lo = __reduce_min_sync(kAllThreads, lo);
    hi = __reduce_max_sync(kAllThreads, hi);
    if (lane == 0) {
      sh.u_lo[q] = lo;
      sh.u_hi[q] = hi;
    }
  }
  const bool more = jbase + count < n_ops && __any_sync(kAllThreads, live && s < b1);
  if (lane == 0) {
    sh.n = n;
    sh.first = first;
    sh.more = more;
    sh.next = jbase + count;
  }
}

// Warp 0 of a run with prefix offsets, lane = group of the tile: the last
// op at or before byte b0 of each live group (from ``hint``, the run
// before's, or the guess from the group's total), the least of them in
// sh.next, and s = its offset in this lane's group.
__device__ __forceinline__ void agg_run_start(AggTile& sh, const int32_t* op_at,
                                              const int32_t* prefix, const int32_t* total,
                                              int64_t groups, int64_t g, bool live, int n_ops,
                                              int b0, int& hint, int& s) {
  int j = kIntMax;
  if (live) {
    if (hint < 0) hint = (int)((int64_t)b0 * n_ops / (total[g] > 0 ? total[g] : 1));
    hint = agg_last_op_at(op_at, prefix, groups, g, n_ops, b0, hint);
    j = hint;
  }
  const int jbase = __reduce_min_sync(kAllThreads, j);
  s = live ? agg_op_start(op_at, prefix, groups, g, jbase) : 0;
  if (threadIdx.x == 0) sh.next = jbase;
}

// kWide: with prefix offsets (op_at, prefix), each group's own window
// where the tile's spread exceeds a pass; else every run walks from op 0.
template <bool kWide>
__global__ void __launch_bounds__(kAggTG * kAggWarps, kAggMinBlocks)
agg_fold_kernel(const int32_t* __restrict__ ops, int n_ops,
                const uint32_t* __restrict__ pool, AggSrc src, int64_t groups,
                uint32_t* __restrict__ out, int out_width, int32_t* __restrict__ total,
                const int32_t* __restrict__ op_at, const int32_t* __restrict__ prefix) {
  constexpr int WPT = kAggTW / kAggWarps;  // output words per thread
  __shared__ AggTile sh;
  const int lane = threadIdx.x % kAggTG;
  const int warp = threadIdx.x / kAggTG;
  const int64_t g = (int64_t)blockIdx.x * kAggTG + lane;
  const bool live = g < groups;
  const int runs = (out_width + kAggTW - 1) / kAggTW;
  // with prefix offsets a block takes consecutive runs (each one's search
  // starts at the op the run before found), else runs gridDim.y apart
  const int per = (runs + gridDim.y - 1) / gridDim.y;
  const int run0 = kWide ? blockIdx.y * per : blockIdx.y;
  const int run_end = kWide ? (run0 + per < runs ? run0 + per : runs) : runs;
  const int run_step = kWide ? 1 : gridDim.y;
  constexpr int hold = kWide ? kAggOpsWide : kAggOps;
  int hint = -1;  // with prefix offsets: warp 0's last first op
  for (int run = run0; run < run_end; run += run_step) {
    const int w0 = run * kAggTW;
    const int w1 = w0 + kAggTW < out_width ? w0 + kAggTW : out_width;
    const int b0 = 4 * w0, b1 = 4 * w1;
    uint32_t acc[WPT];
#pragma unroll
    for (int u = 0; u < WPT; ++u) acc[u] = 0u;
    int jbase = 0, s = 0;  // the held ops' first, its byte offset in this lane's group (warp 0)
    if (kWide) {
      if (warp == 0)
        agg_run_start(sh, op_at, prefix, total, groups, g, live, n_ops, b0, hint, s);
      __syncthreads();
      jbase = sh.next;
    }
    for (;;) {
      for (int k = warp; k < hold && jbase + k < n_ops; k += kAggWarps)
        sh.lens[k][lane] = live ? agg_op_len(ops, jbase + k, src, g) : 0;
      __syncthreads();
      if (warp == 0) agg_walk(sh, n_ops, jbase, hold, live, b0, b1, lane, s);
      __syncthreads();
      const int n = sh.n;
      for (int q = 0; q < n; ++q) {
        const int k = sh.first + q;
        const int32_t* o = ops + (jbase + k) * kOpFields;
        const int my_s = sh.starts[k][lane];
        const int my_len = live ? sh.lens[k][lane] : 0;
        if (o[0] == kOpConst) {
          agg_compose<WPT>(acc, w0 + warp, kAggWarps, w1, my_s, my_len, pool + o[2], 1, 0,
                           (my_len + 3) >> 2);
          continue;
        }
        const int u_lo = sh.u_lo[q], u_hi = sh.u_hi[q];
        if (kWide && u_hi - u_lo >= kAggR) {  // spread wider than a pass: each its own window
          int lo = 0, hi = -1;
          if (live && agg_overlaps(my_s, my_len, b0, b1))
            agg_window_rows(my_s, my_len, b0, b1, lo, hi);
          agg_stage_rows<kAggTG>(sh.stage, src, o[2], g, live, lo, hi + 1 - lo, warp, kAggWarps,
                                 lane);
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncthreads();
          agg_compose<WPT>(acc, w0 + warp, kAggWarps, w1, my_s, my_len, sh.stage + lane, kAggTG,
                           lo, hi + 1 - lo);
          __syncthreads();  // before the next op's pass overwrites the stage
          continue;
        }
        for (int c_lo = u_lo; c_lo <= u_hi; c_lo += kAggR) {
          const int c_n = u_hi + 1 - c_lo < kAggR ? u_hi + 1 - c_lo : kAggR;
          agg_stage_rows<kAggTG>(sh.stage, src, o[2], g, live, c_lo, c_n, warp, kAggWarps, lane);
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncthreads();
          agg_compose<WPT>(acc, w0 + warp, kAggWarps, w1, my_s, my_len, sh.stage + lane, kAggTG,
                           c_lo, c_n);
          __syncthreads();  // before the next pass overwrites the stage
        }
      }
      const int more = sh.more;
      jbase = sh.next;
      __syncthreads();  // every warp has read the list before it is rewritten
      if (!more) break;
    }
    if (!kWide && run == 0 && warp == 0 && live) {
      for (int j = jbase; j < n_ops; ++j) s += agg_op_len(ops, j, src, g);
      total[g] = s;
    }
    if (live) {
#pragma unroll
      for (int u = 0; u < WPT; ++u) {
        const int w = w0 + warp + u * kAggWarps;
        if (w < w1) out[(int64_t)w * groups + g] = acc[u];
      }
    }
    __syncthreads();  // every warp has read sh.more before the next run's walk
  }
}

// The prefix launch: a block of kPrefixWarps warps a tile of kAggTG groups,
// warp ``part`` a share of the N triples (lane = group): the shares' sums,
// the sums of the shares before each, then the inclusive prefix; the last
// share's last thread writes the group's total (const_bytes: op_at's
// entry for n_ops, the table's const bytes).
__global__ void __launch_bounds__(kAggTG * kPrefixWarps)
agg_prefix_kernel(AggSrc src, int n_signers, int64_t groups,
                  const int32_t* __restrict__ const_bytes, int32_t* __restrict__ prefix,
                  int32_t* __restrict__ total) {
  __shared__ int sums[kPrefixWarps][kAggTG];
  const int lane = threadIdx.x % kAggTG;
  const int part = threadIdx.x / kAggTG;
  const int64_t g = (int64_t)blockIdx.x * kAggTG + lane;
  const bool live = g < groups;
  int e0, e1;
  agg_prefix_share(n_signers, kPrefixWarps, part, e0, e1);
  sums[part][lane] = live ? agg_share_sum(src, e0, e1, g) : 0;
  __syncthreads();
  if (!live) return;
  int before = 0;
  for (int p = 0; p < part; ++p) before += sums[p][lane];
  agg_share_prefix(src, e0, e1, g, groups, before, prefix);
  if (part == kPrefixWarps - 1) total[g] = *const_bytes + before + sums[part][lane];
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
  signer_fold_a_kernel<<<tile_blocks(batch, kWarp / 2), kTileWarps * kWarp,
                         kTileSmemBytes, (cudaStream_t)stream>>>(
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
  signer_fold_b_kernel<<<tile_blocks(batch, kWarp), kTileWarps * kWarp,
                         kTileSmemBytes, (cudaStream_t)stream>>>(
      ops, n_ops, pool, vk_buf, vk_rows, vk_len, pre_w, pre_rows, pre_len, c_hat_t,
      batch, tri_out, tri_width, tri_total);
  return (int)cudaGetLastError();
}

// tb, tl: the N triples as strided views (AggSrc).  With op_at
// (int32[n_ops + 1, 2], see agg_op_start) and prefix (int32[N, groups] of
// scratch) non-null: the prefix launch first, then runs that start at
// their first op; with both null one launch that walks every run from op 0.
extern "C" int fct_agg_fold(const int32_t* ops, int n_ops, const uint32_t* pool,
                            const uint32_t* tb, const int32_t* tl, int n_signers,
                            int64_t row_stride, int64_t signer_stride, int64_t group_stride,
                            int64_t len_signer_stride, int64_t len_group_stride, int tri_rows,
                            int64_t groups, uint32_t* out, int out_width, int32_t* total,
                            const int32_t* op_at, int32_t* prefix, void* stream) {
  if (groups <= 0 || out_width <= 0) return 0;
  const AggSrc src{tb, tl, row_stride, signer_stride, group_stride, len_signer_stride,
                   len_group_stride, tri_rows};
  const unsigned tiles = (unsigned)((groups + kAggTG - 1) / kAggTG);
  if (prefix != nullptr)
    agg_prefix_kernel<<<tiles, kAggTG * kPrefixWarps, 0, (cudaStream_t)stream>>>(
        src, n_signers, groups, op_at + 2 * n_ops, prefix, total);
  const int runs = (out_width + kAggTW - 1) / kAggTW;
  int blocks_y = runs < 65535 ? runs : 65535;
  if (prefix != nullptr) {  // about four waves of the card's resident blocks
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t want = (4LL * kAggMinBlocks * sms + tiles - 1) / tiles;
    blocks_y = want < blocks_y ? (want > 1 ? (int)want : 1) : blocks_y;
  }
  const dim3 grid(tiles, (unsigned)blocks_y);
  if (prefix != nullptr)
    agg_fold_kernel<true><<<grid, kAggTG * kAggWarps, 0, (cudaStream_t)stream>>>(
        ops, n_ops, pool, src, groups, out, out_width, total, op_at, prefix);
  else
    agg_fold_kernel<false><<<grid, kAggTG * kAggWarps, 0, (cudaStream_t)stream>>>(
        ops, n_ops, pool, src, groups, out, out_width, total, op_at, prefix);
  return (int)cudaGetLastError();
}
#endif
