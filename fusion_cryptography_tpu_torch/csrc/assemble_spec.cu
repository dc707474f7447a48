// Generic preimage assembly from any PreimageSpec, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel _build of fusion_cryptography_tpu/ops/
// assemble_pallas.py (kernel 8), in its output="words" mode: the spec's
// consts, decimal cells and ragged extras, concatenated per lane into
// packed words u32[out_width, B] zero past the content, and the lengths
// i32[B].
//
// The program is the spec's op table (interop/device_serial.spec_table):
// consts, separators and the parameter set's dst, degree and root are bytes
// of its pool, never constants compiled in here.  Values are i32[K, B]
// centered with row stride ``vstride``.  Extra e is described by row e of
// an int64 table: (words pointer, row stride, column stride, lengths
// pointer, lengths stride, word rows), so a caller's strided column views
// of one buffer need no copy.  A length is clamped to [0, 4 * rows].
//
// Design.  The TPU kernel evaluates the spec as a log-depth merge tree of
// barrel shifts inside VMEM, because a TPU lane cannot place bytes at a
// data-dependent offset, and needs the batch in tiles of 128 lanes.  A GPU
// thread can place bytes anywhere, so the kernel runs signer_fold_b's
// tiled walk (tile_run_ops, preimage_ops.cuh) on the spec's table: a warp
// a tile of 32 consecutive lanes, one thread a lane, any batch size.  Each
// thread renders its lane's values (a value and its separator one string
// of at most 13 bytes, appended by one 128-bit shift) into its column of a
// 64-row ring in shared memory; the warp stores every row its threads have
// all completed as one 128-byte segment, and finish() stores the rest up
// to the width, the rate padding's zero words included.  Values and extra
// words are staged into shared memory by cp.async 16 rows ahead.  Lanes
// that drift further apart than the ring holds store the words outside it
// directly (exact, slower).  The extras are read through the table: each
// thread builds its lane's Source of extra e when an op needs it, so the
// staging reads through any column stride (the aggregation spec's triple
// views are N words apart).  Lanes past the batch run on the last lane's
// inputs and store nothing.
//
// What bounds it: integer issue, as in the signer folds (a copy of those
// without their global stores took as long on an H100).  Per value a
// thread issues ~50 instructions to render it and ~45 to append it; its
// bytes (the challenge spec at secpar=256, B=32,768: ~70 MB read,
// ~240 MB written) take 0.09 ms at 3.35 TB/s.  The aggregation spec
// (extras only, 8,192 lanes) is 256 warps for 528 schedulers; agg_fold's
// word-run grid fills the card for that one spec.
#include "preimage_ops.cuh"  // FCT_HD, Source, TileWriter, tile_run_ops

namespace {

constexpr int kExtraFields = 6;

// Extra e of batch lane b, from row e of the extras table.
FCT_HD Source spec_extra(const int64_t* table, int e, int64_t b) {
  const int64_t* t = table + (int64_t)e * kExtraFields;
  const uint32_t* buf = reinterpret_cast<const uint32_t*>(t[0]);
  const int32_t* len = reinterpret_cast<const int32_t*>(t[3]);
  return make_source(buf + b * t[2], t[1], (int)t[5], len[b * t[4]]);
}

// A tile's extras as tile_run_ops reads them: [e][l] is extra e of thread
// l's lane.
template <int L>
struct SpecExtras {
  struct Lanes {
    const int64_t* table;
    int e;
    int64_t lane[L];
    FCT_HD_MEMBER Source operator[](int l) const { return spec_extra(table, e, lane[l]); }
  };
  const int64_t* table;
  int64_t lane[L];

  FCT_HD_MEMBER Lanes operator[](int e) const {
    Lanes x;
    x.table = table;
    x.e = e;
    for (int l = 0; l < L; ++l) x.lane[l] = lane[l];
    return x;
  }
};

// The tile of 32 lanes whose lane 0 is batch lane b0, as L threads per
// caller from warp thread t0 (preimage_ops.cuh), with the warp's shared
// memory ``smem`` (a ring of R rows, then the stage buffers).
template <int L, int R>
FCT_HD void assemble_spec_tile(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const int32_t* values, int64_t vstride, const int64_t* extras,
                               int64_t batch, int64_t b0, int t0, uint32_t* smem,
                               uint32_t* out, int out_width, int32_t* total) {
  TileWriter<L, R, 1> w;
  uint32_t* const outs[1] = {out};
  init_tile_writer(w, smem, outs, &out_width, batch, b0, t0);
  const int32_t* vals[L];
  SpecExtras<L> ex;
  ex.table = extras;
  for (int l = 0; l < L; ++l) {
    const int64_t b = tile_lane_index(batch, b0, t0 + l);
    vals[l] = values ? values + b : values;
    ex.lane[l] = b;
  }
  tile_run_ops(ops, n_ops, pool, vals, vstride, ex, smem + R * kWarp, w);
  w.finish();
  for (int l = 0; l < L; ++l) {
    if (w.live[l]) total[b0 + t0 + l] = w.total[l];
  }
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kTileWarps * kWarp)
assemble_spec_kernel(const int32_t* __restrict__ ops, int n_ops,
                     const uint32_t* __restrict__ pool,
                     const int32_t* __restrict__ values, int64_t vstride,
                     const int64_t* __restrict__ extras, int64_t batch,
                     uint32_t* __restrict__ out, int out_width,
                     int32_t* __restrict__ total) {
  extern __shared__ uint32_t tile_smem[];
  const int warp = threadIdx.x / kWarp;
  const int64_t b0 = ((int64_t)blockIdx.x * kTileWarps + warp) * kWarp;
  if (b0 >= batch) return;  // a whole warp past the batch
  assemble_spec_tile<1, kRing>(ops, n_ops, pool, values, vstride, extras, batch, b0,
                               threadIdx.x % kWarp, tile_smem + warp * kTileSmemWords, out,
                               out_width, total);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): launches on ``stream`` and returns
// cudaGetLastError().  ops int32[n_ops, 6] and pool are the spec's table;
// values may be null when the spec has no numbers; extras is the int64
// table above (device memory).
extern "C" int fct_assemble_spec(const int32_t* ops, int n_ops, const uint32_t* pool,
                                 const int32_t* values, int64_t vstride,
                                 const int64_t* extras, int64_t batch, uint32_t* out,
                                 int out_width, int32_t* total, void* stream) {
  if (batch <= 0) return 0;
  assemble_spec_kernel<<<tile_blocks(batch, kWarp), kTileWarps * kWarp, kTileSmemBytes,
                         (cudaStream_t)stream>>>(ops, n_ops, pool, values, vstride, extras,
                                                 batch, out, out_width, total);
  return (int)cudaGetLastError();
}
#endif
