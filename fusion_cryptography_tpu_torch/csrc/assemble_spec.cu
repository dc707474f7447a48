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
// thread can place bytes anywhere, so one thread per lane runs the same
// run_ops<1> walk as signer_fold_b (preimage_ops.cuh), any batch size.
//
// What bounds it: memory, counting full widths (the challenge spec at
// secpar=256, B=32,768: ~70 MB read, ~475 MB written, 0.16 ms at
// 3.35 TB/s).  The decimal rendering is ~70 integer operations per value.
// With one thread per lane the stores are latency-bound, as in the signer
// folds; with few lanes (the aggregation spec at G=8,192) the card is
// mostly idle.  agg_fold's word-run grid avoids that for its one spec.
#include "preimage_ops.cuh"  // FCT_HD, Writer, Source, run_ops

namespace {

constexpr int kExtraFields = 6;

// Lane b's view of the extras table.
struct SpecExtras {
  const int64_t* table;
  int64_t b;

  FCT_HD_MEMBER Source operator[](int e) const {
    const int64_t* t = table + (int64_t)e * kExtraFields;
    const uint32_t* buf = reinterpret_cast<const uint32_t*>(t[0]);
    const int32_t* len = reinterpret_cast<const int32_t*>(t[3]);
    return make_source(buf + b * t[2], t[1], (int)t[5], len[b * t[4]]);
  }
};

// Lane b: one writer of ``out_width`` words.
FCT_HD void assemble_spec_lane(const int32_t* ops, int n_ops, const uint32_t* pool,
                               const int32_t* values, int64_t vstride,
                               const int64_t* extras, int64_t batch, int64_t b,
                               uint32_t* out, int out_width, int32_t* total) {
  Writer ws[1] = {make_writer(out + b, batch, out_width)};
  const SpecExtras ex = {extras, b};
  run_ops<1>(ops, n_ops, pool, values ? values + b : values, vstride, ex, ws);
  finish(ws[0]);
  total[b] = ws[0].total;
}

#ifdef __CUDACC__
constexpr int kSpecThreads = 64;  // B=32,768 lanes -> 512 blocks over 132 SMs

__global__ void __launch_bounds__(kSpecThreads)
assemble_spec_kernel(const int32_t* __restrict__ ops, int n_ops,
                     const uint32_t* __restrict__ pool,
                     const int32_t* __restrict__ values, int64_t vstride,
                     const int64_t* __restrict__ extras, int64_t batch,
                     uint32_t* __restrict__ out, int out_width,
                     int32_t* __restrict__ total) {
  const int64_t b = (int64_t)blockIdx.x * kSpecThreads + threadIdx.x;
  if (b < batch) {
    assemble_spec_lane(ops, n_ops, pool, values, vstride, extras, batch, b, out,
                       out_width, total);
  }
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
  const unsigned grid = (unsigned)((batch + kSpecThreads - 1) / kSpecThreads);
  assemble_spec_kernel<<<grid, kSpecThreads, 0, (cudaStream_t)stream>>>(
      ops, n_ops, pool, values, vstride, extras, batch, out, out_width, total);
  return (int)cudaGetLastError();
}
#endif
