// Inverse NTT fused with the verify's per-row norm/weight reduction, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel fusion_cryptography_tpu/ops/ntt_mxu_pallas.py
// _build_norm_weight (kernel 3): for every row of NTT-domain residues
// u32[M, d] (bit-reversed order) compute the inverse negacyclic NTT with the
// n^-1 scale (ops/ntt.ntt_inv_u semantics), then the row's max |centered
// coefficient| and its count of nonzero coefficients.  The coefficients are
// never written out: only two int32 per row leave the kernel.
//
// Design.  The TPU version runs the transform as bf16 8-bit-limb matrix
// products on the MXU because the TPU has no 64-bit integer multiply.  A GPU
// has native 32x32->64 products, so this kernel runs the Gentleman–Sande
// butterflies directly: one row per d/2 threads, the row's d residues in
// shared memory, log2(d) stages separated by __syncthreads, each butterfly a
// Shoup modular multiply by a precomputed twiddle (the plan's brp_inv and
// brp_inv_shoup tables, stage h reading entries [h, 2h)).  The row
// reduction is a warp shuffle plus one shared-memory step per row.
//
// What bounds it: the input read (8 bytes per coefficient: residues arrive
// as int64) and ~d/2·log2(d) Shoup multiplies per row.  At G=8192 the
// verify's M = 8192·83 = 679,936 rows of d = 256 are 1.39 GB of reads, which
// is the floor at the card's memory bandwidth; the butterflies are a few
// integer ops per byte read.  Reading centered int32 aggregates directly
// (half the bytes) is left to a later change.
#include "ntt_butterfly.cuh"  // FCT_HD, mulmod_shoup, gs_butterfly

namespace {

// |centered(c)| = min(c, q - c) for a residue c, and its nonzero flag.
FCT_HD uint32_t centered_abs(uint32_t c, uint32_t q) {
  const uint32_t n = q - c;
  return c < n ? c : n;
}

#ifdef __CUDACC__
__global__ void intt_norm_weight_kernel(
    const int64_t* __restrict__ x, int64_t rows, int d,
    const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
    uint32_t n_inv, uint32_t n_inv_sh, uint32_t q,
    int32_t* __restrict__ nrm, int32_t* __restrict__ wgt) {
  extern __shared__ uint32_t smem[];
  const int half = d >> 1;  // threads per row, a multiple of 32
  const int rows_per_block = blockDim.x / half;
  const int r = threadIdx.x / half;
  const int i = threadIdx.x - r * half;
  const int64_t row = (int64_t)blockIdx.x * rows_per_block + r;
  const bool live = row < rows;
  uint32_t* a = smem + r * d;
  if (live) {
    const int64_t* xr = x + row * d;
    a[i] = (uint32_t)xr[i];
    a[i + half] = (uint32_t)xr[i + half];
  }
  __syncthreads();
  for (int h = half; h >= 1; h >>= 1) {
    if (live) gs_butterfly(a, i, h, half, tw, tw_sh, q);
    __syncthreads();
  }
  uint32_t m = 0;
  int32_t c = 0;
  if (live) {
    const uint32_t c0 = mulmod_shoup(a[i], n_inv, n_inv_sh, q);
    const uint32_t c1 = mulmod_shoup(a[i + half], n_inv, n_inv_sh, q);
    const uint32_t m0 = centered_abs(c0, q);
    const uint32_t m1 = centered_abs(c1, q);
    m = m0 > m1 ? m0 : m1;
    c = (c0 != 0) + (c1 != 0);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const uint32_t mo = __shfl_down_sync(0xffffffffu, m, off);
    m = mo > m ? mo : m;
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  uint32_t* red = smem + rows_per_block * d;  // [warps][2]
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * warp] = m;
    red[2 * warp + 1] = (uint32_t)c;
  }
  __syncthreads();
  if (live && i == 0) {
    uint32_t mm = 0;
    int32_t cc = 0;
    for (int w = warp; w < warp + (half >> 5); ++w) {
      mm = red[2 * w] > mm ? red[2 * w] : mm;
      cc += (int32_t)red[2 * w + 1];
    }
    nrm[row] = (int32_t)mm;
    wgt[row] = cc;
  }
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): x int64[rows, d] residues in [0, q),
// tw/tw_sh u32[d] (plan.brp_inv, plan.brp_inv_shoup), outputs int32[rows].
// d is a power of two in [64, 1024].  Returns cudaGetLastError().
extern "C" int fct_intt_norm_weight(const int64_t* x, int64_t rows, int d,
                                    const uint32_t* tw, const uint32_t* tw_sh,
                                    uint32_t n_inv, uint32_t n_inv_sh,
                                    uint32_t q, int32_t* nrm, int32_t* wgt,
                                    void* stream) {
  if (rows <= 0) return 0;
  const int half = d / 2;
  const int rows_per_block = half >= 256 ? 1 : 256 / half;
  const int threads = rows_per_block * half;
  const size_t smem = (size_t)rows_per_block * d * sizeof(uint32_t) +
                      (size_t)(threads / 32) * 2 * sizeof(uint32_t);
  const unsigned grid = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  intt_norm_weight_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      x, rows, d, tw, tw_sh, n_inv, n_inv_sh, q, nrm, wgt);
  return (int)cudaGetLastError();
}
#endif
