// Batched negacyclic NTT and inverse NTT for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute the same
// functions:
//   * fusion_cryptography_tpu/ops/ntt_mxu_pallas.py _build (kernel 4):
//     forward or inverse NTT of unsigned residues u32[M, d] in [0, q)
//     (ops/ntt.ntt_fwd_u / ntt_inv_u).  Its counterpart here is fct_ntt_u,
//     on the port's int64 residues.
//   * fusion_cryptography_tpu/ops/ntt_pallas.py _build (kernel 9): the same
//     transforms on centered int32 values (ops/ntt.ntt_fwd / ntt_inv).  Its
//     counterpart here is fct_ntt_centered, which centers on load and store.
// Forward: standard order in, bit-reversed order out; inverse: bit-reversed
// in, standard out, with the n^-1 scale.
//
// Design.  The TPU kernels are shaped by the TPU: kernel 4 runs the
// transform as dense bf16 8-bit-limb matrix products on the MXU, and kernel
// 9 runs transposed with stage-expanded twiddles, because the TPU has no
// 32x32->64 multiply and no sublane/lane broadcast.  A GPU has native
// 32-bit high products, so these kernels run the radix-2 butterflies
// directly (ntt_butterfly.cuh): d/2 threads per row, the row's d residues
// in shared memory, log2(d) stages separated by __syncthreads, each twiddle
// multiply a Shoup multiply by the plan's flat bit-reversed tables.  Loads
// and stores are coalesced along the row.
//
// What bounds it: the bytes.  At d = 256 a coefficient is read and written
// once (16 bytes as int64 residues, 8 as centered int32) against 9 integer
// ops per butterfly, 4 butterflies per coefficient.
#include "ntt_butterfly.cuh"  // FCT_HD, mulmod_shoup, ct/gs_butterfly

namespace {

// I/O forms.  Residues (int64 in [0, q)) load and store as they are;
// centered int32 values load as residues the way the JAX package's
// Field.to_unsigned does (negative values plus q, in uint32) and store as
// the centered representative of ops/field.to_centered (u > (q-1)/2 maps
// to u - q).
FCT_HD uint32_t load_coef(int64_t v, uint32_t) { return (uint32_t)v; }

FCT_HD uint32_t load_coef(int32_t v, uint32_t q) {
  return v < 0 ? (uint32_t)v + q : (uint32_t)v;
}

FCT_HD void store_coef(int64_t* out, uint32_t u, uint32_t) { *out = (int64_t)u; }

FCT_HD void store_coef(int32_t* out, uint32_t u, uint32_t q) {
  *out = u > (q >> 1) ? (int32_t)((int64_t)u - (int64_t)q) : (int32_t)u;
}

#ifdef __CUDACC__
template <bool kInverse, typename T>
__global__ void ntt_kernel(const T* __restrict__ x, T* __restrict__ y,
                           int64_t rows, int d,
                           const uint32_t* __restrict__ tw,
                           const uint32_t* __restrict__ tw_sh,
                           uint32_t n_inv, uint32_t n_inv_sh, uint32_t q) {
  extern __shared__ uint32_t smem[];
  const int half = d >> 1;  // threads per row
  const int rows_per_block = blockDim.x / half;
  const int r = threadIdx.x / half;
  const int i = threadIdx.x - r * half;
  const int64_t row = (int64_t)blockIdx.x * rows_per_block + r;
  const bool live = row < rows;
  uint32_t* a = smem + r * d;
  if (live) {
    const T* xr = x + row * d;
    a[i] = load_coef(xr[i], q);
    a[i + half] = load_coef(xr[i + half], q);
  }
  __syncthreads();
  if (kInverse) {
    for (int h = half; h >= 1; h >>= 1) {
      if (live) gs_butterfly(a, i, h, half, tw, tw_sh, q);
      __syncthreads();
    }
  } else {
    for (int m = 1; m < d; m <<= 1) {
      if (live) ct_butterfly(a, i, m, half, tw, tw_sh, q);
      __syncthreads();
    }
  }
  if (live) {
    uint32_t c0 = a[i];
    uint32_t c1 = a[i + half];
    if (kInverse) {
      c0 = mulmod_shoup(c0, n_inv, n_inv_sh, q);
      c1 = mulmod_shoup(c1, n_inv, n_inv_sh, q);
    }
    T* yr = y + row * d;
    store_coef(yr + i, c0, q);
    store_coef(yr + i + half, c1, q);
  }
}

template <typename T>
int launch_ntt(const T* x, T* y, int64_t rows, int d, const uint32_t* tw,
               const uint32_t* tw_sh, int inverse, uint32_t n_inv,
               uint32_t n_inv_sh, uint32_t q, void* stream) {
  if (rows <= 0) return 0;
  const int half = d / 2;
  const int rows_per_block = half >= 256 ? 1 : 256 / half;
  const int threads = rows_per_block * half;
  const size_t smem = (size_t)rows_per_block * d * sizeof(uint32_t);
  const unsigned grid = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = (cudaStream_t)stream;
  if (inverse)
    ntt_kernel<true, T><<<grid, threads, smem, s>>>(x, y, rows, d, tw, tw_sh,
                                                     n_inv, n_inv_sh, q);
  else
    ntt_kernel<false, T><<<grid, threads, smem, s>>>(x, y, rows, d, tw, tw_sh,
                                                      n_inv, n_inv_sh, q);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry points (bound with ctypes).  x, y: [rows, d], contiguous, not
// aliased; tw/tw_sh u32[d]: plan.brp/brp_shoup (forward) or
// plan.brp_inv/brp_inv_shoup (inverse); d a power of two in [64, 1024].
// Return cudaGetLastError().

// Kernel 4's counterpart: int64 residues in [0, q) in and out.
extern "C" int fct_ntt_u(const int64_t* x, int64_t* y, int64_t rows, int d,
                         const uint32_t* tw, const uint32_t* tw_sh, int inverse,
                         uint32_t n_inv, uint32_t n_inv_sh, uint32_t q,
                         void* stream) {
  return launch_ntt(x, y, rows, d, tw, tw_sh, inverse, n_inv, n_inv_sh, q, stream);
}

// Kernel 9's counterpart: centered int32 in and out.
extern "C" int fct_ntt_centered(const int32_t* x, int32_t* y, int64_t rows, int d,
                                const uint32_t* tw, const uint32_t* tw_sh,
                                int inverse, uint32_t n_inv, uint32_t n_inv_sh,
                                uint32_t q, void* stream) {
  return launch_ntt(x, y, rows, d, tw, tw_sh, inverse, n_inv, n_inv_sh, q, stream);
}
#endif
