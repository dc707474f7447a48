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
// directly, with Shoup multiplies by the plan's flat bit-reversed tables.
//
// What bounds it: a coefficient is read and written once, 16 bytes as int64
// residues, 8 as centered int32; at d = 256 a lane issues ~100 instructions
// a coefficient (the butterflies' Shoup multiplies and modular corrections,
// the exchanges' selects).  So ntt_u is bound by the bytes and ntt_centered,
// with half the bytes a row, about as much by instruction issue.  Nothing
// else may hold the row up:
// * One warp per row, the row's E = d/32 residues in registers, the degree a
//   template parameter (every loop unrolls).  The butterfly network is the
//   one the aggregate check runs (ntt_butterfly.cuh): in-lane stages,
//   __shfl_xor_sync exchanges, one padded per-warp transpose under
//   __syncwarp; no block barrier inside it.
// * The inverse loads the row blocked (lane l holds k = l*E + e, 16-byte
//   loads) and stores it strided (k = l + 32*e: each store instruction
//   writes 32 consecutive coefficients).  The forward loads strided and
//   ends blocked; it transposes once more to store strided too: blocked
//   16-byte stores of int64 rows (64 bytes a lane, each store instruction
//   writing half of 32 sectors) held the forward well behind the inverse.
// * Twiddles and their Shoup words (2*d uint32) are staged once per block
//   in shared memory; that copy-in is the kernel's only __syncthreads, and
//   each warp's row loads are already in flight during it.
#include "ntt_butterfly.cuh"  // the stage functions, gs_ / ct_warp_network

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

// Lane `lane`'s E residues of a row in the blocked layout (k = lane*E + e;
// the row 16-byte aligned) or the strided one (k = lane + 32*e); stores are
// strided.
template <int E, typename T>
FCT_HD void load_blocked(const T* row, int lane, uint32_t q, uint32_t* x) {
  T v[E];
  load_run<E>(row + lane * E, v);
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = load_coef(v[e], q);
}

template <int E, typename T>
FCT_HD void load_strided(const T* row, int lane, uint32_t q, uint32_t* x) {
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = load_coef(row[lane + WARP * e], q);
}

template <int E, typename T>
FCT_HD void store_strided(T* row, int lane, uint32_t q, const uint32_t* x) {
#pragma unroll
  for (int e = 0; e < E; ++e) store_coef(row + lane + WARP * e, x[e], q);
}

#ifdef __CUDACC__
constexpr int kMaxWarps = 8;
// twiddles and the warps' transpose buffers fit the default 48 KB at d = 1024
static_assert((2 * 1024 + kMaxWarps * (1024 + 1024 / WARP)) * 4 <= 48 * 1024);

template <int D, bool kInverse, typename T>
__global__ void __launch_bounds__(kMaxWarps * WARP)
    ntt_kernel(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
               const uint32_t* __restrict__ tw, const uint32_t* __restrict__ tw_sh,
               uint32_t n_inv, uint32_t n_inv_sh, uint32_t q) {
  constexpr int E = D / WARP;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;
  uint32_t* s_wsh = smem + D;
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  uint32_t* buf = smem + 2 * D + warp * (D + D / WARP);
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / WARP) + warp;
  const bool live = row < rows;
  uint32_t v[E];
  if (live) {
    if (kInverse)
      load_blocked<E>(x + row * D, lane, q, v);
    else
      load_strided<E>(x + row * D, lane, q, v);
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    s_w[i] = tw[i];
    s_wsh[i] = tw_sh[i];
  }
  if (kInverse && threadIdx.x == 0) fused_last_twiddle(tw, n_inv, n_inv_sh, q, &s_w[0], &s_wsh[0]);
  __syncthreads();
  if (!live) return;  // a whole warp: the network's shuffles see full warps
  if (kInverse) {
    gs_warp_network<D>(v, lane, buf, s_w, s_wsh, n_inv, n_inv_sh, q);
    store_strided<E>(y + row * D, lane, q, v);
  } else {
    ct_warp_network<D>(v, lane, buf, s_w, s_wsh, q);
    warp_transpose<D, true>(v, lane, buf);  // for coalesced stores
    store_strided<E>(y + row * D, lane, q, v);
  }
}

// Warps (rows) per block: 8 while the launch still gives every SM two such
// blocks, else 4, so that a small launch spreads over more SMs.  (On an H100
// at d = 256, 8 ran the 32,768- and 65,536-row launches a little faster than
// 4 or 16, and 4 the 256-row ones.)
int ntt_warps(int64_t rows) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 1;
  return rows >= 2LL * kMaxWarps * sms ? kMaxWarps : 4;
}

template <int D, typename T>
int launch(const T* x, T* y, int64_t rows, const uint32_t* tw, const uint32_t* tw_sh,
           int inverse, uint32_t n_inv, uint32_t n_inv_sh, uint32_t q, cudaStream_t stream) {
  const auto kernel = inverse ? ntt_kernel<D, true, T> : ntt_kernel<D, false, T>;
  const int n_warps = ntt_warps(rows);
  const size_t smem = (2 * D + (size_t)n_warps * (D + D / WARP)) * sizeof(uint32_t);
  const unsigned grid = (unsigned)((rows + n_warps - 1) / n_warps);
  kernel<<<grid, n_warps * WARP, smem, stream>>>(x, y, rows, tw, tw_sh, n_inv, n_inv_sh, q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ntt(const T* x, T* y, int64_t rows, int d, const uint32_t* tw,
               const uint32_t* tw_sh, int inverse, uint32_t n_inv,
               uint32_t n_inv_sh, uint32_t q, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch<64>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q, s);
    case 128: return launch<128>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q, s);
    case 256: return launch<256>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q, s);
    case 512: return launch<512>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q, s);
    case 1024: return launch<1024>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry points (bound with ctypes).  x, y: [rows, d], contiguous, 16-byte
// aligned, not aliased; tw/tw_sh u32[d]: plan.brp/brp_shoup (forward) or
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
