// Radix-2 NTT butterflies on residues in shared memory, shared by the port's
// NTT kernels (ntt.cu) and the fused INTT + norm/weight kernel
// (intt_norm_weight.cu).
//
// Residues are uint32 in [0, q), q < 2^31 an odd prime.  A twiddle table
// is the flat bit-reversed layout of the reference (algebra/ntt.py:281): the
// stage with m blocks reads entries [m, 2m).  Every multiply by a twiddle is
// a Shoup multiply with the twiddle's precomputed companion word.
//
// Without nvcc, FCT_HD is `static inline` and these compile as plain C++
// (tests/test_torch_kernel_host.py builds them with the host compiler).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FCT_HD __device__ __forceinline__
#else
#define FCT_HD static inline
#endif

namespace {

FCT_HD uint32_t umulhi32(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// (a * s) mod q for any 32-bit a and a constant s < q with its Shoup word
// s_sh = floor(s * 2^32 / q); the result is the canonical residue.
FCT_HD uint32_t mulmod_shoup(uint32_t a, uint32_t s, uint32_t s_sh, uint32_t q) {
  const uint32_t r = a * s - umulhi32(a, s_sh) * q;
  return r >= q ? r - q : r;
}

// Butterfly i (0 <= i < d/2) of the forward (Cooley-Tukey) stage with m
// blocks of span 2t, t = (d/2)/m: (u, v) -> (u + w*v, u - w*v) with
// w = tw[m + j] for block j.
FCT_HD void ct_butterfly(uint32_t* a, int i, int m, int half,
                         const uint32_t* tw, const uint32_t* tw_sh, uint32_t q) {
  const int t = half / m;
  const int j = i / t;
  const int i0 = 2 * j * t + (i - j * t);
  const int i1 = i0 + t;
  const uint32_t u = a[i0];
  const uint32_t v = mulmod_shoup(a[i1], tw[m + j], tw_sh[m + j], q);
  uint32_t sum = u + v;  // u, v < q < 2^31: no wrap
  if (sum >= q) sum -= q;
  a[i0] = sum;
  a[i1] = u >= v ? u - v : u + (q - v);
}

// Butterfly i (0 <= i < d/2) of the inverse (Gentleman-Sande) stage with h
// blocks of span 2t, t = (d/2)/h: (u, v) -> (u + v, (u - v) * w[h + j]) for
// block j.
FCT_HD void gs_butterfly(uint32_t* a, int i, int h, int half,
                         const uint32_t* tw, const uint32_t* tw_sh, uint32_t q) {
  const int t = half / h;
  const int j = i / t;
  const int i0 = 2 * j * t + (i - j * t);
  const int i1 = i0 + t;
  const uint32_t u = a[i0];
  const uint32_t v = a[i1];
  uint32_t sum = u + v;  // u, v < q < 2^31: no wrap
  if (sum >= q) sum -= q;
  const uint32_t dif = u >= v ? u - v : u + (q - v);
  a[i0] = sum;
  a[i1] = mulmod_shoup(dif, tw[h + j], tw_sh[h + j], q);
}

}  // namespace
