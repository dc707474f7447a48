// The negacyclic NTT's butterfly network on one warp per row, shared by the
// port's NTT kernels (ntt.cu) and the aggregate check (intt_norm_weight.cu);
// its modular helpers also serve the lattice target (lattice_target.cu).
//
// Residues are uint32 in [0, q), q < 2^31 an odd prime.  A twiddle table
// is the flat bit-reversed layout of the reference (algebra/ntt.py:281): the
// stage with m blocks reads entries [m, 2m).  Every multiply by a twiddle is
// a Shoup multiply with the twiddle's precomputed companion word.
//
// A row of D = 32*E residues lives in one warp's registers, E a lane, in one
// of two layouts:
//   blocked  lane l holds k = l*E + e      (e = 0 .. E-1)
//   strided  lane l holds k = l + 32*e
// A stage pairs k and k + t (t = 2^b the pair distance).  In the blocked
// layout the pairs of stages with t < E lie inside a lane and those with
// E <= t < 32 across lanes l and l ^ (t/E) (one __shfl_xor_sync a
// register); in the strided layout every stage with t >= 32 lies inside a
// lane.  One per-warp transpose through shared memory (pad_index) joins the
// two, so the whole network runs without a block barrier:
//   inverse (Gentleman-Sande, t = 1, 2, .., D/2): blocked stages, exchange
//     stages, blocked -> strided, strided stages (the n^-1 scale fused into
//     the last);
//   forward (Cooley-Tukey, t = D/2, .., 1): strided stages, strided ->
//     blocked, exchange stages, blocked stages.
// Both keep the in-place index k, so the inverse ends in the strided layout
// in standard order and the forward in the blocked layout in the
// bit-reversed order of the reference.
//
// Without nvcc, FCT_HD is `static inline` and the per-lane functions compile
// as plain C++ (tests/test_torch_kernel_host.py runs them with a serial
// emulation of the warp's 32 lanes in place of the shuffles).
#pragma once

#include "fct_hd.cuh"

namespace {

constexpr int WARP = 32;

FCT_HD constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n >> 1); }

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

FCT_HD uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;  // a, b < q < 2^31: no wrap
  return s >= q ? s - q : s;
}

FCT_HD uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + (q - b);
}

// The canonical residue x mod q of any int32, for q in (2^30, 2^31).
FCT_HD uint32_t lift_residue(int32_t x, uint32_t q) {
  int32_t y = x < 0 ? x + (int32_t)q : x;  // [-(2^31 - q), 2^31)
  if (y < 0) y += (int32_t)q;
  const uint32_t u = (uint32_t)y;
  return u >= q ? u - q : u;
}

// The inverse's last stage's second twiddle times n^-1, and its Shoup word:
// stored in the table's unused slot 0.
FCT_HD void fused_last_twiddle(const uint32_t* tw, uint32_t n_inv, uint32_t n_inv_sh,
                               uint32_t q, uint32_t* w, uint32_t* w_sh) {
  const uint32_t v = mulmod_shoup(tw[1], n_inv, n_inv_sh, q);
  *w = v;
  *w_sh = (uint32_t)(((uint64_t)v << 32) / q);
}

// Load n consecutive values of T (4 or 8 bytes), p aligned to 16 bytes or
// to the run's size if smaller: on the card as 16-byte (or 8-byte) vectors.
template <int n, typename T>
FCT_HD void load_run(const T* p, T* out) {
#ifdef __CUDA_ARCH__
  constexpr int bytes = n * (int)sizeof(T);
  if constexpr (bytes % 16 == 0) {
    constexpr int per = 16 / (int)sizeof(T);
#pragma unroll
    for (int i = 0; i < n; i += per) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      if constexpr (sizeof(T) == 4) {
        out[i] = (T)v.x; out[i + 1] = (T)v.y; out[i + 2] = (T)v.z; out[i + 3] = (T)v.w;
      } else {
        out[i] = (T)(((uint64_t)v.y << 32) | v.x);
        out[i + 1] = (T)(((uint64_t)v.w << 32) | v.z);
      }
    }
  } else if constexpr (bytes == 8 && sizeof(T) == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = (T)v.x; out[1] = (T)v.y;
  } else
#endif
  {
#pragma unroll
    for (int i = 0; i < n; ++i) out[i] = p[i];
  }
}

// Shared-memory index of element k in a warp's transpose buffer (D + D/32
// words): one pad word per 32, so writes and reads in either layout are
// free of bank conflicts.
FCT_HD int pad_index(int k) { return k + (k >> 5); }

// ---- inverse (Gentleman-Sande): (u, v) -> (u + v, (u - v) * w) ----

// Stage b (t = 2^b < E) inside the lane, blocked layout.  Stage b has
// h = D/2^(b+1) blocks; the lane's pairs use the E/2^(b+1) consecutive
// twiddles from h + lane*E/2^(b+1).
template <int D, int b>
FCT_HD void gs_blocked_stage(uint32_t* x, int lane, const uint32_t* s_w,
                             const uint32_t* s_wsh, uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int t = 1 << b;
  constexpr int nj = E >> (b + 1);
  constexpr int h = D >> (b + 1);
  uint32_t w[nj], wsh[nj];
  load_run<nj>(s_w + h + lane * nj, w);
  load_run<nj>(s_wsh + h + lane * nj, wsh);
#pragma unroll
  for (int j = 0; j < nj; ++j) {
#pragma unroll
    for (int i = 0; i < t; ++i) {
      const int e0 = 2 * j * t + i;
      const uint32_t u = x[e0], v = x[e0 + t];
      x[e0] = add_mod(u, v, q);
      x[e0 + t] = mulmod_shoup(sub_mod(u, v, q), w[j], wsh[j], q);
    }
  }
}

// Stages b = b0 .. log2(E)-1, in that order.
template <int D, int b = 0>
FCT_HD void gs_blocked_stages(uint32_t* x, int lane, const uint32_t* s_w,
                              const uint32_t* s_wsh, uint32_t q) {
  if constexpr ((1 << b) < D / WARP) {
    gs_blocked_stage<D, b>(x, lane, s_w, s_wsh, q);
    gs_blocked_stages<D, b + 1>(x, lane, s_w, s_wsh, q);
  }
}

// Stage b with E <= t = 2^b < 32, blocked layout: the partner element of
// every register is in lane ^ (t/E); y holds the partner lane's registers
// from before the stage.  The lower lane keeps u + v, the upper (u - v) * w
// with u the partner's.
template <int D>
FCT_HD void gs_exchange_stage(uint32_t* x, const uint32_t* y, int lane, int b,
                              const uint32_t* s_w, const uint32_t* s_wsh, uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int lE = log2i(E);
  const int pl = 1 << (b - lE);
  const bool lower = (lane & pl) == 0;
  const int idx = (D >> (b + 1)) + (lane >> (b + 1 - lE));
  const uint32_t w = s_w[idx], wsh = s_wsh[idx];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t s = add_mod(x[e], y[e], q);
    const uint32_t m = mulmod_shoup(sub_mod(y[e], x[e], q), w, wsh, q);
    x[e] = lower ? s : m;
  }
}

// Stages b = 5 .. log2(D)-1 (t >= 32) inside the lane, strided layout:
// stage b pairs registers e and e + t/32 and reads the broadcast twiddle
// h + (e >> (b-4)).  The last stage (one block) scales by n^-1: its outputs
// are (u + v) * n^-1 and (u - v) * (w * n^-1), the second factor in slot 0
// of the table (fused_last_twiddle).
template <int D>
FCT_HD void gs_strided_stages(uint32_t* x, const uint32_t* s_w, const uint32_t* s_wsh,
                              uint32_t n_inv, uint32_t n_inv_sh, uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int L = log2i(D);
#pragma unroll
  for (int b = 5; b < L - 1; ++b) {
    const int te = 1 << (b - 5);
    const int h = D >> (b + 1);
#pragma unroll
    for (int e0 = 0; e0 < E; ++e0) {
      if (e0 & te) continue;
      const int idx = h + (e0 >> (b - 4));
      const uint32_t u = x[e0], v = x[e0 + te];
      x[e0] = add_mod(u, v, q);
      x[e0 + te] = mulmod_shoup(sub_mod(u, v, q), s_w[idx], s_wsh[idx], q);
    }
  }
  constexpr int te = E / 2;
  const uint32_t w = s_w[0], wsh = s_wsh[0];
#pragma unroll
  for (int e0 = 0; e0 < te; ++e0) {
    const uint32_t u = x[e0], v = x[e0 + te];
    x[e0] = mulmod_shoup(add_mod(u, v, q), n_inv, n_inv_sh, q);
    x[e0 + te] = mulmod_shoup(sub_mod(u, v, q), w, wsh, q);
  }
}

// ---- forward (Cooley-Tukey): (u, v) -> (u + w*v, u - w*v) ----

// Stages b = log2(D)-1 .. 5 (t >= 32) inside the lane, strided layout:
// stage b has m = D/2^(b+1) blocks, pairs registers e and e + t/32 and reads
// the broadcast twiddle m + (e >> (b-4)).
template <int D>
FCT_HD void ct_strided_stages(uint32_t* x, const uint32_t* s_w, const uint32_t* s_wsh,
                              uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int L = log2i(D);
#pragma unroll
  for (int b = L - 1; b >= 5; --b) {
    const int te = 1 << (b - 5);
    const int m = D >> (b + 1);
#pragma unroll
    for (int e0 = 0; e0 < E; ++e0) {
      if (e0 & te) continue;
      const int idx = m + (e0 >> (b - 4));
      const uint32_t u = x[e0];
      const uint32_t v = mulmod_shoup(x[e0 + te], s_w[idx], s_wsh[idx], q);
      x[e0] = add_mod(u, v, q);
      x[e0 + te] = sub_mod(u, v, q);
    }
  }
}

// Stage b with E <= t = 2^b < 32, blocked layout; y holds the partner lane
// (lane ^ (t/E))'s registers from before the stage.  One twiddle serves the
// lane; the upper lane's value is the one multiplied by it, so the lower
// lane keeps u + w*v and the upper u - w*v with u the partner's.
template <int D>
FCT_HD void ct_exchange_stage(uint32_t* x, const uint32_t* y, int lane, int b,
                              const uint32_t* s_w, const uint32_t* s_wsh, uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int lE = log2i(E);
  const bool lower = (lane & (1 << (b - lE))) == 0;
  const int idx = (D >> (b + 1)) + (lane >> (b + 1 - lE));
  const uint32_t w = s_w[idx], wsh = s_wsh[idx];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t u = lower ? x[e] : y[e];
    const uint32_t v = mulmod_shoup(lower ? y[e] : x[e], w, wsh, q);
    x[e] = lower ? add_mod(u, v, q) : sub_mod(u, v, q);
  }
}

// The stage with pair distance t < E inside the lane, blocked layout:
// m = D/(2t) blocks; the lane's pairs use the E/(2t) consecutive twiddles
// from m + lane*E/(2t).
template <int D, int t>
FCT_HD void ct_blocked_stage(uint32_t* x, int lane, const uint32_t* s_w,
                             const uint32_t* s_wsh, uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int nj = E / (2 * t);
  constexpr int m = D / (2 * t);
  uint32_t w[nj], wsh[nj];
  load_run<nj>(s_w + m + lane * nj, w);
  load_run<nj>(s_wsh + m + lane * nj, wsh);
#pragma unroll
  for (int j = 0; j < nj; ++j) {
#pragma unroll
    for (int i = 0; i < t; ++i) {
      const int e0 = 2 * j * t + i;
      const uint32_t u = x[e0];
      const uint32_t v = mulmod_shoup(x[e0 + t], w[j], wsh[j], q);
      x[e0] = add_mod(u, v, q);
      x[e0 + t] = sub_mod(u, v, q);
    }
  }
}

// The stages with t = t0, t0/2, .., 1, in that order (t0 = E/2 by default).
template <int D, int t = D / WARP / 2>
FCT_HD void ct_blocked_stages(uint32_t* x, int lane, const uint32_t* s_w,
                              const uint32_t* s_wsh, uint32_t q) {
  if constexpr (t >= 1) {
    ct_blocked_stage<D, t>(x, lane, s_w, s_wsh, q);
    ct_blocked_stages<D, t / 2>(x, lane, s_w, s_wsh, q);
  }
}

#ifdef __CUDACC__
// The warp's row from the blocked layout to the strided one (kToStrided) or
// back, through buf, the warp's D + D/32 words of shared memory (free again
// on return).
template <int D, bool kToStrided>
__device__ __forceinline__ void warp_transpose(uint32_t* x, int lane, uint32_t* buf) {
  constexpr int E = D / WARP;
#pragma unroll
  for (int e = 0; e < E; ++e) buf[pad_index(kToStrided ? lane * E + e : lane + WARP * e)] = x[e];
  __syncwarp();
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = buf[pad_index(kToStrided ? lane + WARP * e : lane * E + e)];
  __syncwarp();
}

// One row's whole network on a warp.  Inverse: blocked layout in, strided
// layout out (standard order, scaled by n^-1).
template <int D>
__device__ __forceinline__ void gs_warp_network(uint32_t* x, int lane, uint32_t* buf,
                                                const uint32_t* s_w, const uint32_t* s_wsh,
                                                uint32_t n_inv, uint32_t n_inv_sh, uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int lE = log2i(E);
  gs_blocked_stages<D>(x, lane, s_w, s_wsh, q);
#pragma unroll
  for (int b = lE; b < 5; ++b) {
    uint32_t y[E];
#pragma unroll
    for (int e = 0; e < E; ++e) y[e] = __shfl_xor_sync(0xffffffffu, x[e], 1 << (b - lE));
    gs_exchange_stage<D>(x, y, lane, b, s_w, s_wsh, q);
  }
  warp_transpose<D, true>(x, lane, buf);
  gs_strided_stages<D>(x, s_w, s_wsh, n_inv, n_inv_sh, q);
}

// Forward: strided layout in (standard order), blocked layout out
// (bit-reversed order).
template <int D>
__device__ __forceinline__ void ct_warp_network(uint32_t* x, int lane, uint32_t* buf,
                                                const uint32_t* s_w, const uint32_t* s_wsh,
                                                uint32_t q) {
  constexpr int E = D / WARP;
  constexpr int lE = log2i(E);
  ct_strided_stages<D>(x, s_w, s_wsh, q);
  warp_transpose<D, false>(x, lane, buf);
#pragma unroll
  for (int b = 4; b >= lE; --b) {
    uint32_t y[E];
#pragma unroll
    for (int e = 0; e < E; ++e) y[e] = __shfl_xor_sync(0xffffffffu, x[e], 1 << (b - lE));
    ct_exchange_stage<D>(x, y, lane, b, s_w, s_wsh, q);
  }
  ct_blocked_stages<D>(x, lane, s_w, s_wsh, q);
}
#endif

}  // namespace
