// The verify's aggregate check in one pass over the int32 aggregates, for
// NVIDIA Hopper (sm_90a): per group g the observed sum
//   observed[g, k] = sum_r a[r, k] * agg[g, r, k] mod q      (int64 [G, d])
// and, per row (g, r), the inverse negacyclic NTT of agg[g, r, :] with the
// n^-1 scale, reduced to its max |centered coefficient| and its count of
// nonzero coefficients (int32 [G, rank] each).
//
// Replaces the TPU kernel fusion_cryptography_tpu/ops/ntt_mxu_pallas.py
// _build_norm_weight (kernel 3) together with the observed sum the JAX
// package computes beside it (scheme/device_pipeline.py j_lattice: dot_mod,
// then kernel 3).  The TPU runs the transform as bf16 8-bit-limb matrix
// products on the MXU because it has no 64-bit integer multiply; a GPU has
// native 32x32->64 products, so this kernel runs Gentleman-Sande butterflies
// with Shoup multiplies.
//
// What bounds it: integer instructions.  The input is one int32 read of the
// aggregate (4 bytes per coefficient); the butterflies, the lift, the
// observed sum's multiply-accumulate and the centered reduction are ~60
// instructions per coefficient.  The design keeps everything else off the
// memory system and out of block barriers:
//
// * One warp per row, the row's E = d/32 residues in registers.  The degree
//   is a template parameter, so every loop unrolls and no index math divides.
// * The row is loaded in the blocked layout (lane l holds k = l*E + e, one or
//   more 16-byte loads per lane), lifted to the canonical residue x mod q of
//   every int32 (two conditional corrections: q < 2^31 < 2q), multiplied by
//   a[r, k] (Shoup, against the (a_u, a_sh) table) and added to the lane's
//   per-position accumulators.  The NTT-domain positions of a and agg match,
//   so the INTT's output order does not matter to the observed sum.
// * Stages with pair distance t < E run inside the lane; stages with
//   E <= t < 32 exchange values with __shfl_xor_sync; then one per-warp
//   shared-memory transpose (padded: k + k/32, conflict-free both ways, under
//   __syncwarp) gives the strided layout (lane l holds k = l + 32*e) in which
//   every stage with t >= 32 runs inside the lane.  No block barrier inside
//   the butterfly network.  The last stage carries the n^-1 scale (its two
//   outputs are multiplied by n^-1 and by w*n^-1).
// * Only the max and the count leave the row (warp reductions), so the
//   coefficients may stay in any permutation; zero-ness does not depend on
//   the scale, the norm does.
// * Twiddles and their Shoup words (2*d uint32) are staged once per block in
//   shared memory; the blocked-layout stages read E/2^(b+1) consecutive
//   entries per lane as vectors, the strided ones read a broadcast entry.
// * A block takes one group; its warps stride over the group's rank rows and
//   reduce their accumulators in shared memory at the end, and observed[g, :]
//   is written coalesced.
//
// Without nvcc the per-lane functions compile as plain C++ (FCT_HD is
// `static inline`); tests/test_torch_kernel_host.py runs them with a serial
// emulation of the warp's 32 lanes in place of the shuffles.
#include "ntt_butterfly.cuh"  // the stage functions, gs_warp_network

namespace {

// |centered(c)| = min(c, q - c) for a residue c.
FCT_HD uint32_t centered_abs(uint32_t c, uint32_t q) {
  const uint32_t n = q - c;
  return c < n ? c : n;
}

// Lift a lane's E aggregate values (blocked layout, row offset lane*E) and
// add a[r, k] * x[k] to its accumulators.
template <int E>
FCT_HD void lane_lift_accumulate(const int32_t* row, const uint32_t* a_u_row,
                                 const uint32_t* a_sh_row, int lane, uint32_t q,
                                 uint32_t* x, uint32_t* acc) {
  uint32_t raw[E], au[E], ash[E];
  load_run<E>(reinterpret_cast<const uint32_t*>(row) + lane * E, raw);
  load_run<E>(a_u_row + lane * E, au);
  load_run<E>(a_sh_row + lane * E, ash);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    x[e] = lift_residue((int32_t)raw[e], q);
    acc[e] = add_mod(acc[e], mulmod_shoup(x[e], au[e], ash[e], q), q);
  }
}

// The lane's part of the row reduction: max |centered| and nonzero count.
template <int E>
FCT_HD void lane_norm_weight(const uint32_t* x, uint32_t q, uint32_t* m, uint32_t* c) {
  uint32_t mm = 0, cc = 0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t a = centered_abs(x[e], q);
    mm = a > mm ? a : mm;
    cc += x[e] != 0;
  }
  *m = mm;
  *c = cc;
}

#ifdef __CUDACC__
template <int D>
__global__ void agg_check_kernel(const int32_t* __restrict__ aggs, int rank,
                                 const uint32_t* __restrict__ a_u,
                                 const uint32_t* __restrict__ a_sh,
                                 const uint32_t* __restrict__ tw,
                                 const uint32_t* __restrict__ tw_sh, uint32_t n_inv,
                                 uint32_t n_inv_sh, uint32_t q, int64_t* __restrict__ observed,
                                 int32_t* __restrict__ nrm, int32_t* __restrict__ wgt) {
  constexpr int E = D / WARP;
  constexpr int PAD = D + D / WARP;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;
  uint32_t* s_wsh = smem + D;
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = threadIdx.x / WARP;
  const int n_warps = blockDim.x / WARP;
  uint32_t* buf = smem + 2 * D + warp * PAD;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    s_w[i] = tw[i];
    s_wsh[i] = tw_sh[i];
  }
  if (threadIdx.x == 0) fused_last_twiddle(tw, n_inv, n_inv_sh, q, &s_w[0], &s_wsh[0]);
  __syncthreads();

  const int64_t g = blockIdx.x;
  uint32_t acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0;
  for (int r = warp; r < rank; r += n_warps) {
    const int64_t row = g * rank + r;
    uint32_t x[E];
    lane_lift_accumulate<E>(aggs + row * D, a_u + (int64_t)r * D, a_sh + (int64_t)r * D,
                            lane, q, x, acc);
    gs_warp_network<D>(x, lane, buf, s_w, s_wsh, n_inv, n_inv_sh, q);
    uint32_t m, c;
    lane_norm_weight<E>(x, q, &m, &c);
    m = __reduce_max_sync(0xffffffffu, m);
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) {
      nrm[row] = (int32_t)m;
      wgt[row] = (int32_t)c;
    }
  }
  // observed[g, :]: the warps' accumulators, summed mod q
#pragma unroll
  for (int e = 0; e < E; ++e) buf[pad_index(lane * E + e)] = acc[e];
  __syncthreads();
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    uint32_t s = 0;
    for (int w = 0; w < n_warps; ++w) s = add_mod(s, smem[2 * D + w * PAD + pad_index(k)], q);
    observed[g * D + k] = (int64_t)s;
  }
}

// Warps per block: the count in [4, 16] that leaves the fewest idle warp
// slots over the group's rows (the larger count on a tie).
int warps_for(int rank) {
  int best = 4, waste = 1 << 30;
  for (int n = 4; n <= 16; ++n) {
    const int wn = (rank + n - 1) / n * n - rank;
    if (wn <= waste) best = n, waste = wn;
  }
  return best;
}

template <int D>
int launch(const int32_t* aggs, int64_t groups, int rank, const uint32_t* a_u,
           const uint32_t* a_sh, const uint32_t* tw, const uint32_t* tw_sh, uint32_t n_inv,
           uint32_t n_inv_sh, uint32_t q, int64_t* observed, int32_t* nrm, int32_t* wgt,
           cudaStream_t stream) {
  const int n_warps = warps_for(rank);
  const size_t smem = (2 * D + (size_t)n_warps * (D + D / WARP)) * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        agg_check_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  agg_check_kernel<D><<<(unsigned)groups, n_warps * WARP, smem, stream>>>(
      aggs, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q, observed, nrm, wgt);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): aggs int32[groups, rank, d] (any int32,
// lifted to x mod q), a_u/a_sh u32[rank, d] (a mod q and its Shoup words),
// tw/tw_sh u32[d] (plan.brp_inv, plan.brp_inv_shoup); outputs observed
// int64[groups, d], nrm/wgt int32[groups, rank].  d is a power of two in
// [64, 1024], q an odd prime in (2^30, 2^31).  Returns a cudaError_t.
extern "C" int fct_intt_norm_weight(const int32_t* aggs, int64_t groups, int rank, int d,
                                    const uint32_t* a_u, const uint32_t* a_sh,
                                    const uint32_t* tw, const uint32_t* tw_sh,
                                    uint32_t n_inv, uint32_t n_inv_sh, uint32_t q,
                                    int64_t* observed, int32_t* nrm, int32_t* wgt,
                                    void* stream) {
  if (groups <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return launch<64>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                               observed, nrm, wgt, s);
    case 128: return launch<128>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                 observed, nrm, wgt, s);
    case 256: return launch<256>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                 observed, nrm, wgt, s);
    case 512: return launch<512>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                 observed, nrm, wgt, s);
    case 1024: return launch<1024>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh,
                                   q, observed, nrm, wgt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
