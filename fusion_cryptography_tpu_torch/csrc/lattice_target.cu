// The lattice check's target half for NVIDIA Hopper (sm_90a): per group g
//   target[i] = sum_k alpha_hat[g,k,i] * (c_hat[g,k,i] * vk_l[g,k,i] + vk_r[g,k,i]) mod q,
// compared with the observed sum A.agg (kernel intt_norm_weight's output)
// over every i, and the rank rows' norms and weights against their limits:
// (eq, norm_ok, weight_ok) as bytes [G].
//
// Replaces the stage the JAX package compiles with XLA inside j_lattice
// (fusion_cryptography_tpu/scheme/device_pipeline.py:545-554: to_unsigned,
// to_mont, mont_mul, add_mod, sum_mod of ops/field.py:181, the all() and
// the two max() checks), in the port's torch glue about twenty int64 passes
// over [G, N, d].  The residues are canonical, so any exact reduction gives
// the Montgomery products' values bit for bit: a product of two residues
// (< 2^62) is reduced by a Barrett step with mu = floor(2^64 / q) (the
// remainder is below 2q, one correction).
//
// What bounds it: bytes (vks int32 [G, N, 2, d], c_hat and alpha_hat int64
// [G, N, d], observed int64 [G, d], norms and weights int32 [G, rank]: each
// read once, ~27 KB a group at N=4, d=256, ~6.3 MB at N=1024).  A warp
// takes a group: lane l reads coefficients l + 32e of every row (128-byte
// lines), lifts the centered vk values, keeps the target in a register and
// compares it; the verdicts are warp votes and warp max-reductions, one byte
// each written by lane 0.  No shared memory, no block barrier.
//
// A warp a group fills the card only when there are many groups (G=8192:
// ~16 warps on each of the card's 528 schedulers).  With few groups
// of many signers (G=32, N=1024: 32 warps would read 200 MB, ~6 % of the
// card) the wrapper splits each group's signers into S slices
// (ops/lattice_target.lattice_split): a first launch puts a warp on each
// (slice, group) and stores its partial target sums, reduced mod q, as
// uint32 [S, G, d]; a second puts a block on each group, a thread on each
// coefficient, adds its S partial sums mod q and checks them as above.
// Addition mod q is exact in any order, so both launches give the
// one-launch kernel's bits.
//
// Without nvcc the per-lane function compiles as plain C++;
// tests/test_torch_glue_kernels.py runs the 32 lanes of each group in turn.
#include "ntt_butterfly.cuh"  // WARP, add_mod, lift_residue

namespace {

constexpr int kLatticeWarps = 8;  // groups a block

FCT_HD uint64_t umulhi64(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// a * b mod q for residues a, b < q < 2^31, mu = floor(2^64 / q).
FCT_HD uint32_t mulmod_barrett(uint64_t a, uint64_t b, uint32_t q, uint64_t mu) {
  const uint64_t x = a * b;
  const uint64_t r = x - umulhi64(x, mu) * q;  // < 2q
  return (uint32_t)(r >= q ? r - q : r);
}

// One lane's share of a group's check: eq over coefficients lane + 32e, the
// largest norm and weight over rank rows lane + 32e (INT32_MIN if none).
struct LatticeLane {
  bool eq;
  int32_t nrm, wgt;
};

// Signer k's term of coefficient i of a group's target, mod q.
FCT_HD uint32_t target_term(const int32_t* vk_g, const int64_t* c_g, const int64_t* a_g, int k,
                            int d, uint32_t q, uint64_t mu, int i) {
  const uint32_t vl = lift_residue(vk_g[(int64_t)(2 * k) * d + i], q);
  const uint32_t vr = lift_residue(vk_g[(int64_t)(2 * k + 1) * d + i], q);
  const uint32_t t = add_mod(mulmod_barrett((uint64_t)c_g[(int64_t)k * d + i], vl, q, mu), vr, q);
  return mulmod_barrett((uint64_t)a_g[(int64_t)k * d + i], t, q, mu);
}

// The largest norm and weight over rank rows lane + 32e (INT32_MIN if none).
FCT_HD void limits_lane(LatticeLane& out, const int32_t* nrm_g, const int32_t* wgt_g, int rank,
                        int lane) {
  out.nrm = out.wgt = INT32_MIN;
  for (int r = lane; r < rank; r += WARP) {
    out.nrm = nrm_g[r] > out.nrm ? nrm_g[r] : out.nrm;
    out.wgt = wgt_g[r] > out.wgt ? wgt_g[r] : out.wgt;
  }
}

// The one-launch kernel's lane.  Its loop spells out target_term: written
// as calls of it, the kernel ran ~4 % slower at 8,192 groups of 4 on an
// H100 (same-call A/B against this code).
FCT_HD LatticeLane lattice_lane(const int32_t* vk_g, const int64_t* c_g, const int64_t* a_g,
                                const int64_t* obs_g, const int32_t* nrm_g,
                                const int32_t* wgt_g, int n, int d, int rank, uint32_t q,
                                uint64_t mu, int lane) {
  LatticeLane out;
  out.eq = true;
  for (int i = lane; i < d; i += WARP) {
    uint32_t acc = 0;
    for (int k = 0; k < n; ++k) {
      const uint32_t vl = lift_residue(vk_g[(int64_t)(2 * k) * d + i], q);
      const uint32_t vr = lift_residue(vk_g[(int64_t)(2 * k + 1) * d + i], q);
      const uint32_t t = add_mod(mulmod_barrett((uint64_t)c_g[(int64_t)k * d + i], vl, q, mu),
                                 vr, q);
      acc = add_mod(acc, mulmod_barrett((uint64_t)a_g[(int64_t)k * d + i], t, q, mu), q);
    }
    out.eq = out.eq && (int64_t)acc == obs_g[i];
  }
  limits_lane(out, nrm_g, wgt_g, rank, lane);
  return out;
}

// Signers [k0, k1) of slice s of S (the first n % S slices one more).
FCT_HD void slice_signers(int n, int slices, int s, int& k0, int& k1) {
  const int per = n / slices, more = n % slices;
  k0 = s * per + (s < more ? s : more);
  k1 = k0 + per + (s < more ? 1 : 0);
}

// The first launch of a split check, one lane: slice s's partial sums of
// coefficients lane + 32e of group g into partial[(s * groups + g) * d + i],
// kLatticeChains of them at once, signer by signer (their loads in flight
// together: a warp's rows are few, so each is read at the latency's pace
// unless several are).
constexpr int kLatticeChains = 8;  // all of a lane's coefficients at d = 256

FCT_HD void partial_lane(const int32_t* vk_g, const int64_t* c_g, const int64_t* a_g, int n,
                         int d, uint32_t q, uint64_t mu, int slices, int s, uint32_t* part_sg,
                         int lane) {
  int k0, k1;
  slice_signers(n, slices, s, k0, k1);
  for (int i0 = lane; i0 < d; i0 += WARP * kLatticeChains) {
    uint32_t acc[kLatticeChains];
    for (int e = 0; e < kLatticeChains; ++e) acc[e] = 0;
    for (int k = k0; k < k1; ++k) {
#pragma unroll
      for (int e = 0; e < kLatticeChains; ++e) {
        const int i = i0 + e * WARP;
        if (i < d) acc[e] = add_mod(acc[e], target_term(vk_g, c_g, a_g, k, d, q, mu, i), q);
      }
    }
    for (int e = 0; e < kLatticeChains; ++e)
      if (i0 + e * WARP < d) part_sg[i0 + e * WARP] = acc[e];
  }
}

// The second launch, coefficient i of group g: its S partial sums
// (part_g[s * slice_step + i]) added mod q.
FCT_HD uint32_t combine_coef(const uint32_t* part_g, int64_t slice_step, int slices, uint32_t q,
                             int i) {
  uint32_t acc = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 4
#endif
  for (int s = 0; s < slices; ++s) acc = add_mod(acc, part_g[s * slice_step + i], q);
  return acc;
}

#ifdef __CUDACC__
// Lane 0 of warp 0 writes a split check's three verdict bytes.
__device__ __forceinline__ void write_verdicts(const LatticeLane& p, int lane, int64_t g,
                                               int64_t beta, int64_t omega, uint8_t* eq,
                                               uint8_t* norm_ok, uint8_t* weight_ok) {
  const bool e = __all_sync(0xffffffffu, p.eq);
  const int32_t mn = __reduce_max_sync(0xffffffffu, p.nrm);
  const int32_t mw = __reduce_max_sync(0xffffffffu, p.wgt);
  if (lane == 0) {
    eq[g] = e;
    norm_ok[g] = (int64_t)mn <= beta;
    weight_ok[g] = (int64_t)mw <= omega;
  }
}

__global__ void __launch_bounds__(kLatticeWarps * WARP)
lattice_target_kernel(const int32_t* __restrict__ vks, const int64_t* __restrict__ c_hat,
                      const int64_t* __restrict__ alpha, const int64_t* __restrict__ observed,
                      const int32_t* __restrict__ nrm, const int32_t* __restrict__ wgt,
                      int64_t groups, int n, int d, int rank, uint32_t q, uint64_t mu,
                      int64_t beta, int64_t omega, uint8_t* __restrict__ eq,
                      uint8_t* __restrict__ norm_ok, uint8_t* __restrict__ weight_ok) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t g = (int64_t)blockIdx.x * kLatticeWarps + threadIdx.x / WARP;
  if (g >= groups) return;  // the whole warp
  const LatticeLane p = lattice_lane(vks + g * 2 * n * d, c_hat + g * n * d, alpha + g * n * d,
                                     observed + g * d, nrm + g * rank, wgt + g * rank, n, d, rank,
                                     q, mu, lane);
  const bool e = __all_sync(0xffffffffu, p.eq);
  const int32_t mn = __reduce_max_sync(0xffffffffu, p.nrm);
  const int32_t mw = __reduce_max_sync(0xffffffffu, p.wgt);
  if (lane == 0) {
    eq[g] = e;
    norm_ok[g] = (int64_t)mn <= beta;
    weight_ok[g] = (int64_t)mw <= omega;
  }
}

// Warp w of the grid takes slice w / groups of group w % groups, so the
// warps of one slice read neighbouring groups.
__global__ void __launch_bounds__(kLatticeWarps * WARP)
lattice_partial_kernel(const int32_t* __restrict__ vks, const int64_t* __restrict__ c_hat,
                       const int64_t* __restrict__ alpha, int64_t groups, int n, int d,
                       uint32_t q, uint64_t mu, int slices, uint32_t* __restrict__ partial) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t w = (int64_t)blockIdx.x * kLatticeWarps + threadIdx.x / WARP;
  if (w >= groups * slices) return;
  const int64_t g = w % groups;
  partial_lane(vks + g * 2 * n * d, c_hat + g * n * d, alpha + g * n * d, n, d, q, mu, slices,
               (int)(w / groups), partial + w * d, lane);
}

// A block a group, a thread a coefficient: the block votes on eq, warp 0
// checks the rows' norms and weights and writes the verdicts.
__global__ void __launch_bounds__(kLatticeWarps * WARP)
lattice_combine_kernel(const uint32_t* __restrict__ partial, int slices,
                       const int64_t* __restrict__ observed, const int32_t* __restrict__ nrm,
                       const int32_t* __restrict__ wgt, int64_t groups, int d, int rank,
                       uint32_t q, int64_t beta, int64_t omega, uint8_t* __restrict__ eq,
                       uint8_t* __restrict__ norm_ok, uint8_t* __restrict__ weight_ok) {
  const int64_t g = blockIdx.x;
  bool e = true;
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    e = e && (int64_t)combine_coef(partial + g * d, groups * d, slices, q, i) ==
                 observed[g * d + i];
  e = __syncthreads_and(e);
  if (threadIdx.x >= WARP) return;
  LatticeLane p;
  p.eq = e;
  limits_lane(p, nrm + g * rank, wgt + g * rank, rank, threadIdx.x);
  write_verdicts(p, threadIdx.x, g, beta, omega, eq, norm_ok, weight_ok);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): vks int32[groups, n, 2, d] (any int32,
// lifted to x mod q), c_hat and alpha int64[groups, n, d] and observed
// int64[groups, d] (residues in [0, q)), nrm and wgt int32[groups, rank];
// q an odd prime below 2^31, mu = floor(2^64 / q); outputs eq, norm_ok,
// weight_ok as bytes [groups] (norm <= beta, weight <= omega).  With
// slices > 1 (at most n) the check is split over two launches and
// ``partial`` is uint32 [slices, groups, d] of scratch; with 1 it is not
// read.  Returns a cudaError_t.
extern "C" int fct_lattice_target(const int32_t* vks, const int64_t* c_hat,
                                  const int64_t* alpha, const int64_t* observed,
                                  const int32_t* nrm, const int32_t* wgt, int64_t groups, int n,
                                  int d, int rank, uint32_t q, uint64_t mu, int64_t beta,
                                  int64_t omega, uint8_t* eq, uint8_t* norm_ok,
                                  uint8_t* weight_ok, int slices, uint32_t* partial,
                                  void* stream) {
  if (groups <= 0) return 0;
  const unsigned blocks = (unsigned)((groups + kLatticeWarps - 1) / kLatticeWarps);
  if (slices <= 1) {
    lattice_target_kernel<<<blocks, kLatticeWarps * WARP, 0, (cudaStream_t)stream>>>(
        vks, c_hat, alpha, observed, nrm, wgt, groups, n, d, rank, q, mu, beta, omega, eq,
        norm_ok, weight_ok);
    return (int)cudaGetLastError();
  }
  const int64_t warps = groups * slices;
  lattice_partial_kernel<<<(unsigned)((warps + kLatticeWarps - 1) / kLatticeWarps),
                           kLatticeWarps * WARP, 0, (cudaStream_t)stream>>>(
      vks, c_hat, alpha, groups, n, d, q, mu, slices, partial);
  lattice_combine_kernel<<<(unsigned)groups, kLatticeWarps * WARP, 0, (cudaStream_t)stream>>>(
      partial, slices, observed, nrm, wgt, groups, d, rank, q, beta, omega, eq, norm_ok,
      weight_ok);
  return (int)cudaGetLastError();
}
#endif
