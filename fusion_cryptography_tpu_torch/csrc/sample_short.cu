// The one-time keys' short secret coefficients, drawn on NVIDIA Hopper
// (sm_90a) with CPython's Mersenne Twister.
//
// Key b's left polynomial comes from random.seed(s), its right one from
// random.seed(s + 1), s = seeds[b] (fusion.py:339-362), each drawn as
// sample_polynomial_coefficient_representation draws it
// (algebra/polynomials.py:436-467): num = min(degree, weight_bound)
// coefficients (1 + randrange(bound)) * (1 - 2 * randrange(2)), bound =
// min(norm_bound, modulus // 2), zeros to the degree, then a Fisher-Yates
// pass of randrange(i + 1) for i = degree - 1 .. 1 when num < degree.  The
// output equals native/fusion_native.c's fn_sample_short_batch (the host
// sampler, this kernel's plain version) word for word: CPython's seeding
// (init_by_array on the little-endian 32-bit words of the seed, [0] for 0),
// getrandbits(k) as the top k bits of one tempered word (k <= 31 here), and
// _randbelow's rejection loop.
//
// It replaces no TPU kernel: the JAX package samples on the host
// (native/fusion_native.c fn_sample_short_batch).
//
// What bounds it: one stream's chain of dependent steps, not bytes or
// operations.  Every stream is independent, so a thread runs one (2B
// streams for B keys).  A stream's seeding is init_by_array's 1,247 serial
// steps (5 dependent integer instructions each: a shift, two XORs, a
// multiply and an add); its draws are one twisted and tempered word each,
// ~3.2 words a coefficient (randrange(52) rejects 12 of 64, randrange(2)
// draws 2 bits and rejects half).  At d = 64 that is ~1,500 steps, whatever
// the batch while it fits in one wave: 0.058 ms on an H100 for 2,048 streams
// (~48 cycles a seeding step, ~215 a word drawn), against ~0.016 ms for the
// seeding's chain alone at ~25 cycles a step.  What the design does about it:
//   - init_genrand(19650218), the first 624 words of every seeding, is the
//     same for every seed: the host computes it once a device
//     (ops/sample_short.py) and every lane of a warp reads the same word of
//     it at the same step (one broadcast load, off the chain).
//   - The twist runs a word at a time, as the stream draws: word i of a
//     generation becomes mt[(i + 397) % 624] ^ twist(mt[i], mt[i + 1]) in
//     place, which reads exactly the words the whole-state twist reads (the
//     ones past i still old, the ones before it new).  A stream twists only
//     the words it draws: ~210 at d = 64, ~830 at d = 256.  The next word's
//     two loads are issued one word ahead.
//   - Magnitudes, signs and the shuffle are one loop over words with the
//     phase in a register, so a warp's lanes advance a word each iteration
//     whatever each one rejects: the warp runs for the most words any lane
//     draws, not for the sum of each coefficient's slowest lane.
//   - The 624 state words of a stream live in shared memory, word i of lane
//     t at i * 32 + t: a block is one warp (78 KiB), every access of a lane
//     hits its own bank whatever word it reads, and two blocks fit an SM.
//     The sign cell's 2,048 streams are 64 blocks, one wave.
//
// Without nvcc, FCT_HD is `static inline` and the per-stream functions
// compile as plain C++ (tests/test_torch_sample_short.py runs them in a
// serial loop against CPython's random).
#include "fct_hd.cuh"

namespace {

constexpr int kMtN = 624;            // MT19937's state words
constexpr int kMtM = 397;            // the twist's middle distance
constexpr int kSampleThreads = 32;   // streams (threads) a block: one warp
constexpr uint32_t kMtUpper = 0x80000000u;

FCT_HD int bit_length32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return 32 - __clz(x);
#else
  return x ? 32 - __builtin_clz(x) : 0;
#endif
}

FCT_HD uint32_t load_init(const uint32_t* init, int i) {
#ifdef __CUDA_ARCH__
  return __ldg(init + i);
#else
  return init[i];
#endif
}

// CPython's random.seed(seed) for 0 <= seed < 2^64: init_by_array over the
// key [seed mod 2^32] (and [.., seed >> 32] when that is not 0), starting
// from init = init_genrand(19650218).  The stream's word i goes to mt[i * S].
template <int S>
FCT_HD void mt_seed(uint32_t* mt, const uint32_t* init, uint64_t seed) {
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  // key[j] + j for even and odd steps: the key has one word or two
  const uint32_t add0 = k0, add1 = k1 ? k1 + 1u : k0;
  // the first pass, 624 steps: i = 1 .. 623, then mt[0] = mt[623] and i = 1
  uint32_t prev = load_init(init, 0);
  uint32_t first = 0;
#pragma unroll 8
  for (int i = 1; i < kMtN; ++i) {
    prev = (load_init(init, i) ^ ((prev ^ (prev >> 30)) * 1664525u)) + ((i & 1) ? add0 : add1);
    mt[i * S] = prev;
    if (i == 1) first = prev;
  }
  prev = (first ^ ((prev ^ (prev >> 30)) * 1664525u)) + add1;  // step 624 (odd j)
  mt[S] = prev;
  // the second pass, 623 steps: i = 2 .. 623, then mt[0] = mt[623] and i = 1
#pragma unroll 8
  for (int i = 2; i < kMtN; ++i) {
    prev = (mt[i * S] ^ ((prev ^ (prev >> 30)) * 1566083941u)) - (uint32_t)i;
    mt[i * S] = prev;
  }
  mt[S] = (mt[S] ^ ((prev ^ (prev >> 30)) * 1566083941u)) - 1u;
  mt[0] = kMtUpper;
}

// A stream's position: word i of the current generation is next, and a, b,
// c are the words its twist reads: mt[i] and mt[i + 1] (old, but mt[0] for
// i = 623, already twisted) and mt[(i + 397) % 624] (old below i = 227, new
// from it on).
struct MtWords {
  int i;
  uint32_t a, b, c;
};

template <int S>
FCT_HD MtWords mt_words(const uint32_t* mt) {
  return {0, mt[0], mt[S], mt[kMtM * S]};
}

// The stream's next tempered word (genrand_uint32).
template <int S>
FCT_HD uint32_t mt_next(uint32_t* mt, MtWords& w) {
  const uint32_t y = (w.a & kMtUpper) | (w.b & 0x7fffffffu);
  uint32_t v = w.c ^ (y >> 1) ^ ((0u - (y & 1u)) & 0x9908b0dfu);
  mt[w.i * S] = v;
  w.i = w.i == kMtN - 1 ? 0 : w.i + 1;
  w.a = w.b;
  w.b = mt[(w.i == kMtN - 1 ? 0 : w.i + 1) * S];
  w.c = mt[(w.i < kMtN - kMtM ? w.i + kMtM : w.i + kMtM - kMtN) * S];
  v ^= v >> 11;
  v ^= (v << 7) & 0x9d2c5680u;
  v ^= (v << 15) & 0xefc60000u;
  v ^= v >> 18;
  return v;
}

// One short polynomial from random.seed(seed) into out[0 .. degree): num
// coefficients of magnitude 1 + randrange(bound) (bound >= 1 when num > 0)
// and sign 1 - 2 * randrange(2), zeros, and the Fisher-Yates pass when
// num < degree.  Each randrange(n) is _randbelow: the top bit_length(n)
// bits of a word until they are below n.
template <int S>
FCT_HD void sample_stream(uint32_t* mt, const uint32_t* init, uint64_t seed, int degree, int num,
                          uint32_t bound, int32_t* out) {
  for (int k = num; k < degree; ++k) out[k] = 0;
  if (num == 0) return;  // a shuffle of zeros leaves zeros
  mt_seed<S>(mt, init, seed);
  MtWords w = mt_words<S>(mt);
  const int mag_shift = 32 - bit_length32(bound);
  int i = 0, sign_phase = 0;
  int32_t mag = 0;
  while (i < num) {  // phase 0: the magnitude's randrange(bound); 1: the sign's randrange(2)
    const uint32_t r = mt_next<S>(mt, w) >> (sign_phase ? 30 : mag_shift);
    if (r < (sign_phase ? 2u : bound)) {
      if (sign_phase) out[i++] = r ? -mag : mag;
      else mag = (int32_t)r + 1;
      sign_phase ^= 1;
    }
  }
  if (num < degree) {
    for (int n = degree; n > 1;) {  // randrange(n) for i = n - 1 = degree - 1 .. 1
      const uint32_t r = mt_next<S>(mt, w) >> (32 - bit_length32((uint32_t)n));
      if (r < (uint32_t)n) {
        const int32_t t = out[n - 1];
        out[n - 1] = out[r];
        out[r] = t;
        --n;
      }
    }
  }
}

// fn_sample_short_batch's num and bound.
struct SampleLimits {
  int num;
  uint32_t bound;
};

inline SampleLimits sample_limits(int degree, int norm_bound, int weight_bound, int64_t modulus) {
  int num = weight_bound < degree ? weight_bound : degree;
  if (num < 0) num = 0;
  const int64_t half = modulus / 2;
  int64_t bound = norm_bound < half ? norm_bound : half;
  if (bound < 0) bound = 0;
  return {num, (uint32_t)bound};
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kSampleThreads)
sample_short_kernel(const uint64_t* __restrict__ seeds, int64_t streams,
                    const uint32_t* __restrict__ init, int degree, int num, uint32_t bound,
                    int32_t* __restrict__ out) {
  extern __shared__ uint32_t state[];  // [624][32]: word i of lane t at i * 32 + t
  const int64_t t = (int64_t)blockIdx.x * kSampleThreads + threadIdx.x;
  if (t >= streams) return;
  const uint64_t seed = seeds[t >> 1] + (uint64_t)(t & 1);  // key t/2's seed, or the next
  sample_stream<kSampleThreads>(state + threadIdx.x, init, seed, degree, num, bound,
                                out + t * degree);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): seeds uint64[keys] with s + 1 < 2^64,
// init uint32[624] = init_genrand(19650218); out int32[keys, 2, degree]:
// row 0 of key b from seed seeds[b], row 1 from seeds[b] + 1.  degree >= 0;
// num and bound as fn_sample_short_batch derives them, with bound >= 1 when
// num > 0.  Returns a cudaError_t.
extern "C" int fct_sample_short(const uint64_t* seeds, int64_t keys, const uint32_t* init,
                                int degree, int norm_bound, int weight_bound, int64_t modulus,
                                int32_t* out, void* stream) {
  if (keys <= 0 || degree <= 0) return 0;
  const SampleLimits lim = sample_limits(degree, norm_bound, weight_bound, modulus);
  const size_t smem = (size_t)kMtN * kSampleThreads * sizeof(uint32_t);
  const cudaError_t rc = cudaFuncSetAttribute(
      sample_short_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  const int64_t streams = 2 * keys;
  const unsigned blocks = (unsigned)((streams + kSampleThreads - 1) / kSampleThreads);
  sample_short_kernel<<<blocks, kSampleThreads, smem, (cudaStream_t)stream>>>(
      seeds, streams, init, degree, lim.num, lim.bound, out);
  return (int)cudaGetLastError();
}
#endif
