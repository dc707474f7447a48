// Batched SHAKE256 / SHA3-256 sponge for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of fusion_cryptography_tpu/ops/keccak_pallas.py:
//   keccak_absorb  <- _build_absorb  (kernel 1: masked multi-block absorb)
//   keccak_squeeze <- _build_squeeze (kernel 2: squeeze with a permutation
//                                     between rate blocks)
//
// Layout (the JAX package's, batch minor): payload words u32[max_blocks*34, B],
// per-lane block counts i32[B], state u32[50, B] (word 2l = low half of lane
// l), XOF words u32[n_words, B].  Bytes are little-endian in each word.
//
// Design.  keccak_absorb puts one or two threads on a sponge, in blocks of
// 128 threads, as the wrapper chooses from the batch
// (ops/keccak_sponge.absorb_team):
//  - one thread (the 64-bit form): the 25 lanes live as uint64_t in
//    registers, and the thread loops over its own block count nblk[b] in
//    place of the TPU's masked sequential grid axis;
//  - two threads (the bit-interleaved form, below): each holds one half of
//    every lane's bits, and a round exchanges 17 words with the partner
//    (__shfl_xor_sync).  A warp then holds 16 sponges and runs the warp's
//    largest count, so every shuffle is a full-warp one.
// Both load block j + 1 before permuting block j.  Threads index the batch
// axis, so a warp's loads and stores are contiguous segments.  Any B is
// accepted; counts are clamped to [0, max_blocks].  keccak_squeeze keeps
// one thread per sponge.
//
// What bounds it: integer issue.  A permutation needs ~4,320 32-bit
// instructions (bounds.KECCAK_OPS) and reads 136 bytes, far from the
// memory roofline.  A warp's time is its longest sponge's chain of
// permutations, and a scheduler issues one warp's logic op every two
// cycles, so the card needs a warp on each of its 528 schedulers (132 SMs
// x 4).  At G=8192, N=4 a verify call absorbs in three launches: the
// prehash (32,768 sponges of 1 block), the challenge (32,768 sponges of
// <=54 blocks, ~1.6 M permutations) and the aggregation (8,192 sponges of
// <=315 blocks, ~2.3 M permutations).  The first two are 1,024 warps at
// one thread a sponge, about two a scheduler.  The aggregation is 256
// warps at one thread a sponge, half the schedulers idle; at two threads a
// sponge it is 512.  A pair's round costs each thread about 95 logic ops
// and funnel shifts (the 64-bit form's count per sponge, split in two), 12
// adds for its role's rotation amounts and 17 shuffles, and each absorbed
// block 17 more shuffles and ~15 ops a word to interleave it.  So two
// threads a sponge fill the card where one cannot, and one thread a sponge
// is cheaper where both can.  The sponges of a launch differ by a few
// blocks at most, so lanes idle in a warp only briefly and are not
// regrouped by count.
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FCT_HD __device__ __forceinline__
#else
#define FCT_HD static inline
#endif

namespace {

#ifdef __CUDACC__
__constant__ uint64_t kKeccakRC[24] = {
#else
const uint64_t kKeccakRC[24] = {
#endif
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

FCT_HD uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> ((64 - r) & 63));
}

// Keccak-f[1600] on 25 lanes (flat index x + 5y).  Every index is a
// compile-time constant, so the state stays in registers.
FCT_HD void keccak_f1600(uint64_t s[25]) {
  for (int round = 0; round < 24; ++round) {
    const uint64_t c0 = s[0] ^ s[5] ^ s[10] ^ s[15] ^ s[20];
    const uint64_t c1 = s[1] ^ s[6] ^ s[11] ^ s[16] ^ s[21];
    const uint64_t c2 = s[2] ^ s[7] ^ s[12] ^ s[17] ^ s[22];
    const uint64_t c3 = s[3] ^ s[8] ^ s[13] ^ s[18] ^ s[23];
    const uint64_t c4 = s[4] ^ s[9] ^ s[14] ^ s[19] ^ s[24];
    const uint64_t d0 = c4 ^ rotl64(c1, 1);
    const uint64_t d1 = c0 ^ rotl64(c2, 1);
    const uint64_t d2 = c1 ^ rotl64(c3, 1);
    const uint64_t d3 = c2 ^ rotl64(c4, 1);
    const uint64_t d4 = c3 ^ rotl64(c0, 1);
    s[0] ^= d0; s[5] ^= d0; s[10] ^= d0; s[15] ^= d0; s[20] ^= d0;
    s[1] ^= d1; s[6] ^= d1; s[11] ^= d1; s[16] ^= d1; s[21] ^= d1;
    s[2] ^= d2; s[7] ^= d2; s[12] ^= d2; s[17] ^= d2; s[22] ^= d2;
    s[3] ^= d3; s[8] ^= d3; s[13] ^= d3; s[18] ^= d3; s[23] ^= d3;
    s[4] ^= d4; s[9] ^= d4; s[14] ^= d4; s[19] ^= d4; s[24] ^= d4;
    uint64_t b[25];
    b[0] = rotl64(s[0], 0);
    b[1] = rotl64(s[6], 44);
    b[2] = rotl64(s[12], 43);
    b[3] = rotl64(s[18], 21);
    b[4] = rotl64(s[24], 14);
    b[5] = rotl64(s[3], 28);
    b[6] = rotl64(s[9], 20);
    b[7] = rotl64(s[10], 3);
    b[8] = rotl64(s[16], 45);
    b[9] = rotl64(s[22], 61);
    b[10] = rotl64(s[1], 1);
    b[11] = rotl64(s[7], 6);
    b[12] = rotl64(s[13], 25);
    b[13] = rotl64(s[19], 8);
    b[14] = rotl64(s[20], 18);
    b[15] = rotl64(s[4], 27);
    b[16] = rotl64(s[5], 36);
    b[17] = rotl64(s[11], 10);
    b[18] = rotl64(s[17], 15);
    b[19] = rotl64(s[23], 56);
    b[20] = rotl64(s[2], 62);
    b[21] = rotl64(s[8], 55);
    b[22] = rotl64(s[14], 39);
    b[23] = rotl64(s[15], 41);
    b[24] = rotl64(s[21], 2);
    s[0] = b[0] ^ (~b[1] & b[2]);
    s[1] = b[1] ^ (~b[2] & b[3]);
    s[2] = b[2] ^ (~b[3] & b[4]);
    s[3] = b[3] ^ (~b[4] & b[0]);
    s[4] = b[4] ^ (~b[0] & b[1]);
    s[5] = b[5] ^ (~b[6] & b[7]);
    s[6] = b[6] ^ (~b[7] & b[8]);
    s[7] = b[7] ^ (~b[8] & b[9]);
    s[8] = b[8] ^ (~b[9] & b[5]);
    s[9] = b[9] ^ (~b[5] & b[6]);
    s[10] = b[10] ^ (~b[11] & b[12]);
    s[11] = b[11] ^ (~b[12] & b[13]);
    s[12] = b[12] ^ (~b[13] & b[14]);
    s[13] = b[13] ^ (~b[14] & b[10]);
    s[14] = b[14] ^ (~b[10] & b[11]);
    s[15] = b[15] ^ (~b[16] & b[17]);
    s[16] = b[16] ^ (~b[17] & b[18]);
    s[17] = b[17] ^ (~b[18] & b[19]);
    s[18] = b[18] ^ (~b[19] & b[15]);
    s[19] = b[19] ^ (~b[15] & b[16]);
    s[20] = b[20] ^ (~b[21] & b[22]);
    s[21] = b[21] ^ (~b[22] & b[23]);
    s[22] = b[22] ^ (~b[23] & b[24]);
    s[23] = b[23] ^ (~b[24] & b[20]);
    s[24] = b[24] ^ (~b[20] & b[21]);
    s[0] ^= kKeccakRC[round];
  }
}

// Absorb lane b with one thread: XOR its first nblk[b] rate blocks into a
// zero state, one permutation per block; blocks j >= nblk[b] leave the
// state unchanged.  Block j + 1's 34 words are loaded before block j is
// permuted, so the loads are in flight during the permutation.
FCT_HD void sponge_absorb_lane(const uint32_t* words, const int32_t* nblk,
                               uint32_t* state, int max_blocks, int64_t batch,
                               int64_t b) {
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = 0;
  int n = nblk[b];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
  const int64_t block_stride = 34 * batch;
  uint32_t buf[34];
  if (n > 0) {
#pragma unroll
    for (int w = 0; w < 34; ++w) buf[w] = words[(int64_t)w * batch + b];
  }
  for (int j = 0; j < n; ++j) {
#pragma unroll
    for (int l = 0; l < 17; ++l) s[l] ^= (uint64_t)buf[2 * l] | ((uint64_t)buf[2 * l + 1] << 32);
    if (j + 1 < n) {
      const uint32_t* blk = words + (j + 1) * block_stride + b;
#pragma unroll
      for (int w = 0; w < 34; ++w) buf[w] = blk[(int64_t)w * batch];
    }
    keccak_f1600(s);
  }
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    state[(int64_t)(2 * l) * batch + b] = (uint32_t)s[l];
    state[(int64_t)(2 * l + 1) * batch + b] = (uint32_t)(s[l] >> 32);
  }
}

// ---------------------------------------------------------------------------
// Two threads per sponge: Keccak in its bit-interleaved form.  The thread of
// role e = 1 holds the even bits of all 25 lanes (bit i of its word is bit
// 2i of the lane), its partner (e = 0) the odd bits.  A 64-bit rotation by
// 2m is a 32-bit rotation by m of each word; by 2m + 1 the words swap: the
// even word becomes the odd word rotated by m + 1, the odd word the even
// word rotated by m.  So a round needs the partner's five column parities
// (theta's rotation by 1) and its words of the twelve lanes whose rho
// offset is odd; every other step works on the thread's own words with the
// same logic ops as the 64-bit form.  The functions below are one thread's
// part between two exchanges; the kernel exchanges with __shfl_xor_sync,
// the host test by copying the partner's words.
// ---------------------------------------------------------------------------

// Round constants split into their even and odd bits, [e][round] (e = 1:
// the even bits).
#ifdef __CUDACC__
__constant__ uint32_t kKeccakRCil[2][24] = {
#else
const uint32_t kKeccakRCil[2][24] = {
#endif
    {0x00000000u, 0x00000089u, 0x8000008bu, 0x80008080u, 0x0000008bu, 0x00008000u,
     0x80008088u, 0x80000082u, 0x0000000bu, 0x0000000au, 0x00008082u, 0x00008003u,
     0x0000808bu, 0x8000000bu, 0x8000008au, 0x80000081u, 0x80000081u, 0x80000008u,
     0x00000083u, 0x80008003u, 0x80008088u, 0x80000088u, 0x00008000u, 0x80008082u},
    {0x00000001u, 0x00000000u, 0x00000000u, 0x00000000u, 0x00000001u, 0x00000001u,
     0x00000001u, 0x00000001u, 0x00000000u, 0x00000000u, 0x00000001u, 0x00000000u,
     0x00000001u, 0x00000001u, 0x00000001u, 0x00000001u, 0x00000000u, 0x00000000u,
     0x00000000u, 0x00000000u, 0x00000001u, 0x00000000u, 0x00000001u, 0x00000000u}};

// The lanes (source index) whose rho offset is odd: their words cross to
// the partner before rho.
#define FCT_ODD_RHO_LANES(X) \
  X(1) X(4) X(8) X(10) X(12) X(13) X(14) X(15) X(16) X(17) X(18) X(22)

FCT_HD uint32_t rotl32(uint32_t x, uint32_t r) {
#ifdef __CUDACC__
  return __funnelshift_l(x, x, r);
#else
  r &= 31;
  return (x << r) | (x >> ((32 - r) & 31));
#endif
}

// PRMT: byte k of the result is byte (s >> 4k) & 7 of the pair (b:a).
FCT_HD uint32_t byte_perm(uint32_t a, uint32_t b, uint32_t s) {
#ifdef __CUDACC__
  return __byte_perm(a, b, s);
#else
  const uint64_t v = ((uint64_t)b << 32) | a;
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= (uint32_t)((v >> (8 * ((s >> (4 * k)) & 7))) & 0xFF) << (8 * k);
  return r;
#endif
}

// Bits 0, 2, .., 30 of x to bits 0..15 and bits 1, 3, .., 31 to bits 16..31
// (three delta swaps and a byte swap); zip32 is its inverse.
FCT_HD uint32_t unzip32(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  return byte_perm(x, 0, 0x3120);
}

FCT_HD uint32_t zip32(uint32_t x) {
  uint32_t t;
  x = byte_perm(x, 0, 0x3120);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  return x;
}

// The pair's 16-bit halves: role 1 keeps its own low half and takes the
// partner's low half on top; role 0 takes the partner's high half below its
// own high half.  With unzipped message words (role 1 holds the low word,
// role 0 the high word) this gives each role its interleaved word; with
// interleaved state words, fed to zip32, the low (role 1) or high (role 0)
// message word.
FCT_HD uint32_t pair_sel(uint32_t e) { return e ? 0x5410u : 0x3276u; }

FCT_HD void il_parity(const uint32_t s[25], uint32_t c[5]) {
#pragma unroll
  for (int x = 0; x < 5; ++x) c[x] = s[x] ^ s[x + 5] ^ s[x + 10] ^ s[x + 15] ^ s[x + 20];
}

// theta: D[x] = C[x-1] ^ rot64(C[x+1], 1), whose even word is the odd
// parity rotated by 1 and whose odd word is the even parity.
FCT_HD void il_theta(uint32_t s[25], const uint32_t c[5], const uint32_t cp[5], uint32_t e) {
#pragma unroll
  for (int x = 0; x < 5; ++x) {
    const uint32_t d = c[(x + 4) % 5] ^ rotl32(cp[(x + 1) % 5], e);
#pragma unroll
    for (int y = 0; y < 25; y += 5) s[x + y] ^= d;
  }
}

// rho, pi, chi and iota; p holds the partner's words of the odd-offset lanes.
FCT_HD void il_rho_pi_chi_iota(uint32_t s[25], const uint32_t p[25], uint32_t e, int round) {
  uint32_t b[25];
  b[0] = s[0];
  b[1] = rotl32(s[6], 22);
  b[2] = rotl32(p[12], 21 + e);
  b[3] = rotl32(p[18], 10 + e);
  b[4] = rotl32(s[24], 7);
  b[5] = rotl32(s[3], 14);
  b[6] = rotl32(s[9], 10);
  b[7] = rotl32(p[10], 1 + e);
  b[8] = rotl32(p[16], 22 + e);
  b[9] = rotl32(p[22], 30 + e);
  b[10] = rotl32(p[1], e);
  b[11] = rotl32(s[7], 3);
  b[12] = rotl32(p[13], 12 + e);
  b[13] = rotl32(s[19], 4);
  b[14] = rotl32(s[20], 9);
  b[15] = rotl32(p[4], 13 + e);
  b[16] = rotl32(s[5], 18);
  b[17] = rotl32(s[11], 5);
  b[18] = rotl32(p[17], 7 + e);
  b[19] = rotl32(s[23], 28);
  b[20] = rotl32(s[2], 31);
  b[21] = rotl32(p[8], 27 + e);
  b[22] = rotl32(p[14], 19 + e);
  b[23] = rotl32(p[15], 20 + e);
  b[24] = rotl32(s[21], 1);
#pragma unroll
  for (int y = 0; y < 25; y += 5) {
#pragma unroll
    for (int x = 0; x < 5; ++x)
      s[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
  }
  s[0] ^= kKeccakRCil[e][round];
}

// Squeeze lane b: n_words output words, the rate half of the state per
// 34-word block, permuting before every block after the first.
FCT_HD void sponge_squeeze_lane(const uint32_t* state, uint32_t* out,
                                int n_words, int64_t batch, int64_t b) {
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    s[l] = (uint64_t)state[(int64_t)(2 * l) * batch + b] |
           ((uint64_t)state[(int64_t)(2 * l + 1) * batch + b] << 32);
  }
  const int n_blocks = (n_words + 33) / 34;
  for (int k = 0; k < n_blocks; ++k) {
    if (k) keccak_f1600(s);
    const int base = 34 * k;
#pragma unroll
    for (int l = 0; l < 17; ++l) {
      const int w = base + 2 * l;
      if (w < n_words) out[(int64_t)w * batch + b] = (uint32_t)s[l];
      if (w + 1 < n_words) out[(int64_t)(w + 1) * batch + b] = (uint32_t)(s[l] >> 32);
    }
  }
}

#ifdef __CUDACC__
constexpr int kSqueezeThreads = 128;
constexpr int kAbsorbThreads = 128;

constexpr unsigned kFullWarp = 0xffffffffu;

// Keccak-f[1600] of a pair of threads, every thread of the warp taking
// part.  A round exchanges 17 words with the partner: 5 column parities and
// 12 rho words.  Six rounds to a loop body give a warp that is alone on
// its scheduler more independent work between the exchanges.
__device__ __forceinline__ void keccak_f1600_pair(uint32_t s[25], uint32_t e) {
#pragma unroll 6
  for (int round = 0; round < 24; ++round) {
    uint32_t c[5], cp[5], p[25];
    il_parity(s, c);
#pragma unroll
    for (int x = 0; x < 5; ++x) cp[x] = __shfl_xor_sync(kFullWarp, c[x], 1);
    il_theta(s, c, cp, e);
#define FCT_XCHG(l) p[l] = __shfl_xor_sync(kFullWarp, s[l], 1);
    FCT_ODD_RHO_LANES(FCT_XCHG)
#undef FCT_XCHG
    il_rho_pi_chi_iota(s, p, e, round);
  }
}

// Absorb lane b with the pair of threads of role e: role 1 loads the low
// word of each rate lane, role 0 the high word; each unzips its word and
// takes the partner's half (one exchange a word) to form its interleaved
// word.  Block j + 1 is loaded before block j is permuted.  Every thread of
// the warp runs the warp's largest block count, so each exchange is a
// full-warp shuffle: a pair past its own count (or past the batch, ``live``
// false) XORs nothing in, and its state is kept from its last block.  At
// the end each role zips one word of each lane back: role 1 the low words,
// role 0 the high words.
__device__ __forceinline__ void sponge_absorb_pair(const uint32_t* __restrict__ words,
                                                   const int32_t* __restrict__ nblk,
                                                   uint32_t* __restrict__ state,
                                                   int max_blocks, int64_t batch,
                                                   int64_t b, bool live, uint32_t e) {
  int n = live ? nblk[b] : 0;
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
  const int n_warp = __reduce_max_sync(kFullWarp, n);
  uint32_t s[25], fin[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = fin[l] = 0;
  const uint32_t sel = pair_sel(e);
  const int64_t high = 1 - (int64_t)e;  // the row of the lane's word this role holds
  const uint32_t* src = words + high * batch + b;
  const int64_t lane_stride = 2 * batch, block_stride = 34 * batch;
  uint32_t buf[17];
  if (n_warp > 0) {
#pragma unroll
    for (int l = 0; l < 17; ++l) buf[l] = src[l * lane_stride];
  }
  for (int j = 0; j < n_warp; ++j) {
    const uint32_t keep = j < n ? ~0u : 0u;
#pragma unroll
    for (int l = 0; l < 17; ++l) {
      const uint32_t u = unzip32(buf[l]);
      s[l] ^= byte_perm(u, __shfl_xor_sync(kFullWarp, u, 1), sel) & keep;
    }
    if (j + 1 < n_warp) {
      const uint32_t* blk = src + (j + 1) * block_stride;
#pragma unroll
      for (int l = 0; l < 17; ++l) buf[l] = blk[l * lane_stride];
    }
    keccak_f1600_pair(s, e);
    if (j + 1 == n) {
#pragma unroll
      for (int l = 0; l < 25; ++l) fin[l] = s[l];
    }
  }
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    const uint32_t v = zip32(byte_perm(fin[l], __shfl_xor_sync(kFullWarp, fin[l], 1), sel));
    if (live) state[(2 * l + high) * batch + b] = v;
  }
}

// TEAM threads per sponge: 1 (the 64-bit form) or 2 (the interleaved form,
// threads 2k and 2k + 1 of the block on sponge k).  Any batch: with two
// threads a sponge, the threads past the batch run with their warp (on the
// last sponge's addresses) and store nothing.
template <int TEAM>
__global__ void __launch_bounds__(kAbsorbThreads)
keccak_absorb_kernel(const uint32_t* __restrict__ words,
                     const int32_t* __restrict__ nblk,
                     uint32_t* __restrict__ state, int max_blocks,
                     int64_t batch) {
  const int64_t t = (int64_t)blockIdx.x * kAbsorbThreads + threadIdx.x;
  if (TEAM == 1) {
    if (t < batch) sponge_absorb_lane(words, nblk, state, max_blocks, batch, t);
  } else {
    const int64_t b = t >> 1;
    const bool live = b < batch;
    sponge_absorb_pair(words, nblk, state, max_blocks, batch, live ? b : batch - 1, live,
                       ~(uint32_t)t & 1u);
  }
}

__global__ void __launch_bounds__(kSqueezeThreads)
keccak_squeeze_kernel(const uint32_t* __restrict__ state,
                      uint32_t* __restrict__ out, int n_words, int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * kSqueezeThreads + threadIdx.x;
  if (b < batch) sponge_squeeze_lane(state, out, n_words, batch, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns cudaGetLastError() so a refused launch is reported to the caller.
// ``team`` (1 or 2 threads per sponge) is chosen by the wrapper from the
// batch; a block is always kAbsorbThreads threads.
extern "C" int fct_keccak_absorb(const uint32_t* words, const int32_t* nblk,
                                 uint32_t* state, int max_blocks,
                                 int64_t batch, int team, void* stream) {
  if (batch <= 0) return 0;
  if (team != 1 && team != 2) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((batch * team + kAbsorbThreads - 1) / kAbsorbThreads);
  if (team == 1)
    keccak_absorb_kernel<1><<<grid, kAbsorbThreads, 0, (cudaStream_t)stream>>>(
        words, nblk, state, max_blocks, batch);
  else
    keccak_absorb_kernel<2><<<grid, kAbsorbThreads, 0, (cudaStream_t)stream>>>(
        words, nblk, state, max_blocks, batch);
  return (int)cudaGetLastError();
}

extern "C" int fct_keccak_squeeze(const uint32_t* state, uint32_t* out,
                                  int n_words, int64_t batch, void* stream) {
  if (batch <= 0 || n_words <= 0) return 0;
  const unsigned grid = (unsigned)((batch + kSqueezeThreads - 1) / kSqueezeThreads);
  keccak_squeeze_kernel<<<grid, kSqueezeThreads, 0, (cudaStream_t)stream>>>(
      state, out, n_words, batch);
  return (int)cudaGetLastError();
}
#endif
