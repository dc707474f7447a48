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
// Design.  One sponge per thread: the 25 lanes live as uint64_t in registers
// (a GPU has native 64-bit logic and funnel shifts, so the TPU's (lo, hi)
// 32-bit halves are gone), and each thread loops over its own block count
// nblk[b] in place of the TPU's masked sequential grid axis.  Threads index
// the batch axis, so every word load and store of a warp is one contiguous
// 128-byte segment.  Any B is accepted (the edge is masked); the TPU's
// 1024-lane tiling rule does not apply.
//
// What bounds it: integer ALU issue and registers.  A permutation is ~2,400
// 64-bit logic ops and reads 136 bytes per absorbed block, so it is far
// from the memory roofline.  At G=8192, N=4 a verify runs ~7 M
// permutations: 32,768 challenge sponges of <=116 blocks, and 8,192
// aggregation sponges of <=432 blocks.  The aggregation sponge has only one
// thread per group, so its long serial chains leave most SMs idle (low
// occupancy); splitting one sponge's work or batching more groups per
// launch is left to a later change.
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

// Absorb lane b: XOR its first nblk[b] rate blocks into a zero state, one
// permutation per block; blocks j >= nblk[b] leave the state unchanged.
FCT_HD void sponge_absorb_lane(const uint32_t* words, const int32_t* nblk,
                               uint32_t* state, int max_blocks, int64_t batch,
                               int64_t b) {
  uint64_t s[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) s[l] = 0;
  int n = nblk[b];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
  for (int j = 0; j < n; ++j) {
    const uint32_t* blk = words + (int64_t)j * 34 * batch + b;
#pragma unroll
    for (int l = 0; l < 17; ++l) {
      s[l] ^= (uint64_t)blk[(int64_t)(2 * l) * batch] |
              ((uint64_t)blk[(int64_t)(2 * l + 1) * batch] << 32);
    }
    keccak_f1600(s);
  }
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    state[(int64_t)(2 * l) * batch + b] = (uint32_t)s[l];
    state[(int64_t)(2 * l + 1) * batch + b] = (uint32_t)(s[l] >> 32);
  }
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
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
keccak_absorb_kernel(const uint32_t* __restrict__ words,
                     const int32_t* __restrict__ nblk,
                     uint32_t* __restrict__ state, int max_blocks,
                     int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b < batch) sponge_absorb_lane(words, nblk, state, max_blocks, batch, b);
}

__global__ void __launch_bounds__(kThreads)
keccak_squeeze_kernel(const uint32_t* __restrict__ state,
                      uint32_t* __restrict__ out, int n_words, int64_t batch) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b < batch) sponge_squeeze_lane(state, out, n_words, batch, b);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns cudaGetLastError() so a refused launch is reported to the caller.
extern "C" int fct_keccak_absorb(const uint32_t* words, const int32_t* nblk,
                                 uint32_t* state, int max_blocks,
                                 int64_t batch, void* stream) {
  if (batch <= 0) return 0;
  const unsigned grid = (unsigned)((batch + kThreads - 1) / kThreads);
  keccak_absorb_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      words, nblk, state, max_blocks, batch);
  return (int)cudaGetLastError();
}

extern "C" int fct_keccak_squeeze(const uint32_t* state, uint32_t* out,
                                  int n_words, int64_t batch, void* stream) {
  if (batch <= 0 || n_words <= 0) return 0;
  const unsigned grid = (unsigned)((batch + kThreads - 1) / kThreads);
  keccak_squeeze_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      state, out, n_words, batch);
  return (int)cudaGetLastError();
}
#endif
