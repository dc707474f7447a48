// The message prehash's decimal render for NVIDIA Hopper (sm_90a): SHA3-256
// digests as 256-bit little-endian integers -> str(int), left-aligned in
// packed words, with their lengths.
//
// Replaces the stage the JAX package compiles with XLA,
// fusion_cryptography_tpu/ops/ragged_words.py render_bigint_dec_w (78
// divmod-by-10 sweeps over the 32-bit limbs), the device twin of the
// reference's str(int.from_bytes(sha3_256(...), 'little'))
// (fusion/fusion.py:405-409).  In the port's torch glue it was ~420 small
// launches a verify call.
//
// A thread a lane: the digest's eight limbs in registers, nine divmod-by-
// 10^9 sweeps from the top limb (each dividend r * 2^32 + limb is below
// 10^9 * 2^32, so it fits 64 bits, the division by the constant becomes a
// multiply-high, and the remainder is exact in 32 bits) give nine base-10^9
// chunks, least significant first.
//
// What bounds it: integer instructions (~1,500 a lane, bounds.py), a few
// microseconds at a verify call's 32,768 digests; it reads 32 bytes and
// writes 84 a lane, coalesced (batch minor).  Only ~8 warps an SM have
// work, so latency, not instruction throughput, sets the time.  The earlier design
// streamed the digits through a byte writer (Writer): every append was a
// branch on the pending bytes and a possible store, and the top chunk's
// length is only known at run time, so a lane's ~27 appends ran one after
// another, while the 72 division steps were already straight-line code
// (nvcc unrolls them; its SASS).  Now the render has no branch: the leading zero
// chunks are dropped by a select network over the nine chunks, each chunk
// is rendered as nine digits on its own (two five_digits, independent of
// the others), the 81 digits are packed into 21 words at fixed offsets,
// one shift removes the top chunk's leading zeros, and the 20 output words
// are stored unconditionally, bytes past the length masked.  Device time
// at a verify call's 32,768 digests: ~5.2 us before, ~3.8 us now (python
// -m fusion_cryptography_tpu_torch.glue_ab against the earlier commit;
// NVIDIA H100 80GB HBM3, 700 W).
//
// Without nvcc the per-lane function compiles as plain C++;
// tests/test_torch_glue_kernels.py runs it in a serial loop.
#include "preimage_ops.cuh"  // keep_bytes, five_digits, ctz64

namespace {

constexpr int kPrehashWords = 20;  // 80 bytes hold the 78 digits
constexpr int kDigitWords = 21;    // the nine chunks' 81 digits
constexpr int kRenderThreads = 128;

// Nine base-10^9 digits of the 256-bit integer with limbs x[0..7] (little
// endian), least significant first.
FCT_HD void chunks_1e9(const uint32_t* x, uint32_t* chunk) {
  uint32_t limbs[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) limbs[k] = x[k];
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    uint32_t r = 0;
#pragma unroll
    for (int k = 7; k >= 0; --k) {
      const uint64_t cur = ((uint64_t)r << 32) | limbs[k];
      const uint32_t qt = (uint32_t)(cur / 1000000000ull);  // < 2^32: cur < 10^9 * 2^32
      limbs[k] = qt;
      r = (uint32_t)cur - qt * 1000000000u;  // < 10^9: exact mod 2^32
    }
    chunk[c] = r;
  }
}

// The nine digits of c < 10^9 as ASCII, leading zeros kept: digit k in
// byte k of lo (k < 8), digit 8 in hi.
FCT_HD void nine_ascii(uint32_t c, uint64_t& lo, uint32_t& hi) {
  const uint32_t h = c / 100000u;  // < 10^4: five_digits' first digit is 0
  const uint64_t dh = five_digits(h);
  const uint64_t dl = five_digits(c - h * 100000u);
  lo = (dh >> 8) | ((dl & 0xffffffffull) << 32) | 0x3030303030303030ull;
  hi = (uint32_t)(dl >> 32) | 0x30u;
}

// One lane: digest limbs at digest[k * stride] -> str(int) into
// out[j * ostride] (kPrehashWords words, zero past the length); returns the
// length.
FCT_HD int32_t render_prehash_lane(const uint32_t* digest, int64_t stride, uint32_t* out,
                                   int64_t ostride) {
  uint32_t x[8], ch[9];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = digest[k * stride];
  chunks_1e9(x, ch);
  // most significant chunk first, the a leading zero chunks dropped (a <= 8)
  int a = 0;
  bool lead = true;
#pragma unroll
  for (int c = 8; c > 0; --c) {
    lead = lead && ch[c] == 0u;
    a += lead;
  }
  uint32_t m[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) m[j] = ch[8 - j];
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) {
#pragma unroll
    for (int j = 0; j < 9; ++j) m[j] = (a & s) ? (j + s < 9 ? m[j + s] : 0u) : m[j];
  }
  // chunk j's nine digits at bytes 9j .. 9j+8 of z; z[21..22] stay 0
  uint32_t z[kDigitWords + 2];
#pragma unroll
  for (int i = 0; i < kDigitWords + 2; ++i) z[i] = 0u;
  uint64_t top = 0;
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    uint64_t lo;
    uint32_t hi;
    nine_ascii(m[j], lo, hi);
    if (j == 0) top = lo;
    const int w0 = (9 * j) >> 2, sh = 8 * ((9 * j) & 3);
    const uint64_t lo_s = lo << sh;
    const uint64_t hi_s = sh ? (lo >> (64 - sh)) | ((uint64_t)hi << sh) : (uint64_t)hi;
    z[w0] |= (uint32_t)lo_s;
    z[w0 + 1] |= (uint32_t)(lo_s >> 32);
    z[w0 + 2] |= (uint32_t)hi_s;
    z[w0 + 3] |= (uint32_t)(hi_s >> 32);
  }
  // b leading zeros of the top chunk (at most 8: zero renders as "0")
  const uint64_t lz = top ^ 0x3030303030303030ull;
  const int b = lz ? ctz64(lz) >> 3 : 8;
  const int32_t len = 81 - 9 * a - b;
  const int q = b >> 2, sh = 8 * (b & 3);
#pragma unroll
  for (int i = 0; i < kPrehashWords; ++i) {
    const uint32_t u0 = q == 0 ? z[i] : (q == 1 ? z[i + 1] : z[i + 2]);
    const uint32_t u1 = q == 0 ? z[i + 1] : (q == 1 ? z[i + 2] : z[i + 3]);
    const uint32_t v = sh ? (u0 >> sh) | (u1 << (32 - sh)) : u0;
    out[i * ostride] = keep_bytes(v, len - 4 * i);
  }
  return len;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kRenderThreads)
render_prehash_kernel(const uint32_t* __restrict__ digest, int64_t lanes,
                      uint32_t* __restrict__ out, int32_t* __restrict__ len) {
  const int64_t b = (int64_t)blockIdx.x * kRenderThreads + threadIdx.x;
  if (b >= lanes) return;
  len[b] = render_prehash_lane(digest + b, lanes, out + b, lanes);
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): digest u32[8, lanes] (SHA3-256 words,
// little-endian limbs) -> out u32[20, lanes] (str(int), left-aligned, zero
// past the length), len int32[lanes].  Returns a cudaError_t.
extern "C" int fct_render_prehash(const uint32_t* digest, int64_t lanes, uint32_t* out,
                                  int32_t* len, void* stream) {
  if (lanes <= 0) return 0;
  const unsigned blocks = (unsigned)((lanes + kRenderThreads - 1) / kRenderThreads);
  render_prehash_kernel<<<blocks, kRenderThreads, 0, (cudaStream_t)stream>>>(digest, lanes, out,
                                                                             len);
  return (int)cudaGetLastError();
}

// The launch fct_render_prehash would make for `lanes` digests, not made:
// shape = [blocks, threads a block, dynamic shared bytes, registers a
// thread, blocks an SM can hold].  Returns a cudaError_t.
extern "C" int fct_render_prehash_shape(int64_t lanes, int32_t* shape) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, render_prehash_kernel);
  int per_sm = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, render_prehash_kernel,
                                                       kRenderThreads, 0);
  shape[0] = (int32_t)((lanes + kRenderThreads - 1) / kRenderThreads);
  shape[1] = kRenderThreads;
  shape[2] = 0;
  shape[3] = rc == cudaSuccess ? attr.numRegs : 0;
  shape[4] = per_sm;
  return (int)rc;
}
#endif
