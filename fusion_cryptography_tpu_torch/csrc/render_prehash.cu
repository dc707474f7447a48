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
// 10^9 * 2^32, so it fits 64 bits and the division by the constant becomes
// a multiply-high) give nine base-10^9 chunks, least significant first.
// The most significant nonzero chunk is rendered without leading zeros
// (render_dec_halves), every chunk below it as nine digits (five_digits),
// and the bytes stream into whole words (Writer): at most 78 digits, zero
// bytes past the length, the 20 words of the output written in order.
//
// What bounds it: integer instructions (~1,500 a lane, bounds.py), a few
// microseconds at a verify call's 32,768 digests; it reads 32 bytes and
// writes 84 a lane, coalesced (batch minor).
//
// Without nvcc the per-lane function compiles as plain C++;
// tests/test_torch_glue_kernels.py runs it in a serial loop.
#include "preimage_ops.cuh"  // Writer, put, finish, five_digits, render_dec_halves

namespace {

constexpr int kPrehashWords = 20;  // 80 bytes hold the 78 digits
constexpr int kRenderThreads = 256;

// Nine base-10^9 digits of the 256-bit integer with limbs x[0..7] (little
// endian), least significant first.
FCT_HD void chunks_1e9(const uint32_t* x, uint32_t* chunk) {
  uint32_t limbs[8];
  for (int k = 0; k < 8; ++k) limbs[k] = x[k];
  for (int c = 0; c < 9; ++c) {
    uint64_t r = 0;
    for (int k = 7; k >= 0; --k) {
      const uint64_t cur = (r << 32) | limbs[k];
      const uint64_t qt = cur / 1000000000ull;
      limbs[k] = (uint32_t)qt;
      r = cur - qt * 1000000000ull;
    }
    chunk[c] = (uint32_t)r;
  }
}

// Append the low n (0..11) bytes of the string (lo, hi).
FCT_HD void put_string(Writer& w, uint64_t lo, uint32_t hi, int n) {
  put(w, keep_bytes((uint32_t)lo, n), clamp_int(n, 0, 4));
  put(w, keep_bytes((uint32_t)(lo >> 32), n - 4), clamp_int(n - 4, 0, 4));
  put(w, keep_bytes(hi, n - 8), clamp_int(n - 8, 0, 4));
}

// Append the nine digits of c < 10^9, leading zeros kept.
FCT_HD void put_nine(Writer& w, uint32_t c) {
  const uint32_t h = c / 100000u;  // < 10^4: five_digits' first digit is 0
  const uint64_t dh = five_digits(h);
  const uint64_t dl = five_digits(c - h * 100000u);
  put(w, (uint32_t)(dh >> 8) | 0x30303030u, 4);
  put(w, (uint32_t)dl | 0x30303030u, 4);
  put(w, (uint32_t)(dl >> 32) | 0x30u, 1);
}

// One lane: digest limbs at digest[k * stride] -> str(int) into
// out[j * ostride] (kPrehashWords words, zero past the length); returns the
// length.
FCT_HD int32_t render_prehash_lane(const uint32_t* digest, int64_t stride, uint32_t* out,
                                   int64_t ostride) {
  uint32_t x[8], chunk[9];
  for (int k = 0; k < 8; ++k) x[k] = digest[k * stride];
  chunks_1e9(x, chunk);
  int top = 8;
  while (top > 0 && chunk[top] == 0u) --top;
  Writer w = make_writer(out, ostride, kPrehashWords);
  uint64_t lo;
  uint32_t hi;
  const int n = render_dec_halves((int32_t)chunk[top], lo, hi);  // chunk < 10^9 < 2^31
  put_string(w, lo, hi, n);
  for (int c = top - 1; c >= 0; --c) put_nine(w, chunk[c]);
  finish(w);
  return w.total;
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
#endif
