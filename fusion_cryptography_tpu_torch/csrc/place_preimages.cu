// The prehash sponge's input placed from a flat message stream, for NVIDIA
// Hopper (sm_90a).
//
// The prehash absorbs dst + "," + message for every lane (fusion.py:405-409,
// SHA3-256).  Kernel keccak_absorb reads it as word-major, rate-padded words
// int32[rows, lanes] (byte j of a lane at bits 8*(j%4) of word j/4, lanes
// minor) and a block count a lane.  The host ships a chunk's messages as one
// flat byte stream with int64 offsets, and this kernel writes that input in
// one launch: the constant prefix, the message bytes, zeros, the SHA3 domain
// byte 0x06 at the preimage's length and 0x80 at the last byte of its last
// rate block (FIPS 202 pad10*1; they OR together when they meet), with each
// lane's block count and byte length.  Before it the host laid the rows out
// zero-padded, and the card permuted, transposed, padded and patched them in
// ~25 small torch launches.
//
// It replaces no TPU kernel: the JAX package lays the rows out on the host
// (fusion_cryptography_tpu/scheme/device_pipeline.py msg_preimage_words) and
// pads them with XLA.
//
// Lane j reads message (j mod c) * n + j div c, c = lanes / n: the signer-
// major order of a verify chunk of c groups of n signers (lane k*c + g is
// signer k of group g); n = 1 is the natural order.
//
// What bounds it: bytes.  A verify chunk (32,768 lanes of 62-byte preimages,
// one rate block) writes 4.46 MB of words and reads 1.93 MB of messages and
// 0.26 MB of offsets: ~2 us at 3.35 TB/s.  A thread takes one lane and
// kPlaceRows consecutive words of it, and a block's 128 threads are 128
// consecutive lanes, so every word row is stored as 512 contiguous bytes.
// The reads are not coalesced: each thread reads its own lane's message, as
// two aligned words joined by a funnel shift, but a message's one or two
// sectors serve all of that lane's rows from L1 or L2.  The few words that
// touch the prefix, the message's end or the last padding byte are built
// byte by byte; words past them are zero.
//
// Without nvcc the per-word function compiles as plain C++;
// tests/test_torch_place_preimages.py runs it in a serial loop.
#include "ntt_butterfly.cuh"  // FCT_HD, <cstdint>

namespace {

constexpr int kPlaceLanes = 128;   // lanes (threads) a block
constexpr int kPlaceRows = 8;      // words of its lane a thread writes
constexpr int kPlaceMaxGridY = 65535;
constexpr int64_t kPlaceRate = 136;  // SHA3-256's rate in bytes
constexpr uint32_t kSha3Domain = 0x06;

// Where lane `lane`'s preimage comes from and where it ends.
struct PlaceLane {
  int64_t off;   // the message's first byte in the stream
  int64_t len;   // the preimage's bytes: prefix and message
  int64_t last;  // the last byte of its last rate block
};

FCT_HD PlaceLane place_lane(const int64_t* offsets, int64_t lane, int64_t lanes, int n,
                            int prefix_len) {
  const int64_t c = lanes / n;
  const int64_t src = (lane % c) * n + lane / c;
  PlaceLane p;
  p.off = offsets[src];
  p.len = prefix_len + (offsets[src + 1] - p.off);
  p.last = (p.len / kPlaceRate + 1) * kPlaceRate - 1;
  return p;
}

// Bytes s..s+3 of the stream from the aligned words that hold them.
FCT_HD uint32_t join_bytes(uint32_t lo, uint32_t hi, int64_t s) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, 8 * (unsigned)(s & 3));
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (8 * (s & 3)));
#endif
}

// Word r of a lane's padded preimage.  `stream` holds at least one word past
// the word of the stream's last byte, so the word after any byte inside a
// message can be read.
FCT_HD uint32_t place_word(const uint8_t* prefix, int prefix_len, const uint32_t* stream,
                           const PlaceLane& p, int64_t r) {
  const int64_t b0 = 4 * r;
  if (b0 >= prefix_len && b0 + 4 <= p.len) {  // inside the message
    const int64_t s = p.off + b0 - prefix_len;
    return join_bytes(stream[s >> 2], stream[(s >> 2) + 1], s);
  }
  if (b0 > p.len && (b0 > p.last || b0 + 3 < p.last)) return 0u;
  const uint8_t* bytes = (const uint8_t*)stream;
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k) {
    const int64_t b = b0 + k;
    uint32_t v = b < prefix_len ? prefix[b]
                 : b < p.len    ? bytes[p.off + b - prefix_len]
                 : b == p.len   ? kSha3Domain
                                : 0u;
    if (b == p.last) v |= 0x80u;
    w |= v << (8 * k);
  }
  return w;
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kPlaceLanes)
place_preimages_kernel(const uint8_t* __restrict__ prefix, int prefix_len,
                       const int64_t* __restrict__ offsets, const uint32_t* __restrict__ stream,
                       int64_t lanes, int n, int rows, int32_t* __restrict__ words,
                       int32_t* __restrict__ n_blocks, int32_t* __restrict__ lengths) {
  const int64_t lane = (int64_t)blockIdx.x * kPlaceLanes + threadIdx.x;
  if (lane >= lanes) return;
  const PlaceLane p = place_lane(offsets, lane, lanes, n, prefix_len);
  if (blockIdx.y == 0) {
    n_blocks[lane] = (int32_t)((p.last + 1) / kPlaceRate);
    lengths[lane] = (int32_t)p.len;
  }
  for (int r0 = blockIdx.y * kPlaceRows; r0 < rows; r0 += gridDim.y * kPlaceRows) {
#pragma unroll
    for (int i = 0; i < kPlaceRows; ++i) {
      const int r = r0 + i;
      if (r < rows)
        words[(int64_t)r * lanes + lane] = (int32_t)place_word(prefix, prefix_len, stream, p, r);
    }
  }
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): prefix uint8[prefix_len]; offsets
// int64[lanes + 1] (message m is stream bytes offsets[m] .. offsets[m+1]);
// stream the bytes as words, with at least one word past the word of byte
// offsets[lanes]; lanes a multiple of n_signers; rows a multiple of 34 that
// holds every lane's padded preimage -> words int32[rows, lanes], n_blocks
// and lengths int32[lanes].  Returns a cudaError_t.
extern "C" int fct_place_preimages(const uint8_t* prefix, int prefix_len, const int64_t* offsets,
                                   const uint32_t* stream, int64_t lanes, int n_signers, int rows,
                                   int32_t* words, int32_t* n_blocks, int32_t* lengths,
                                   void* cu_stream) {
  if (lanes <= 0 || rows <= 0) return 0;
  const int64_t tiles = (rows + kPlaceRows - 1) / kPlaceRows;
  const dim3 grid((unsigned)((lanes + kPlaceLanes - 1) / kPlaceLanes),
                  (unsigned)(tiles < kPlaceMaxGridY ? tiles : kPlaceMaxGridY));
  place_preimages_kernel<<<grid, kPlaceLanes, 0, (cudaStream_t)cu_stream>>>(
      prefix, prefix_len, offsets, stream, lanes, n_signers, rows, words, n_blocks, lengths);
  return (int)cudaGetLastError();
}
#endif
