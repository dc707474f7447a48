// Per-lane evaluation of a preimage op table, shared by the fold kernels
// (preimage_fold.cu) and the generic spec assembler (assemble_spec.cu).
//
// Layout (the JAX package's, batch minor): packed words u32[W, B], byte j
// of a lane at bits 8*(j%4) of word j/4; lengths i32[B]; values i32[K, B]
// centered.  Every output is written up to its full width with zero words
// past the content: the sponge pads assuming clean words, so one stray byte
// would change the lane's hash.
//
// An op table (interop/device_serial.FoldTable) is a const-byte pool and
// ops (kind, writer mask, a0..a3): const(pool offset, bytes),
// cells(separator, first value row, count) and extra(index).  A thread
// walks the table once for its lane, renders each value in decimal (sign in
// unsigned arithmetic, no leading zeros), and streams the bytes through a
// 64-bit accumulator that stores whole words in order (a funnel shift for
// unaligned appends).
//
// Without nvcc, FCT_HD is `static inline` and these compile as plain C++
// (tests/test_torch_kernel_host.py builds them with the host compiler).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FCT_HD __device__ __forceinline__
#define FCT_HD_MEMBER __device__ __forceinline__
#else
#define FCT_HD static inline
#define FCT_HD_MEMBER inline
#endif

namespace {

constexpr int kOpFields = 6;
constexpr int kOpConst = 0;
constexpr int kOpCells = 1;
constexpr int kOpExtra = 2;

// The low n bytes of v (n clamped to [0, 4]).
FCT_HD uint32_t keep_bytes(uint32_t v, int n) {
  return n >= 4 ? v : (n <= 0 ? 0u : v & ((1u << (8 * n)) - 1u));
}

FCT_HD int clamp_int(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// One lane's output stream: bytes are appended to a 64-bit accumulator and
// whole words are stored in order; words at or past ``width`` are dropped
// (the length still counts them).
struct Writer {
  uint32_t* out;   // word 0 of this lane
  int64_t stride;  // elements between consecutive words
  int width;
  int nw;          // words stored so far
  int nbits;       // pending bits in acc, a multiple of 8 below 32
  uint64_t acc;
  int32_t total;   // bytes appended
};

FCT_HD Writer make_writer(uint32_t* out, int64_t stride, int width) {
  Writer w;
  w.out = out;
  w.stride = stride;
  w.width = width;
  w.nw = 0;
  w.nbits = 0;
  w.acc = 0;
  w.total = 0;
  return w;
}

// Append the low n bytes of v (n in [0, 4]; v zero above them).
FCT_HD void put(Writer& w, uint32_t v, int n) {
  w.acc |= (uint64_t)v << w.nbits;
  w.nbits += 8 * n;
  w.total += n;
  if (w.nbits >= 32) {
    if (w.nw < w.width) w.out[(int64_t)w.nw * w.stride] = (uint32_t)w.acc;
    ++w.nw;
    w.acc >>= 32;
    w.nbits -= 32;
  }
}

// Store the partial word and zero-fill to the width.
FCT_HD void finish(Writer& w) {
  if (w.nbits > 0) {
    if (w.nw < w.width) w.out[(int64_t)w.nw * w.stride] = (uint32_t)w.acc;
    ++w.nw;
    w.acc = 0;
    w.nbits = 0;
  }
  for (; w.nw < w.width; ++w.nw) w.out[(int64_t)w.nw * w.stride] = 0u;
}

// A lane's extra string: packed words with a row stride, ``len`` bytes
// live (clamped to the width; bytes past it are masked off when read).
struct Source {
  const uint32_t* buf;
  int64_t stride;
  int len;
};

FCT_HD Source make_source(const uint32_t* buf, int64_t stride, int width, int32_t len) {
  Source s;
  s.buf = buf;
  s.stride = stride;
  s.len = clamp_int(len, 0, 4 * width);
  return s;
}

// str(v) of an int32: '-' for negatives, no leading zeros, "0" for zero.
// Bytes 0..7 go to lo, 8..10 to hi, little-endian; returns the length.
FCT_HD int render_dec(int32_t v, uint64_t& lo, uint32_t& hi) {
  const bool neg = v < 0;
  uint32_t a = neg ? 0u - (uint32_t)v : (uint32_t)v;
  int nd = 1;
  uint32_t p = 10u;
  while (nd < 10 && a >= p) {
    ++nd;
    if (nd < 10) p *= 10u;
  }
  const int n = nd + (neg ? 1 : 0);
  lo = neg ? (uint64_t)'-' : 0u;
  hi = 0u;
  int pos = n - 1;
  for (int k = 0; k < nd; ++k, --pos) {
    const uint32_t q = a / 10u;
    const uint32_t c = (uint32_t)'0' + (a - q * 10u);
    a = q;
    if (pos < 8) {
      lo |= (uint64_t)c << (8 * pos);
    } else {
      hi |= c << (8 * (pos - 8));
    }
  }
  return n;
}

template <int NW>
FCT_HD void put_mask(Writer* ws, int mask, uint32_t v, int n) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    if ((mask >> k) & 1) put(ws[k], v, n);
  }
}

// Evaluate an op table for one lane into NW writers.  ``values`` points at
// the lane's value row 0 (stride ``vstride``); ``extras[e]`` is extra e's
// Source (an array of them, or any type whose operator[] makes one).
template <int NW, class Extras>
FCT_HD void run_ops(const int32_t* ops, int n_ops, const uint32_t* pool,
                    const int32_t* values, int64_t vstride,
                    const Extras& extras, Writer* ws) {
  for (int o = 0; o < n_ops; ++o) {
    const int32_t* op = ops + o * kOpFields;
    const int kind = op[0];
    const int mask = op[1];
    if (kind == kOpConst) {
      const int off = op[2];
      const int nbytes = op[3];
      for (int i = 0; 4 * i < nbytes; ++i) {
        const int n = nbytes - 4 * i < 4 ? nbytes - 4 * i : 4;
        put_mask<NW>(ws, mask, keep_bytes(pool[off + i], n), n);
      }
    } else if (kind == kOpCells) {
      const int sep_len = op[3];
      const uint32_t s0 = sep_len > 0 ? keep_bytes(pool[op[2]], sep_len) : 0u;
      const uint32_t s1 = sep_len > 4 ? keep_bytes(pool[op[2] + 1], sep_len - 4) : 0u;
      const int i0 = op[4];
      const int count = op[5];
      for (int i = 0; i < count; ++i) {
        if (sep_len > 0) put_mask<NW>(ws, mask, s0, sep_len < 4 ? sep_len : 4);
        if (sep_len > 4) put_mask<NW>(ws, mask, s1, sep_len - 4);
        uint64_t lo;
        uint32_t hi;
        const int n = render_dec(values[(int64_t)(i0 + i) * vstride], lo, hi);
        put_mask<NW>(ws, mask, (uint32_t)lo, n < 4 ? n : 4);
        if (n > 4) put_mask<NW>(ws, mask, (uint32_t)(lo >> 32), n < 8 ? n - 4 : 4);
        if (n > 8) put_mask<NW>(ws, mask, hi, n - 8);
      }
    } else if (kind == kOpExtra) {
      const Source s = extras[op[2]];
      const int full = s.len >> 2;
      for (int i = 0; i < full; ++i) put_mask<NW>(ws, mask, s.buf[(int64_t)i * s.stride], 4);
      const int tail = s.len & 3;
      if (tail) put_mask<NW>(ws, mask, keep_bytes(s.buf[(int64_t)full * s.stride], tail), tail);
    }
  }
}

}  // namespace
