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
// cells(separator, first value row, count) and extra(index).  A lane walks
// the table once, renders each value in decimal (sign in unsigned
// arithmetic, no leading zeros), and streams the bytes into whole words in
// order (a funnel shift for unaligned appends).  Two walks do this:
// tile_run_ops (a warp a tile of lanes, words staged in shared memory and
// stored as whole row segments; the kernels of preimage_fold.cu and
// assemble_spec.cu), below, and run_ops (one thread a lane, each word
// stored as soon as it is complete), the plain walk that the host tests
// hold the tiled one against.
//
// Without nvcc, FCT_HD is `static inline` and these compile as plain C++
// (tests/test_torch_kernel_host.py builds them with the host compiler).
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_pipeline.h>  // __pipeline_memcpy_async (cp.async)
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

// ---------------------------------------------------------------------------
// The tiled walk (the signer folds): a warp holds a tile of 32 / G
// consecutive lanes, G threads a lane, thread t writing output t % G of lane
// t / G (G = 2 for signer_fold_a's two outputs), and stores whole row
// segments.
//
// Each thread streams its bytes as Writer does, but puts each completed
// word into its own column of the warp's ring of R rows in shared memory,
// ring[(w % R) * 32 + t] (the bank is the thread, so threads never
// conflict, and a thread only ever reads its own column).  The op table is
// the same for every lane, so the walk's items are warp-uniform and the
// lanes drift apart only by their rendered lengths.  A value and its
// separator are rendered into one string of at most 13 bytes and appended
// with one 128-bit shift (up to four words complete at once); with G = 2
// the two threads of a lane render every other value and swap the strings
// by a shuffle, so each value is rendered once for both outputs.  After
// each group of items that can complete at most kTileChunk words (a few
// values, a chunk of extra words, a chunk of const words) each output's
// threads move their front f to the lowest row they have all completed
// (__reduce_min_sync) and store every row it passes as one segment,
// out[r * B + b0 .. b0 + 32 / G - 1]; finish() stores the rest of the rows up
// to the width, zero tails included, the same way.  So a thread's ring
// holds its words [f, nw).
//
// Any drift is exact.  When an output's threads spread over more than the
// ring's window (R - kTileChunk - kTileSlack rows), f goes instead to half
// that below their median, so the bulk of them stays in the ring: a thread
// below f (a laggard) stores each word it completes under f directly,
// uncoalesced; and before a group that can complete k words, a thread
// whose ring would overrun (a leader, more than R - k words past f) stores
// its pending words directly and empties its ring, its output skipping its
// rows below that point (``base``) when it stores them.  Lanes past the
// batch run on the last lane's inputs and store nothing.
//
// The values and the extra words a thread reads are staged kStageRows rows
// at a time through two buffers of shared memory per warp (cp.async, each
// thread its own column), the next chunk in flight while one is consumed.
//
// The code is written for L threads per caller: L = 1 on the card (a
// caller is a thread of the warp, the collectives are warp intrinsics);
// L = 32 on the host, where one loop runs the warp's threads in lockstep
// (tests/test_torch_kernel_host.py).
// ---------------------------------------------------------------------------

constexpr int kWarp = 32;
constexpr int kTileChunk = 16;  // words a group of items may complete
constexpr int kTileSlack = 3;   // ring slots past a thread's last word that append() may write
constexpr int kStageRows = 16;  // rows of values or extra words per staged chunk
constexpr int kStageWords = 2 * kStageRows * kWarp;  // a warp's two stage buffers
constexpr unsigned kAllThreads = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;

// The tiled kernels' blocks: kTileWarps warps, each with a ring of kRing
// rows and the stage buffers in dynamic shared memory (48 KB a block, the
// most a launch gets without an opt-in).
constexpr int kTileWarps = 4;
constexpr int kRing = 64;
constexpr int kTileSmemWords = kRing * kWarp + kStageWords;  // a warp's: ring, then stage
constexpr int kTileSmemBytes = 4 * kTileWarps * kTileSmemWords;
static_assert(kTileSmemBytes <= 48 * 1024,
              "above 48 KB a block's dynamic shared memory needs an opt-in before each launch");

// Blocks of kTileWarps warps for ``batch`` lanes at ``lanes`` lanes a warp.
inline unsigned tile_blocks(int64_t batch, int lanes) {
  const int64_t per_block = (int64_t)kTileWarps * lanes;
  return (unsigned)((batch + per_block - 1) / per_block);
}

// Trailing zero bits of a nonzero 64-bit word.
FCT_HD int ctz64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)x) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

// The five decimal digits of t < 100000, the most significant first, as
// bytes 0..4 of a word (no '0' added).  t * ceil(2^32 / 10^4) puts the
// first digit in the high half and t mod 10^4 as a 32-bit fraction in the
// low half (off by less than 10^-4 of a digit, so every digit is exact);
// each further digit is the high half of the fraction times 10.
FCT_HD uint64_t five_digits(uint32_t t) {
  uint64_t f = (uint64_t)t * 429497u;
  uint64_t d = f >> 32;
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    f = (uint64_t)(uint32_t)f * 10u;
    d |= (f >> 32) << (8 * k);
  }
  return d;
}

// str(v) of an int32, as render_dec gives it, with a short dependent chain
// and no branches: the ten digits of |v| zero-padded, from two 5-digit
// halves side by side; the leading zeros found as the first byte of the
// string that is not '0', and shifted out of the 80-bit string at once.
// Bytes 0..7 go to lo, 8..10 to hi; returns the length.
FCT_HD int render_dec_halves(int32_t v, uint64_t& lo, uint32_t& hi) {
  const bool neg = v < 0;
  const uint32_t a = neg ? 0u - (uint32_t)v : (uint32_t)v;
  const uint32_t h = a / 100000u;  // digits 0..4
  const uint64_t dt = five_digits(a - h * 100000u);  // digits 5..9
  const uint64_t w = (five_digits(h) | (dt << 40)) | 0x3030303030303030ull;  // digits 0..7
  const uint64_t x = (dt >> 24) | 0x3030u;                                    // digits 8, 9
  const uint64_t wz = w ^ 0x3030303030303030ull;  // zero bytes: the digits '0'
  const int z = wz ? ctz64(wz) >> 3 : ((x & 0xffu) != '0' ? 8 : 9);  // leading zeros
  const int s = 8 * z;
  uint64_t l = s >= 64 ? x >> ((s - 64) & 63) : (w >> (s & 63)) | (s ? x << ((64 - s) & 63) : 0u);
  uint32_t g = s >= 64 ? 0u : (uint32_t)(x >> (s & 63));
  if (neg) {
    g = (g << 8) | (uint32_t)(l >> 56);
    l = (l << 8) | (uint64_t)'-';
  }
  lo = l;
  hi = g;
  return 10 - z + (neg ? 1 : 0);
}

// Warp collectives, as L threads per caller from warp thread t0: on the
// card L = 1, on the host L = 32 from t0 = 0 (the host branches use
// that).  The group ones take each thread's output (t % G) apart: m[l] is
// over the threads of thread l's output.
template <int L, int G>
FCT_HD void tile_group_min(const int* v, int* m, int t0) {
#ifdef __CUDA_ARCH__
  static_assert(L == 1, "a thread is one caller on the card");
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int x = __reduce_min_sync(kAllThreads, t0 % G == g ? v[0] : kIntMax);
    if (t0 % G == g) m[0] = x;
  }
#else
  for (int l = 0; l < L; ++l) {
    m[l] = v[l];
    for (int k = l % G; k < L; k += G) m[l] = v[k] < m[l] ? v[k] : m[l];
  }
#endif
}

template <int L, int G>
FCT_HD void tile_group_max(const int* v, int* m, int t0) {
#ifdef __CUDA_ARCH__
  static_assert(L == 1, "a thread is one caller on the card");
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int x = __reduce_max_sync(kAllThreads, t0 % G == g ? v[0] : -kIntMax);
    if (t0 % G == g) m[0] = x;
  }
#else
  for (int l = 0; l < L; ++l) {
    m[l] = v[l];
    for (int k = l % G; k < L; k += G) m[l] = v[k] > m[l] ? v[k] : m[l];
  }
#endif
}

// The median (the (32 / G / 2)-th smallest) of each output's values, all
// below 2^24: on the card one bitonic sort of (output, value) across the
// warp by shuffles.
template <int L, int G>
FCT_HD void tile_group_median(const int* v, int* m, int t0) {
  constexpr int kPer = kWarp / G;
#ifdef __CUDA_ARCH__
  static_assert(L == 1, "a thread is one caller on the card");
  int x = ((t0 % G) << 24) | v[0];
#pragma unroll
  for (int k = 2; k <= kWarp; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int y = __shfl_xor_sync(kAllThreads, x, j);
      const bool keep_min = ((t0 & k) == 0) == ((t0 & j) == 0);
      x = keep_min ? (x < y ? x : y) : (x > y ? x : y);
    }
  }
  m[0] = __shfl_sync(kAllThreads, x, (t0 % G) * kPer + kPer / 2) & 0xffffff;
#else
  for (int l = 0; l < L; ++l) {  // the value with kPer / 2 of its output's below it
    for (int i = l % G; i < L; i += G) {
      int below = 0, at = 0;
      for (int k = l % G; k < L; k += G) {
        below += v[k] < v[i];
        at += v[k] <= v[i];
      }
      if (below <= kPer / 2 && kPer / 2 < at) {
        m[l] = v[i];
        break;
      }
    }
  }
#endif
}

// The largest of all the warp's values.
template <int L>
FCT_HD int tile_max_all(const int* v) {
#ifdef __CUDA_ARCH__
  static_assert(L == 1, "a thread is one caller on the card");
  return __reduce_max_sync(kAllThreads, v[0]);
#else
  int m = v[0];
  for (int l = 1; l < L; ++l) m = v[l] > m ? v[l] : m;
  return m;
#endif
}

template <int L>
FCT_HD bool tile_any(const bool* v) {
#ifdef __CUDA_ARCH__
  static_assert(L == 1, "a thread is one caller on the card");
  return __any_sync(kAllThreads, v[0]);
#else
  bool a = false;
  for (int l = 0; l < L; ++l) a = a || v[l];
  return a;
#endif
}

// Warp thread ``src``'s v.
template <int L, class T>
FCT_HD T tile_from(const T* v, int src) {
#ifdef __CUDA_ARCH__
  static_assert(L == 1, "a thread is one caller on the card");
  return __shfl_sync(kAllThreads, v[0], src);
#else
  return v[src];
#endif
}

// The output streams of a warp's threads: thread t0 + l writes column
// col[l] (stride rows apart, width[l] words) and its front f[l] is the same
// for all the threads of one output.
template <int L, int R, int G>
struct TileWriter {
  static_assert((R & (R - 1)) == 0 && R >= 2 * kTileChunk, "R: a power of two, two chunks deep");
  // rows the bulk of an output's threads may spread over
  static constexpr int kWindow = R - kTileChunk - kTileSlack;

  uint32_t* ring;  // the warp's ring, R rows of kWarp words
  int64_t stride;  // elements between rows (the batch)
  int t0;
  uint32_t* col[L];  // word 0 of the thread's output column
  int width[L];
  int f[L];        // rows below f are stored, or will be stored directly
  bool live[L];    // lane inside the batch
  int nw[L];       // words completed
  int nbits[L];    // pending bits in acc, a multiple of 8 below 32
  uint64_t acc[L];
  int32_t total[L];  // bytes appended
  int base[L];     // words below base were stored directly

  FCT_HD_MEMBER uint32_t& slot(int l, int w) {
    return ring[(w & (R - 1)) * kWarp + t0 + l];
  }

  FCT_HD_MEMBER void store(int l, int w, uint32_t v) {
    if (live[l] && w < width[l]) col[l][(int64_t)w * stride] = v;
  }

  // Word w of thread l is complete: into the ring, or directly under f.
  FCT_HD_MEMBER void emit(int l, int w, uint32_t v) {
    if (w < f[l]) {
      store(l, w, v);
    } else {
      slot(l, w) = v;
    }
  }

  // Append the low n bytes of v (n in [0, 4]; v zero above them).
  FCT_HD_MEMBER void put(int l, uint32_t v, int n) {
    acc[l] |= (uint64_t)v << nbits[l];
    nbits[l] += 8 * n;
    total[l] += n;
    if (nbits[l] >= 32) {
      emit(l, nw[l], (uint32_t)acc[l]);
      ++nw[l];
      acc[l] >>= 32;
      nbits[l] -= 32;
    }
  }

  // Append one whole word.
  FCT_HD_MEMBER void put_word(int l, uint32_t v) {
    const uint64_t x = acc[l] | ((uint64_t)v << nbits[l]);
    total[l] += 4;
    emit(l, nw[l], (uint32_t)x);
    ++nw[l];
    acc[l] = x >> 32;
  }

  // Append the low n bytes (n <= 13) of the string lo:hi (zero above them):
  // with the pending bytes at most 128 bits, so at most four words complete.
  // All four candidate words go to the ring: the slots past the completed
  // ones are free (kTileSlack) and are written again before they are read.
  // A laggard stores its completed words under f directly.
  FCT_HD_MEMBER void append(int l, uint64_t lo, uint64_t hi, int n) {
    const int b = nbits[l];
    const uint64_t x0 = acc[l] | (lo << b);
    const uint64_t x1 = (b ? lo >> (64 - b) : 0u) | (hi << b);
    const int bits = b + 8 * n;
    const int c = bits >> 5;  // words completed
    const uint32_t w0 = (uint32_t)x0, w1 = (uint32_t)(x0 >> 32);
    const uint32_t w2 = (uint32_t)x1, w3 = (uint32_t)(x1 >> 32);
    const int w = nw[l];
    slot(l, w) = w0;
    slot(l, w + 1) = w1;
    slot(l, w + 2) = w2;
    slot(l, w + 3) = w3;
    if (w < f[l]) {
      if (c > 0) store(l, w, w0);
      if (c > 1 && w + 1 < f[l]) store(l, w + 1, w1);
      if (c > 2 && w + 2 < f[l]) store(l, w + 2, w2);
      if (c > 3 && w + 3 < f[l]) store(l, w + 3, w3);
    }
    acc[l] = c == 0 ? w0 : (c == 1 ? w1 : (c == 2 ? w2 : (c == 3 ? w3 : 0u)));
    nw[l] = w + c;
    nbits[l] = bits & 31;
    total[l] += n;
  }

  // Before a group that completes at most k <= kTileChunk words: after it
  // the thread's ring words and the kTileSlack slots past them must fit in R.
  FCT_HD_MEMBER void reserve(int k) {
    for (int l = 0; l < L; ++l) {
      const int from = f[l] > base[l] ? f[l] : base[l];
      if (nw[l] + k + kTileSlack - from >= R) {
        for (int w = from; w < nw[l]; ++w) store(l, w, slot(l, w));
        base[l] = nw[l];
      }
    }
  }

  // After a group: move each output's front, storing the rows it passes,
  // one segment each (a thread's words of those rows that it has not
  // completed yet will be stored directly).  Four rows at a time, their
  // slots read together.
  FCT_HD_MEMBER void sync() {
    int lo[L], hi[L], mid[L];
    bool spread[L];
    tile_group_min<L, G>(nw, lo, t0);
    tile_group_max<L, G>(nw, hi, t0);
    for (int l = 0; l < L; ++l) spread[l] = hi[l] - lo[l] > kWindow;
    if (tile_any<L>(spread)) tile_group_median<L, G>(nw, mid, t0);
    for (int l = 0; l < L; ++l) {
      int to = lo[l];
      if (spread[l]) {
        const int centre = mid[l] - kWindow / 2;
        to = centre > to ? centre : to;
      }
      const int end = to < width[l] ? to : width[l];
      uint32_t* dst = col[l] + (int64_t)f[l] * stride;
      for (int r = f[l]; r < end; r += 4, dst += 4 * stride) {
        uint32_t v[4];
        bool due[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          due[j] = (r + j < end) & live[l] & (r + j >= base[l]) & (r + j < nw[l]);
          v[j] = slot(l, r + j);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (due[j]) dst[j * stride] = v[j];
        }
      }
      f[l] = to > f[l] ? to : f[l];
    }
  }

  // The partial word, then every row left up to the width (zero past nw).
  FCT_HD_MEMBER void finish() {
    reserve(1);
    for (int l = 0; l < L; ++l) {
      if (nbits[l] > 0) {
        emit(l, nw[l], (uint32_t)acc[l]);
        ++nw[l];
        acc[l] = 0;
        nbits[l] = 0;
      }
      for (int r = nw[l]; r < f[l]; ++r) store(l, r, 0u);  // a laggard's zero tail under f
      for (int r = f[l]; r < width[l]; ++r) {
        if (r >= base[l]) store(l, r, r < nw[l] ? slot(l, r) : 0u);
      }
      f[l] = width[l] > f[l] ? width[l] : f[l];
    }
  }
};

// Threads t0 .. t0 + L - 1 of the warp whose tile's lane 0 is batch lane
// b0: thread t writes outs[t % G] (width widths[t % G]) for lane t / G.
template <int L, int R, int G>
FCT_HD void init_tile_writer(TileWriter<L, R, G>& w, uint32_t* ring, uint32_t* const* outs,
                             const int* widths, int64_t batch, int64_t b0, int t0) {
  w.ring = ring;
  w.stride = batch;
  w.t0 = t0;
  for (int l = 0; l < L; ++l) {
    const int t = t0 + l;
    w.col[l] = outs[t % G] + b0 + t / G;
    w.width[l] = widths[t % G];
    w.f[l] = 0;
    w.live[l] = b0 + t / G < batch;
    w.nw[l] = 0;
    w.nbits[l] = 0;
    w.acc[l] = 0;
    w.total[l] = 0;
    w.base[l] = 0;
  }
}

// The batch lane whose inputs tile lane ``lane`` reads: past the batch,
// the last lane's.
FCT_HD int64_t tile_lane_index(int64_t batch, int64_t b0, int lane) {
  return b0 + lane < batch ? b0 + lane : batch - 1;
}

// Rows c + first[l] + STEP * i (below c + kStageRows and n[l]) of each
// thread's column src[l][row * stride] into its column of stage buffer
// ``buf`` (stage[(buf * kStageRows + r) * 32 + t]): on the card by
// cp.async, one commit group; on the host copied.
template <int L, int STEP>
FCT_HD void tile_stage(uint32_t* stage, int buf, const uint32_t* const* src, int64_t stride,
                       int c, const int* first, const int* n, int t0) {
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int i = 0; i < kStageRows; i += STEP) {
      const int r = i + first[l];
      if (r < kStageRows && c + r < n[l]) {
        uint32_t* dst = stage + (buf * kStageRows + r) * kWarp + t0 + l;
        const uint32_t* from = src[l] + (int64_t)(c + r) * stride;
#ifdef __CUDA_ARCH__
        __pipeline_memcpy_async(dst, from, 4);
#else
        *dst = *from;
#endif
      }
    }
  }
#ifdef __CUDA_ARCH__
  __pipeline_commit();
#endif
}

// The chunk staged before the last one has landed.
FCT_HD void tile_stage_wait() {
#ifdef __CUDA_ARCH__
  __pipeline_wait_prior(1);
#endif
}

FCT_HD uint32_t staged(const uint32_t* stage, int buf, int r, int t) {
  return stage[(buf * kStageRows + r) * kWarp + t];
}

// One item of a cells op: value v rendered with its separator (sep:
// sep_len <= 8 bytes) in front when they fit in 13 bytes (sep_len <= 2)
// -> the string a:b and its length; a longer separator is appended alone
// first.
FCT_HD int tile_item(uint64_t sep, int sep_len, int32_t v, uint64_t& a, uint64_t& b) {
  uint64_t lo;
  uint32_t hi;
  const int n = render_dec_halves(v, lo, hi);
  if (sep_len > 0 && sep_len <= 2) {
    a = sep | (lo << (8 * sep_len));
    b = (lo >> (64 - 8 * sep_len)) | ((uint64_t)hi << (8 * sep_len));
    return n + sep_len;
  }
  a = lo;
  b = hi;
  return n;
}

// run_ops for a warp's tile: thread t0 + l writes when its output's bit
// (t % G) is in an op's mask; ``vals[l]`` points at its lane's value row 0
// (stride ``vstride``), ``ex[e][l]`` is its lane's Source of extra e (an
// array Source[E][L], or any type whose [e][l] makes one), every lane's
// with one row stride; ``stage`` is the warp's kStageWords words of shared
// memory.
template <int L, int R, int G, class Extras>
FCT_HD void tile_run_ops(const int32_t* ops, int n_ops, const uint32_t* pool,
                         const int32_t* const* vals, int64_t vstride, const Extras& ex,
                         uint32_t* stage, TileWriter<L, R, G>& w) {
  const int t0 = w.t0;
  for (int o = 0; o < n_ops; ++o) {
    const int32_t* op = ops + o * kOpFields;
    const int kind = op[0];
    const int mask = op[1] & ((1 << G) - 1);
    if (mask == 0) continue;
    bool act[L];
    int par[L];  // the thread's output, and the values it renders (one in G)
    for (int l = 0; l < L; ++l) {
      par[l] = (t0 + l) % G;
      act[l] = (mask >> par[l]) & 1;
    }
    if (kind == kOpConst) {
      const int off = op[2];
      const int nbytes = op[3];
      const int words = (nbytes + 3) >> 2;
      for (int c = 0; c < words; c += kTileChunk) {
        w.reserve(kTileChunk);
        for (int i = c; i < words && i < c + kTileChunk; ++i) {
          const int n = nbytes - 4 * i < 4 ? nbytes - 4 * i : 4;
          const uint32_t v = keep_bytes(pool[off + i], n);
          for (int l = 0; l < L; ++l) {
            if (act[l]) w.put(l, v, n);
          }
        }
        w.sync();
      }
    } else if (kind == kOpCells) {
      const int sep_len = op[3];
      const uint64_t sep = (sep_len > 0 ? (uint64_t)keep_bytes(pool[op[2]], sep_len) : 0u) |
                           (sep_len > 4 ? (uint64_t)keep_bytes(pool[op[2] + 1], sep_len - 4) << 32
                                        : 0u);
      const int i0 = op[4];
      const int count = op[5];
      // items per group: each at most sep_len + 11 bytes, three pending; a
      // multiple of G, so each thread renders values of one parity
      const int group = (4 * kTileChunk - 3) / (sep_len + 11) / G * G;
      const uint32_t* src[L];
      int rows[L];
      for (int l = 0; l < L; ++l) {
        src[l] = reinterpret_cast<const uint32_t*>(vals[l] + (int64_t)i0 * vstride);
        rows[l] = count;
      }
      tile_stage<L, G>(stage, 0, src, vstride, 0, par, rows, t0);
      tile_stage<L, G>(stage, 1, src, vstride, kStageRows, par, rows, t0);
      for (int c = 0, buf = 0; c < count; c += kStageRows, buf ^= 1) {
        tile_stage_wait();
        const int m = count - c < kStageRows ? count - c : kStageRows;
        for (int g = 0; g < m; g += group) {
          w.reserve(kTileChunk);
          const int gend = g + group < m ? g + group : m;
          for (int r = g; r < gend; r += G) {
            uint64_t ia[L], ib[L];  // the item each thread renders: value r + par
            int im[L];
            for (int l = 0; l < L; ++l) {
              ia[l] = ib[l] = 0;
              im[l] = 0;
              if (r + par[l] < gend) {
                im[l] = tile_item(sep, sep_len, (int32_t)staged(stage, buf, r + par[l], t0 + l),
                                  ia[l], ib[l]);
              }
            }
            for (int k = 0; k < G && r + k < gend; ++k) {  // value r + k, from its renderer
              for (int l = 0; l < L; ++l) {
                const int from = t0 + l - par[l] + k;
                const uint64_t a = tile_from<L>(ia, from), b = tile_from<L>(ib, from);
                const int n = tile_from<L>(im, from);
                if (act[l]) {
                  if (sep_len > 2) w.append(l, sep, 0u, sep_len);
                  w.append(l, a, b, n);
                }
              }
            }
          }
          w.sync();
        }
        tile_stage<L, G>(stage, buf, src, vstride, c + 2 * kStageRows, par, rows, t0);
      }
    } else if (kind == kOpExtra) {
      Source s[L];
      for (int l = 0; l < L; ++l) s[l] = ex[op[2]][l];
      const uint32_t* src[L];
      int full[L], first[L];
      for (int l = 0; l < L; ++l) {
        src[l] = s[l].buf;
        full[l] = act[l] ? s[l].len >> 2 : 0;
        first[l] = 0;
      }
      const int most = tile_max_all<L>(full);
      const int64_t stride = s[0].stride;
      tile_stage<L, 1>(stage, 0, src, stride, 0, first, full, t0);
      tile_stage<L, 1>(stage, 1, src, stride, kStageRows, first, full, t0);
      for (int c = 0, buf = 0; c < most; c += kStageRows, buf ^= 1) {
        tile_stage_wait();
        const int m = most - c < kStageRows ? most - c : kStageRows;
        w.reserve(kStageRows);
        for (int r = 0; r < m; ++r) {
          for (int l = 0; l < L; ++l) {
            if (c + r < full[l]) w.put_word(l, staged(stage, buf, r, t0 + l));
          }
        }
        w.sync();
        tile_stage<L, 1>(stage, buf, src, stride, c + 2 * kStageRows, first, full, t0);
      }
      w.reserve(1);
      for (int l = 0; l < L; ++l) {
        const int tail = s[l].len & 3;
        if (act[l] && tail) w.put(l, keep_bytes(s[l].buf[(int64_t)full[l] * s[l].stride], tail), tail);
      }
      w.sync();
    }
  }
}

}  // namespace
