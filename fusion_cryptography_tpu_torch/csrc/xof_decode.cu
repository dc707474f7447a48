// XOF decode for NVIDIA Hopper (sm_90a): packed-word SHAKE256 streams ->
// bounded-coefficient polynomials, one row of d int32 coefficients a stream.
//
// Replaces the stages the JAX package compiles with XLA for the challenges
// and the alphas: fusion_cryptography_tpu/ops/xof_decode.py decode_coeffs_w
// (with _block_horner_w, _block_powers and the closed-form Fisher-Yates
// placement _fy_place_lm) and split_streams_w / realign_words.  A stream is
//   [ signum bytes ][ w magnitude blocks ][ S = d-1-w index rows ]
// (fusion/fusion.py:422-481): signum i is bit i of the big-endian integer
// over the signum bytes; a magnitude is its big-endian block mod the bound,
// plus one (bound 1 reads no block); index row t is its big-endian block mod
// d - t.  Rows past the stream's ``n_bytes`` read a shorter integer, or 0:
// the power table P[row, k] = 256^(avail-1-k) mod m (k < avail, else 0)
// carries that, so a row is one multiply-add a byte and one ``%``.
//
// Placement, the closed form of the partial Fisher-Yates: live slot m < w
// moves to d-1-t at the first swap t whose index is m, else stays at m, so
// a stream's row d-1-t holds value m at that first hit and 0 otherwise, and
// rows 0..w hold the values never hit.  A 64-bit hit mask (w <= 64) does it
// in one pass over the swaps: no scatter, no [B, S, bytes] tensor.
//
// Layout: words u32[W, L] batch minor (byte j of a lane is byte j%4 of word
// j/4), L lanes each carrying n_streams streams n_bytes apart (stream k of
// lane g starts at byte k*n_bytes, any alignment: the group stage's blob
// read in place, without split_streams_w's realignment); output int32
// rows [L * n_streams, d], row g*n_streams + k, the layout the NTT takes.
//
// What bounds it: bytes.  A stream's index rows are read once (8,423 bytes
// a challenge stream at secpar=256, 3,968 an alpha stream), a few integer
// instructions a byte.  The design keeps the reads coalesced and the card
// full:
// * A block takes 32 consecutive lanes (one stream each: threadIdx.x) and
//   splits their rows over kDecodeChunks warps (threadIdx.y), the rows that
//   lie inside the stream evenly, and those past its end: a warp reads one
//   word of 32 neighbouring lanes at a time, a 128-byte line.  Every warp's
//   control flow is uniform (all lanes walk the same byte offsets).
// * Each thread reads a row's words (a 36-byte segment, ten loads) at once
//   and realigns them with funnel shifts, so a row waits for memory once;
//   the table entries are the same for every lane of a warp (broadcast).
// * The rows' residues go to shared memory ([row][lane]: no bank conflict);
//   warp 0 then places each lane's stream into a shared tile (int8 values
//   when the bound is 1), and the whole block writes the 32 rows of d
//   coefficients out coalesced.
//
// Without nvcc the per-lane functions compile as plain C++ (FCT_HD is
// `static inline`); tests/test_torch_glue_kernels.py runs them with a serial
// loop in place of the grid.
#include "preimage_ops.cuh"  // FCT_HD

#ifdef __CUDACC__
#define FCT_HOST_HD __host__ __device__ __forceinline__
#else
#define FCT_HOST_HD static inline
#endif

namespace {

constexpr int kDecodeLanes = 32;  // lanes (streams) a block
constexpr int kDecodeChunks = 8;  // warps a block, each a share of the rows

// The static layout of one decoded stream (xof_decode.DecodeGeometry).
struct DecodeGeom {
  int d, w, S;         // degree, weight bound, swaps d-1-w (or 0)
  int nb, bpc, bpi;    // signum bytes, bytes a magnitude block, an index row
  int nmag;            // magnitude rows read: w when bound != 1, else 0
  int n_bytes;         // a stream's logical length
  uint32_t bound;
};

FCT_HOST_HD DecodeGeom make_decode_geom(int d, int w, int nb, int bpc, int bpi, int n_bytes,
                                        uint32_t bound) {
  DecodeGeom g;
  g.d = d;
  g.w = w;
  g.S = d - 1 - w > 0 ? d - 1 - w : 0;
  g.nb = nb;
  g.bpc = bpc;
  g.bpi = bpi;
  g.nmag = bound != 1u ? w : 0;
  g.n_bytes = n_bytes;
  g.bound = bound;
  return g;
}

// First byte of row r (rows 0..nmag-1 magnitudes, then the index rows);
// r = nmag + S is the end of the last row.
FCT_HD int64_t row_start(const DecodeGeom& g, int r) {
  const int64_t index_off = (int64_t)g.nb + (int64_t)g.w * g.bpc;
  return r < g.nmag ? (int64_t)g.nb + (int64_t)r * g.bpc
                    : index_off + (int64_t)(r - g.nmag) * g.bpi;
}

FCT_HD int row_width(const DecodeGeom& g, int r) { return r < g.nmag ? g.bpc : g.bpi; }

FCT_HD uint32_t row_modulus(const DecodeGeom& g, int r) {
  return r < g.nmag ? g.bound : (uint32_t)(g.d - (r - g.nmag));
}

FCT_HD int64_t row_table_offset(const DecodeGeom& g, int r) {
  return r < g.nmag ? (int64_t)r * g.bpc
                    : (int64_t)g.nmag * g.bpc + (int64_t)(r - g.nmag) * g.bpi;
}

constexpr int kSegWords = 9;  // a row is read in segments of 36 bytes

// Word i of a lane (0 past the buffer).
FCT_HD uint32_t load_word(const uint32_t* words, int64_t ld, int64_t n_words, int64_t i) {
  return i < n_words ? words[i * ld] : 0u;
}

// The kSegWords words starting at byte a of a lane, realigned so that byte
// k of the segment is byte k % 4 of al[k / 4]: kSegWords + 1 independent
// loads, one funnel shift a word.
FCT_HD void load_segment(const uint32_t* words, int64_t ld, int64_t n_words, int64_t a,
                         uint32_t* al) {
  const int64_t w0 = a >> 2;
  const int sh = 8 * (int)(a & 3);
  uint32_t raw[kSegWords + 1];
#pragma unroll
  for (int j = 0; j <= kSegWords; ++j) raw[j] = load_word(words, ld, n_words, w0 + j);
#pragma unroll
  for (int j = 0; j < kSegWords; ++j)
    al[j] = sh ? (raw[j] >> sh) | (raw[j + 1] << (32 - sh)) : raw[j];
}

// Rows [r0, r1) of the stream at byte `base` of the lane: each row's
// residue to red[r * red_stride], the row's bytes inside the stream times
// its powers, one `%`.  A row's segment words are loaded together, so a
// row costs one memory latency, not one a word.  Acc is uint32_t when every
// row is an index row (the caller checks bpi * 255 * (d - 1) < 2^32),
// uint64_t with magnitude rows (any bound below 2^24).
template <typename Acc>
FCT_HD void reduce_rows(const uint32_t* words, int64_t ld, int64_t n_words, int64_t base,
                        const DecodeGeom& g, const uint32_t* table, int r0, int r1,
                        uint32_t* red, int red_stride) {
  for (int r = r0; r < r1; ++r) {
    const int64_t start = row_start(g, r);
    const int64_t left = g.n_bytes - start;  // rows past the end read 0
    const int width = row_width(g, r);
    const int avail = left <= 0 ? 0 : (left < width ? (int)left : width);
    const uint32_t* P = table + row_table_offset(g, r);
    Acc acc = 0;
    for (int s0 = 0; s0 < avail; s0 += 4 * kSegWords) {
      uint32_t al[kSegWords];
      load_segment(words, ld, n_words, base + start + s0, al);
      const int n = avail - s0;
#pragma unroll
      for (int k = 0; k < 4 * kSegWords; ++k)
        if (k < n) acc += (Acc)((al[k >> 2] >> (8 * (k & 3))) & 0xffu) * P[s0 + k];
    }
    red[r * red_stride] = (uint32_t)(acc % row_modulus(g, r));
  }
}

// The signum bits: the big-endian integer over the nb (<= 8) signum bytes.
FCT_HD uint64_t signum_bits(const uint32_t* words, int64_t ld, int64_t n_words, int64_t base,
                            const DecodeGeom& g) {
  uint32_t al[kSegWords];
  load_segment(words, ld, n_words, base, al);
  uint64_t s = 0;
  for (int q = 0; q < g.nb; ++q) s = (s << 8) | ((al[q >> 2] >> (8 * (q & 3))) & 0xffu);
  return s;
}

// Coefficient of live slot m: sign bit m, times (magnitude + 1) when the
// bound is not 1.
FCT_HD int32_t slot_value(uint64_t sbits, const uint32_t* red, int red_stride,
                          const DecodeGeom& g, int m) {
  const int32_t sign = ((sbits >> m) & 1u) ? 1 : -1;
  return g.nmag ? sign * (int32_t)(red[m * red_stride] + 1u) : sign;
}

// The placement of one stream (w <= 64): row[i] for every i < d.
template <typename T>
FCT_HD void place_stream(uint64_t sbits, const uint32_t* red, int red_stride,
                         const DecodeGeom& g, T* row) {
  uint64_t hit = 0;
  for (int t = 0; t < g.S; ++t) {
    const uint32_t j = red[(g.nmag + t) * red_stride];
    int32_t v = 0;
    if (j < (uint32_t)g.w && !((hit >> j) & 1u)) {
      hit |= 1ull << j;
      v = slot_value(sbits, red, red_stride, g, (int)j);
    }
    row[g.d - 1 - t] = (T)v;
  }
  for (int m = 0; m <= g.w && m < g.d; ++m)
    row[m] = (T)(m < g.w && !((hit >> m) & 1u) ? slot_value(sbits, red, red_stride, g, m) : 0);
}

// Rows that start inside the stream (the rest read 0): rows are contiguous,
// so the first L of them.
FCT_HD int live_rows(const DecodeGeom& g) {
  const int R = g.nmag + g.S;
  int lo = 0, hi = R;  // the first row starting at or past n_bytes
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_start(g, mid) < g.n_bytes) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Share c of `chunks` of the rows, [r[0], r[1]) of the live rows and
// [r[2], r[3]) of the rest: every share reads about as many bytes (an alpha
// stream's 60 live rows of its 195 are spread over all the warps).
FCT_HD void chunk_rows(const DecodeGeom& g, int live, int c, int chunks, int* r) {
  const int dead = g.nmag + g.S - live;
  r[0] = (int)((int64_t)live * c / chunks);
  r[1] = (int)((int64_t)live * (c + 1) / chunks);
  r[2] = live + (int)((int64_t)dead * c / chunks);
  r[3] = live + (int)((int64_t)dead * (c + 1) / chunks);
}

// One share of a stream's rows into red (see reduce_rows).
FCT_HD void reduce_share(const uint32_t* words, int64_t ld, int64_t n_words, int64_t base,
                         const DecodeGeom& g, const uint32_t* table, const int* r,
                         uint32_t* red, int red_stride) {
  for (int h = 0; h < 4; h += 2) {
    if (g.nmag)
      reduce_rows<uint64_t>(words, ld, n_words, base, g, table, r[h], r[h + 1], red,
                            red_stride);
    else
      reduce_rows<uint32_t>(words, ld, n_words, base, g, table, r[h], r[h + 1], red,
                            red_stride);
  }
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(kDecodeLanes * kDecodeChunks)
xof_decode_kernel(const uint32_t* __restrict__ words, int64_t n_words, int64_t lanes,
                  int n_streams, DecodeGeom g, const uint32_t* __restrict__ table,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int R = g.nmag + g.S;
  const int tstride = (int)(sizeof(T) == 1 ? g.d + 4 : g.d + 1);  // odd word stride
  uint32_t* red = smem;  // [R][kDecodeLanes]
  T* tile = reinterpret_cast<T*>(smem + (int64_t)R * kDecodeLanes);  // [kDecodeLanes][tstride]
  const int lane = threadIdx.x, c = threadIdx.y;
  const int64_t g0 = (int64_t)blockIdx.x * kDecodeLanes;
  const int64_t gl = g0 + lane;
  const int k = blockIdx.y;
  const int64_t base = (int64_t)k * g.n_bytes;
  const bool live = gl < lanes;
  if (live) {
    int r[4];
    chunk_rows(g, live_rows(g), c, kDecodeChunks, r);
    reduce_share(words + gl, lanes, n_words, base, g, table, r, red + lane, kDecodeLanes);
  }
  __syncthreads();
  if (c == 0 && live) {
    const uint64_t sbits = signum_bits(words + gl, lanes, n_words, base, g);
    place_stream<T>(sbits, red + lane, kDecodeLanes, g, tile + (int64_t)lane * tstride);
  }
  __syncthreads();
  // warp c writes rows c, c + kDecodeChunks, ..., each as consecutive words
  const int n_live = (int)(lanes - g0 < kDecodeLanes ? lanes - g0 : kDecodeLanes);
  for (int s = c; s < n_live; s += kDecodeChunks) {
    int32_t* row = out + ((g0 + s) * n_streams + k) * g.d;
    for (int i = lane; i < g.d; i += kDecodeLanes) row[i] = (int32_t)tile[s * tstride + i];
  }
}

template <typename T>
int launch_decode(const uint32_t* words, int64_t n_words, int64_t lanes, int n_streams,
                  const DecodeGeom& g, const uint32_t* table, int32_t* out,
                  cudaStream_t stream) {
  const int tstride = (int)(sizeof(T) == 1 ? g.d + 4 : g.d + 1);
  const size_t smem = (size_t)(g.nmag + g.S) * kDecodeLanes * sizeof(uint32_t) +
                      (size_t)kDecodeLanes * tstride * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        xof_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)((lanes + kDecodeLanes - 1) / kDecodeLanes), (unsigned)n_streams);
  xof_decode_kernel<T><<<grid, dim3(kDecodeLanes, kDecodeChunks), smem, stream>>>(
      words, n_words, lanes, n_streams, g, table, out);
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): words u32[n_words, lanes], each lane
// carrying n_streams streams n_bytes apart; the geometry (degree d, weight
// bound w <= 64, signum bytes nb, magnitude block bpc, index row bpi,
// bound); table u32 (xof_decode._kernel_table: the magnitude rows' powers
// when bound != 1, then the index rows'); out int32[lanes * n_streams, d].
// Returns a cudaError_t.
extern "C" int fct_xof_decode(const uint32_t* words, int64_t n_words, int64_t lanes,
                              int n_streams, int d, int w, int nb, int bpc, int bpi,
                              int n_bytes, uint32_t bound, const uint32_t* table, int32_t* out,
                              void* stream) {
  if (lanes <= 0 || n_streams <= 0) return 0;
  if (w < 1 || w > 64 || w > d) return (int)cudaErrorInvalidValue;
  const DecodeGeom g = make_decode_geom(d, w, nb, bpc, bpi, n_bytes, bound);
  const cudaStream_t s = (cudaStream_t)stream;
  return bound == 1u ? launch_decode<int8_t>(words, n_words, lanes, n_streams, g, table, out, s)
                     : launch_decode<int32_t>(words, n_words, lanes, n_streams, g, table, out, s);
}
#endif
