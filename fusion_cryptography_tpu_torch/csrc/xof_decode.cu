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
// d - t.  A row cut by the stream's ``n_bytes`` reads a shorter integer: the
// power table P[row, k] = 256^(avail-1-k) mod m (k < avail, else 0) carries
// that.  Rows that start past the end read 0; they are index rows only
// (n_bytes >= min_bytes keeps every magnitude row and w index rows inside).
//
// Placement, the closed form of the partial Fisher-Yates: live slot m < w
// moves to d-1-t at the first swap t whose index is m, else stays at m, so
// row d-1-t holds value m at that first hit and 0 otherwise, and rows 0..w
// hold the values never hit.
//
// Layout: words u32[W, L] batch minor (byte j of a lane is byte j%4 of word
// j/4), L lanes each carrying n_streams streams n_bytes apart (stream k of
// lane g starts at byte k*n_bytes, any alignment: the group stage's blob
// read in place, without split_streams_w's realignment); output int32
// rows [L * n_streams, d], row g*n_streams + k, the layout the NTT takes.
//
// What bounds it: bytes.  A stream's live rows are read once (8,423 bytes a
// challenge stream at secpar=256, 3,968 an alpha stream) and d int32 are
// written.  The earlier design (one warp placing its block's 32 streams
// alone while seven waited, one multiply-add, one table load and an
// extract a byte, every dead row still reduced, 1.3 waves) took ~0.18 ms
// at the challenge launch and ~0.10 ms at the alphas'; this design takes
// ~0.12 and ~0.05 ms, 1.6x and 1.7x the bytes' bound (python -m
// fusion_cryptography_tpu_torch.glue_ab against the earlier commit;
// NVIDIA H100 80GB HBM3, 700 W).  So:
// * A block takes 32 consecutive lanes (one stream each: threadIdx.x) and
//   splits the rows that start inside the stream evenly over kDecodeWarps
//   warps (threadIdx.y): a warp reads one word of 32 neighbouring lanes at a
//   time, a 128-byte line, and its control flow is uniform.  A row's words
//   are loaded together and realigned with funnel shifts (one memory wait a
//   row; loading the next row's words before reducing a row ran slower at
//   the 64 registers one wave allows).  Rows past the stream's end are
//   neither loaded nor reduced.
// * Four bytes a dp4a: the powers are below the row's modulus, so a table
//   word packs four of them as bytes (planes = 1 when every modulus is at
//   most 256, the shipped parameter sets; else three byte planes of each
//   power, shifted together once a row).  The live rows' table is staged in
//   shared memory once a block and read as broadcasts.
// * Placement over every warp, no chain across the stream: while it reduces
//   its rows in order, each thread keeps a 64-bit mask of the slots its own
//   share hit (w <= 64) and records for each index row whether it is the
//   first hit of its slot within the share.  After one barrier a row's
//   first hit across the stream is its share's first hit that no earlier
//   share's mask holds (a prefix OR over at most kDecodeWarps masks), and
//   the slots 0..w read the OR of all of them.  The rows past the end read
//   index 0: the first of them takes slot 0 iff no live row hit it, the
//   rest are 0.  A mask walk rather than shared-memory atomicMin of a first
//   hit per slot: the masks are private registers, written to shared memory
//   once ([warp][lane], no bank conflict), where atomics on [lane][slot]
//   would collide in banks whenever two lanes' indices agree mod 32.
// * Each thread writes its share's coefficients into the block's tile (int8
//   when the bound is 1, odd word stride: no bank conflict), which aliases
//   the staged table; after a second barrier the block stores the 32 rows of
//   d coefficients coalesced.
// * One wave: blocks of 4 warps use <= 16 KB of shared memory and at most 64
//   registers a thread (__launch_bounds__), so the 1,024 blocks of either
//   verify launch fit 8 a SM on 132 SMs.
//
// Without nvcc the per-thread functions compile as plain C++ (FCT_HD is
// `static inline`); tests/test_torch_glue_kernels.py runs them with a
// serial loop in place of the grid, the warps' shares in turn.
#include "preimage_ops.cuh"  // FCT_HD

#ifdef __CUDACC__
#define FCT_HOST_HD __host__ __device__ __forceinline__
#else
#define FCT_HOST_HD static inline
#endif

namespace {

constexpr int kDecodeLanes = 32;  // lanes (streams) a block
constexpr int kDecodeWarps = 4;   // warps a block, each a share of the rows
constexpr int kDecodeBlocksPerSM = 8;
constexpr int kSegWords = 9;      // a row is read in segments of 36 bytes
constexpr uint8_t kNoHit = 0xff;  // an index row that is no first hit in its share

// The static layout of one decoded stream (xof_decode.DecodeGeometry).
struct DecodeGeom {
  int d, w, S;         // degree, weight bound, swaps d-1-w (or 0)
  int nb, bpc, bpi;    // signum bytes, bytes a magnitude block, an index row
  int nmag;            // magnitude rows read: w when bound != 1, else 0
  int n_bytes;         // a stream's logical length
  uint32_t bound;
  int planes;          // byte planes of each power in the table: 1 or 3
  int live;            // rows (magnitudes, then index rows) starting inside the stream
  int T;               // of them index rows: swaps 0..T-1 read the stream
};

// First byte of row r (rows 0..nmag-1 magnitudes, then the index rows).
FCT_HOST_HD int64_t row_start(const DecodeGeom& g, int r) {
  const int64_t index_off = (int64_t)g.nb + (int64_t)g.w * g.bpc;
  return r < g.nmag ? (int64_t)g.nb + (int64_t)r * g.bpc
                    : index_off + (int64_t)(r - g.nmag) * g.bpi;
}

FCT_HOST_HD int row_width(const DecodeGeom& g, int r) { return r < g.nmag ? g.bpc : g.bpi; }

FCT_HOST_HD uint32_t row_modulus(const DecodeGeom& g, int r) {
  return r < g.nmag ? g.bound : (uint32_t)(g.d - (r - g.nmag));
}

// Words of row r's packed powers: its table words (ceil(width / 4)), each
// `planes` words.
FCT_HOST_HD int64_t row_table_offset(const DecodeGeom& g, int r) {
  const int64_t wpc = (g.bpc + 3) / 4, wpi = (g.bpi + 3) / 4;
  return (r < g.nmag ? (int64_t)r * wpc : (int64_t)g.nmag * wpc + (int64_t)(r - g.nmag) * wpi) *
         g.planes;
}

FCT_HOST_HD DecodeGeom make_decode_geom(int d, int w, int nb, int bpc, int bpi, int n_bytes,
                                        uint32_t bound, int planes) {
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
  g.planes = planes;
  int lo = 0, hi = g.nmag + g.S;  // rows are contiguous: the first starting at or past n_bytes
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_start(g, mid) < n_bytes) lo = mid + 1; else hi = mid;
  }
  g.live = lo;
  g.T = lo - g.nmag;
  return g;
}

// Share c of `parts` of [0, n): [lo, hi).
FCT_HOST_HD void share(int n, int c, int parts, int& lo, int& hi) {
  lo = (int)((int64_t)n * c / parts);
  hi = (int)((int64_t)n * (c + 1) / parts);
}

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

// sum over the four bytes of a and b of their products, plus c (dp4a).
FCT_HD uint32_t dot4(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  return __dp4a(a, b, c);
#else
  for (int s = 0; s < 32; s += 8) c += ((a >> s) & 0xffu) * ((b >> s) & 0xffu);
  return c;
#endif
}

// Live row r of the stream at byte `base` of the lane, reduced mod its
// modulus: its bytes inside the stream dotted with its packed powers (P's
// bytes past `avail` and past the row are 0).  NP byte planes: each plane's
// sum stays below 2^32 (width * 255 * 255); with NP = 1 the sum itself is
// below bpi * 255 * (d - 1) < 2^32 (checked by the caller).
template <int NP>
FCT_HD uint32_t reduce_row(const uint32_t* words, int64_t ld, int64_t n_words, int64_t base,
                           const DecodeGeom& g, const uint32_t* table, int r) {
  const int64_t start = row_start(g, r);
  const int64_t left = g.n_bytes - start;
  const int width = row_width(g, r);
  const int avail = left < width ? (int)left : width;
  const uint32_t* P = table + row_table_offset(g, r);
  uint32_t acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0;
  for (int s0 = 0; s0 < avail; s0 += 4 * kSegWords) {
    uint32_t al[kSegWords];
    load_segment(words, ld, n_words, base + start + s0, al);
    const int n = avail - s0;
    const uint32_t* Ps = P + (s0 / 4) * NP;
#pragma unroll
    for (int j = 0; j < kSegWords; ++j)
      if (4 * j < n) {
#pragma unroll
        for (int p = 0; p < NP; ++p) acc[p] = dot4(al[j], Ps[j * NP + p], acc[p]);
      }
  }
  const uint32_t m = row_modulus(g, r);
  if (NP == 1) return acc[0] % m;
  uint64_t v = 0;
#pragma unroll
  for (int p = 0; p < NP; ++p) v += (uint64_t)acc[p] << (8 * p);
  return (uint32_t)(v % m);
}

// One thread's share [r0, r1) of a stream's live rows, in order: a
// magnitude row's residue to mag[r * stride]; for index row t its index j
// to first[t * stride] when j < w and no earlier row of the share hit j,
// else kNoHit.  Returns the share's hit mask.
template <int NP>
FCT_HD uint64_t reduce_share(const uint32_t* words, int64_t ld, int64_t n_words, int64_t base,
                             const DecodeGeom& g, const uint32_t* table, int r0, int r1,
                             uint32_t* mag, uint8_t* first, int stride) {
  uint64_t hit = 0;
  for (int r = r0; r < r1; ++r) {
    const uint32_t v = reduce_row<NP>(words, ld, n_words, base, g, table, r);
    if (r < g.nmag) {
      mag[r * stride] = v;
      continue;
    }
    const bool fresh = v < (uint32_t)g.w && !((hit >> v) & 1u);
    if (fresh) hit |= 1ull << v;
    first[(r - g.nmag) * stride] = fresh ? (uint8_t)v : kNoHit;
  }
  return hit;
}

// The signum bits: the big-endian integer over the nb (<= 8) signum bytes
// at byte `base` of the lane (three words cover them at any alignment).
FCT_HD uint64_t signum_bits(const uint32_t* words, int64_t ld, int64_t n_words, int64_t base,
                            const DecodeGeom& g) {
  const int64_t w0 = base >> 2;
  const int sh = 8 * (int)(base & 3);
  const uint32_t r0 = load_word(words, ld, n_words, w0), r1 = load_word(words, ld, n_words, w0 + 1),
                 r2 = load_word(words, ld, n_words, w0 + 2);
  uint64_t a = ((uint64_t)r1 << 32) | r0;
  if (sh) a = (a >> sh) | ((uint64_t)r2 << (64 - sh));
  uint64_t s = 0;
  for (int q = 0; q < g.nb; ++q) s = (s << 8) | ((a >> (8 * q)) & 0xffu);
  return s;
}

// Coefficient of live slot m: sign bit m, times (magnitude + 1) when the
// bound is not 1.
FCT_HD int32_t slot_value(uint64_t sbits, const uint32_t* mag, int stride, const DecodeGeom& g,
                          int m) {
  const int32_t sign = ((sbits >> m) & 1u) ? 1 : -1;
  return g.nmag ? sign * (int32_t)(mag[m * stride] + 1u) : sign;
}

// One thread's part of a stream's row, after every share's mask is known:
// the index rows of its share [r0, r1) (row d-1-t holds the value of
// first[t] unless an earlier share hit that slot: `before`), and its part
// [i0, i1) of rows 0 .. d-1-T: the slots (value unless any swap hit it:
// `all`, and slot 0 when a swap reads past the end), row w (0), and the
// rows of the swaps past the end (the first takes slot 0 iff no live swap
// hit it, the rest 0).
template <typename T>
FCT_HD void fill_share(uint64_t sbits, const uint32_t* mag, const uint8_t* first, int stride,
                       const DecodeGeom& g, int r0, int r1, int i0, int i1, uint64_t before,
                       uint64_t all, T* row) {
  for (int r = r0 > g.nmag ? r0 : g.nmag; r < r1; ++r) {
    const int t = r - g.nmag;
    const uint32_t j = first[t * stride];
    row[g.d - 1 - t] =
        (T)(j != kNoHit && !((before >> j) & 1u) ? slot_value(sbits, mag, stride, g, (int)j) : 0);
  }
  const bool dead = g.T < g.S;  // swaps T..S-1 read index 0
  const uint64_t taken = all | (dead ? 1ull : 0ull);
  for (int i = i0; i < i1; ++i) {
    int32_t v = 0;
    if (i < g.w)
      v = (taken >> i) & 1u ? 0 : slot_value(sbits, mag, stride, g, i);
    else if (dead && i == g.d - 1 - g.T)
      v = (all & 1u) ? 0 : slot_value(sbits, mag, stride, g, 0);
    row[i] = (T)v;
  }
}

// Elements of a row of the block's tile: an odd number of words.
template <typename T>
FCT_HOST_HD int tile_stride(int d) {
  return sizeof(T) == 1 ? 4 * (((d + 3) / 4) | 1) : (d | 1);
}

// Dynamic shared memory of a block: hit masks [warps][32] and signum bits
// [32] (u64), magnitudes [nmag][32] (u32), the live rows' table or the
// tile, first hits [T][32] (u8).
struct DecodeSmem {
  int64_t mag, tab, first, total;  // byte offsets
};

template <typename T>
FCT_HOST_HD DecodeSmem decode_smem(const DecodeGeom& g) {
  DecodeSmem s;
  s.mag = 8 * (int64_t)(kDecodeWarps + 1) * kDecodeLanes;
  s.tab = s.mag + 4 * (int64_t)g.nmag * kDecodeLanes;
  const int64_t tab = 4 * row_table_offset(g, g.live);
  const int64_t tile = (int64_t)kDecodeLanes * tile_stride<T>(g.d) * sizeof(T);
  s.first = s.tab + ((tab > tile ? tab : tile) + 15) / 16 * 16;
  s.total = s.first + (int64_t)g.T * kDecodeLanes;
  return s;
}

#ifdef __CUDACC__
template <typename T, int NP>
__global__ void __launch_bounds__(kDecodeLanes * kDecodeWarps, kDecodeBlocksPerSM)
xof_decode_kernel(const uint32_t* __restrict__ words, int64_t n_words, int64_t lanes,
                  int n_streams, DecodeGeom g, const uint32_t* __restrict__ table,
                  int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint64_t smem[];
  const DecodeSmem L = decode_smem<T>(g);
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem);
  uint64_t* hits = smem;                           // [kDecodeWarps][kDecodeLanes]
  uint64_t* sgn = smem + kDecodeWarps * kDecodeLanes;  // [kDecodeLanes]
  uint32_t* mag = reinterpret_cast<uint32_t*>(bytes + L.mag);
  uint32_t* tab = reinterpret_cast<uint32_t*>(bytes + L.tab);
  T* tile = reinterpret_cast<T*>(bytes + L.tab);   // after the first barrier
  uint8_t* first = bytes + L.first;
  const int lane = threadIdx.x, c = threadIdx.y;
  const int tstride = tile_stride<T>(g.d);
  const int n_tab = (int)row_table_offset(g, g.live);
  for (int i = c * kDecodeLanes + lane; i < n_tab; i += kDecodeLanes * kDecodeWarps)
    tab[i] = table[i];
  __syncthreads();
  const int64_t g0 = (int64_t)blockIdx.x * kDecodeLanes;
  const int64_t gl = g0 + lane;
  const int k = blockIdx.y;
  const int64_t base = (int64_t)k * g.n_bytes;
  const bool live = gl < lanes;
  int r0, r1, i0, i1;
  share(g.live, c, kDecodeWarps, r0, r1);
  share(g.d - g.T, c, kDecodeWarps, i0, i1);
  uint64_t hit = 0;
  if (live) {
    hit = reduce_share<NP>(words + gl, lanes, n_words, base, g, tab, r0, r1, mag + lane,
                           first + lane, kDecodeLanes);
    if (c == 0) sgn[lane] = signum_bits(words + gl, lanes, n_words, base, g);
  }
  hits[c * kDecodeLanes + lane] = hit;
  __syncthreads();
  if (live) {
    uint64_t before = 0, all = 0;
#pragma unroll
    for (int c2 = 0; c2 < kDecodeWarps; ++c2) {
      const uint64_t h = hits[c2 * kDecodeLanes + lane];
      before |= c2 < c ? h : 0ull;
      all |= h;
    }
    fill_share<T>(sgn[lane], mag + lane, first + lane, kDecodeLanes, g, r0, r1, i0, i1, before,
                  all, tile + (int64_t)lane * tstride);
  }
  __syncthreads();
  // warp c stores rows c, c + kDecodeWarps, ..., each as consecutive words
  const int n_live = (int)(lanes - g0 < kDecodeLanes ? lanes - g0 : kDecodeLanes);
  for (int s = c; s < n_live; s += kDecodeWarps) {
    int32_t* row = out + ((g0 + s) * n_streams + k) * g.d;
    for (int i = lane; i < g.d; i += kDecodeLanes) row[i] = (int32_t)tile[s * tstride + i];
  }
}

template <typename T, int NP>
cudaError_t launch_decode(const uint32_t* words, int64_t n_words, int64_t lanes, int n_streams,
                          const DecodeGeom& g, const uint32_t* table, int32_t* out,
                          cudaStream_t stream, int32_t* shape) {
  const size_t smem = (size_t)decode_smem<T>(g).total;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        xof_decode_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  const dim3 grid((unsigned)((lanes + kDecodeLanes - 1) / kDecodeLanes), (unsigned)n_streams);
  const dim3 block(kDecodeLanes, kDecodeWarps);
  if (shape) {  // the launch's shape, not the launch
    cudaFuncAttributes attr;
    cudaError_t rc = cudaFuncGetAttributes(&attr, xof_decode_kernel<T, NP>);
    int per_sm = 0;
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, xof_decode_kernel<T, NP>,
                                                         block.x * block.y, smem);
    shape[0] = (int32_t)(grid.x * grid.y);
    shape[1] = (int32_t)(block.x * block.y);
    shape[2] = (int32_t)smem;
    shape[3] = attr.numRegs;
    shape[4] = per_sm;
    return rc;
  }
  xof_decode_kernel<T, NP><<<grid, block, smem, stream>>>(words, n_words, lanes, n_streams, g,
                                                          table, out);
  return cudaGetLastError();
}

int decode_entry(const uint32_t* words, int64_t n_words, int64_t lanes, int n_streams, int d,
                 int w, int nb, int bpc, int bpi, int n_bytes, uint32_t bound,
                 const uint32_t* table, int planes, int32_t* out, void* stream,
                 int32_t* shape) {
  if (lanes <= 0 || n_streams <= 0) return 0;
  if (w < 1 || w > 64 || w > d || (planes != 1 && planes != 3)) return (int)cudaErrorInvalidValue;
  const DecodeGeom g = make_decode_geom(d, w, nb, bpc, bpi, n_bytes, bound, planes);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bound == 1u)
    return (int)(planes == 1
                     ? launch_decode<int8_t, 1>(words, n_words, lanes, n_streams, g, table, out, s, shape)
                     : launch_decode<int8_t, 3>(words, n_words, lanes, n_streams, g, table, out, s, shape));
  return (int)(planes == 1
                   ? launch_decode<int32_t, 1>(words, n_words, lanes, n_streams, g, table, out, s, shape)
                   : launch_decode<int32_t, 3>(words, n_words, lanes, n_streams, g, table, out, s, shape));
}
#endif

}  // namespace

#ifdef __CUDACC__
// C entry point (bound with ctypes): words u32[n_words, lanes], each lane
// carrying n_streams streams n_bytes apart; the geometry (degree d, weight
// bound w <= 64, signum bytes nb, magnitude block bpc, index row bpi,
// bound); table u32 (xof_decode._kernel_table: each row's powers packed
// four to a word in `planes` byte planes, the magnitude rows when bound !=
// 1, then the index rows); out int32[lanes * n_streams, d].  Returns a
// cudaError_t.
extern "C" int fct_xof_decode(const uint32_t* words, int64_t n_words, int64_t lanes,
                              int n_streams, int d, int w, int nb, int bpc, int bpi,
                              int n_bytes, uint32_t bound, const uint32_t* table, int planes,
                              int32_t* out, void* stream) {
  return decode_entry(words, n_words, lanes, n_streams, d, w, nb, bpc, bpi, n_bytes, bound,
                      table, planes, out, stream, nullptr);
}

// The launch fct_xof_decode would make for these arguments, not made:
// shape = [blocks, threads a block, dynamic shared bytes, registers a
// thread, blocks an SM can hold].  Returns a cudaError_t.
extern "C" int fct_xof_decode_shape(int64_t lanes, int n_streams, int d, int w, int nb, int bpc,
                                    int bpi, int n_bytes, uint32_t bound, int planes,
                                    int32_t* shape) {
  return decode_entry(nullptr, 0, lanes, n_streams, d, w, nb, bpc, bpi, n_bytes, bound, nullptr,
                      planes, nullptr, nullptr, shape);
}
#endif
