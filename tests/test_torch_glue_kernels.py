"""The verify path's glue kernels (XOF decode, prehash render, lattice
target), compiled for the host CPU, against their plain torch versions and
the JAX package's functions.

``csrc/xof_decode.cu``, ``csrc/render_prehash.cu`` and
``csrc/lattice_target.cu`` keep their per-lane work in functions that also
compile as plain C++ (``FCT_HD`` is ``static inline`` without nvcc; the
decode's dp4a is a byte loop there).  These tests build them with the host
compiler, with a serial loop in place of the grid: the decode's live rows
split into the shares of the kernel's 4 warps, of 1 and of 3 (and 8 on the
crafted streams), each share reduced and walked with its own hit mask,
then each share's part of the row filled from the masks of the shares
before it and of all, as the block does after its barrier; the render's
branch-free lane; the lattice check's 32 lanes of a group in turn, their
votes and maxima reduced as the warp reduces them.  The same inputs, made
from a numpy seed (or crafted so that first hits fall on share edges),
go through the plain version and the JAX function.  The launches
themselves run only on the card (tests/test_torch_cuda_kernels.py, marked
``cuda``)."""
import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fusion_cryptography_tpu as ftpu
from fusion_cryptography_tpu.hashing import decode as host_decode
from fusion_cryptography_tpu.hashing.xof import agg_block_len, challenge_xof_len
from fusion_cryptography_tpu.ops import field as jf
from fusion_cryptography_tpu.ops import ragged_words as jrw
from fusion_cryptography_tpu.ops import xof_decode as jxd
from fusion_cryptography_tpu_torch.ops import ragged_words as trw
from fusion_cryptography_tpu_torch.ops import xof_decode as txd
from fusion_cryptography_tpu_torch.ops.field import get_field
from fusion_cryptography_tpu_torch.ops.lattice_target import (lattice_split, lattice_target,
                                                              lattice_target_plain)

CSRC = Path(__file__).resolve().parents[1] / "fusion_cryptography_tpu_torch" / "csrc"
Q = 2147465729
# warps a block the host model runs: the kernel's, one, an odd count
SHARES = txd.CRAFTED_SHARES[:3]

HOST_LOOPS = r"""
#include <algorithm>
#include <vector>

#include "xof_decode.cu"
#include "render_prehash.cu"
#include "lattice_target.cu"

// Every stream of every lane as a block of `warps` warps runs it: each
// warp's share of the live rows reduced and walked (its hit mask), then each
// share's part of the row filled from the masks of the shares before it and
// of all; every magnitude, first-hit entry and tile byte read must have
// been written (they start as marks no decode writes).
extern "C" void host_xof_decode(const uint32_t* words, int64_t n_words, int64_t lanes,
                                int n_streams, int d, int w, int nb, int bpc, int bpi,
                                int n_bytes, uint32_t bound, const uint32_t* table, int planes,
                                int32_t* out, int warps) {
  const DecodeGeom g = make_decode_geom(d, w, nb, bpc, bpi, n_bytes, bound, planes);
  std::vector<uint32_t> mag(g.nmag + 1);
  std::vector<uint8_t> first(g.T + 1);
  std::vector<uint64_t> hits(warps);
  std::vector<int8_t> tile(d);
  for (int64_t gl = 0; gl < lanes; ++gl) {
    for (int k = 0; k < n_streams; ++k) {
      const int64_t base = (int64_t)k * n_bytes;
      std::fill(mag.begin(), mag.end(), 0x7fffffffu);
      std::fill(first.begin(), first.end(), (uint8_t)0x5a);
      std::fill(tile.begin(), tile.end(), (int8_t)99);
      int32_t* row = out + (gl * n_streams + k) * d;
      for (int c = 0; c < warps; ++c) {
        int r0, r1;
        share(g.live, c, warps, r0, r1);
        hits[c] = planes == 1
                      ? reduce_share<1>(words + gl, lanes, n_words, base, g, table, r0, r1,
                                        mag.data(), first.data(), 1)
                      : reduce_share<3>(words + gl, lanes, n_words, base, g, table, r0, r1,
                                        mag.data(), first.data(), 1);
      }
      const uint64_t sbits = signum_bits(words + gl, lanes, n_words, base, g);
      uint64_t all = 0;
      for (int c = 0; c < warps; ++c) all |= hits[c];
      uint64_t before = 0;
      for (int c = 0; c < warps; ++c) {
        int r0, r1, i0, i1;
        share(g.live, c, warps, r0, r1);
        share(g.d - g.T, c, warps, i0, i1);
        if (g.nmag)
          fill_share<int32_t>(sbits, mag.data(), first.data(), 1, g, r0, r1, i0, i1, before, all,
                              row);
        else
          fill_share<int8_t>(sbits, mag.data(), first.data(), 1, g, r0, r1, i0, i1, before, all,
                             tile.data());
        before |= hits[c];
      }
      if (!g.nmag)
        for (int i = 0; i < d; ++i) row[i] = tile[i];
    }
  }
}

extern "C" void host_render_prehash(const uint32_t* digest, int64_t lanes, uint32_t* out,
                                    int32_t* len) {
  for (int64_t b = 0; b < lanes; ++b) len[b] = render_prehash_lane(digest + b, lanes, out + b, lanes);
}

// Each group's 32 lanes in turn, reduced as the warp's vote and max do.
extern "C" void host_lattice_target(const int32_t* vks, const int64_t* c_hat,
                                    const int64_t* alpha, const int64_t* observed,
                                    const int32_t* nrm, const int32_t* wgt, int64_t groups,
                                    int n, int d, int rank, uint32_t q, uint64_t mu,
                                    int64_t beta, int64_t omega, uint8_t* eq,
                                    uint8_t* norm_ok, uint8_t* weight_ok) {
  for (int64_t g = 0; g < groups; ++g) {
    bool e = true;
    int32_t mn = INT32_MIN, mw = INT32_MIN;
    for (int lane = 0; lane < WARP; ++lane) {
      const LatticeLane p = lattice_lane(vks + g * 2 * n * d, c_hat + g * n * d,
                                         alpha + g * n * d, observed + g * d, nrm + g * rank,
                                         wgt + g * rank, n, d, rank, q, mu, lane);
      e = e && p.eq;
      mn = p.nrm > mn ? p.nrm : mn;
      mw = p.wgt > mw ? p.wgt : mw;
    }
    eq[g] = e;
    norm_ok[g] = (int64_t)mn <= beta;
    weight_ok[g] = (int64_t)mw <= omega;
  }
}

// The split check: every (slice, group) warp's 32 lanes of the first
// launch into ``partial`` (pre-filled with marks by the caller), then each
// group's block of the second: every coefficient's sum, the vote, warp 0's
// limits.
extern "C" void host_lattice_target_split(const int32_t* vks, const int64_t* c_hat,
                                          const int64_t* alpha, const int64_t* observed,
                                          const int32_t* nrm, const int32_t* wgt,
                                          int64_t groups, int n, int d, int rank, uint32_t q,
                                          uint64_t mu, int64_t beta, int64_t omega,
                                          int slices, uint32_t* partial, uint8_t* eq,
                                          uint8_t* norm_ok, uint8_t* weight_ok) {
  for (int64_t w = 0; w < groups * slices; ++w) {
    const int64_t g = w % groups;
    for (int lane = 0; lane < WARP; ++lane)
      partial_lane(vks + g * 2 * n * d, c_hat + g * n * d, alpha + g * n * d, n, d, q, mu,
                   slices, (int)(w / groups), partial + w * d, lane);
  }
  for (int64_t g = 0; g < groups; ++g) {
    bool e = true;
    for (int i = 0; i < d; ++i)
      e = e && (int64_t)combine_coef(partial + g * d, groups * d, slices, q, i) ==
                   observed[g * d + i];
    int32_t mn = INT32_MIN, mw = INT32_MIN;
    for (int lane = 0; lane < WARP; ++lane) {
      LatticeLane p;
      limits_lane(p, nrm + g * rank, wgt + g * rank, rank, lane);
      mn = p.nrm > mn ? p.nrm : mn;
      mw = p.wgt > mw ? p.wgt : mw;
    }
    eq[g] = e;
    norm_ok[g] = (int64_t)mn <= beta;
    weight_ok[g] = (int64_t)mw <= omega;
  }
}

// The signers [k0, k1) of each slice, concatenated: 2 * slices ints.
extern "C" void host_slice_signers(int n, int slices, int32_t* out) {
  for (int s = 0; s < slices; ++s) slice_signers(n, slices, s, out[2 * s], out[2 * s + 1]);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("glue_host")
    src = out / "glue_loops.cpp"
    src.write_text(HOST_LOOPS)
    so = out / "libglue_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I32, I64, U32, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32,
                             ctypes.c_uint64)
    lib.host_xof_decode.argtypes = [P, I64, I64, I32, I32, I32, I32, I32, I32, I32, U32, P, I32,
                                    P, I32]
    lib.host_render_prehash.argtypes = [P, I64, P, P]
    lib.host_lattice_target.argtypes = [P, P, P, P, P, P, I64, I32, I32, I32, U32, U64, I64,
                                        I64, P, P, P]
    lib.host_lattice_target_split.argtypes = [P, P, P, P, P, P, I64, I32, I32, I32, U32, U64,
                                              I64, I64, I32, P, P, P, P]
    lib.host_slice_signers.argtypes = [I32, I32, P]
    return lib


# ---------------------------------------------------------------------------
# XOF decode
# ---------------------------------------------------------------------------


def _geometry(secpar, which):
    """(geometry tuple, the pipeline's stream length) of the challenge
    ("ch") or alpha ("ag") decode at ``secpar``."""
    p = ftpu.fusion_setup(secpar, 1)
    beta, omega = (p.beta_ch, p.omega_ch) if which == "ch" else (p.beta_ag, p.omega_ag)
    geo = (p.secpar, p.modulus, p.degree, max(1, min(Q // 2, beta)), omega)
    if which == "ch":
        n = challenge_xof_len(p.secpar, p.degree, p.modulus, p.beta_ch, p.omega_ch)
        return geo, txd.consumed_bytes(txd.geometry(*geo), n)
    return geo, agg_block_len(p.secpar, p.degree, p.modulus, p.beta_ag, p.omega_ag)


def _streams(seed, n_bytes, n_streams, L):
    """Random words u32[W, L] carrying n_streams streams of n_bytes a lane,
    plus one spare word (bytes past the streams must not be read)."""
    W = -(-n_streams * n_bytes // 4) + 1
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(W, L), dtype=np.uint64).astype(np.uint32)


def _host_decode(lib, words, tg, n_bytes, n_streams, warps):
    table, planes = txd._kernel_table(tg, n_bytes, "cpu")
    W, L = words.shape
    out = np.full((L * n_streams, tg.degree), -7, np.int32)
    lib.host_xof_decode(words.ctypes.data, W, L, n_streams, tg.degree, tg.weight_bound,
                        tg.bytes_for_signums, tg.bytes_per_coefficient, tg.bytes_per_index,
                        n_bytes, tg.bound, table.data_ptr(), planes, out.ctypes.data, warps)
    return out


@functools.lru_cache(maxsize=None)
def _jax_decoder(jg, n_bytes, n_streams):
    """The JAX package's split_streams_w + decode_coeffs_w, jitted once per
    (geometry, length, streams a lane)."""
    def run(x):
        if n_streams > 1:
            per = jxd.split_streams_w(x, n_streams, n_bytes)
            x = per.reshape(per.shape[0], -1)
        return jxd.decode_coeffs_w(x, jg, n_bytes)

    return jax.jit(run)


def _jax_rows(words, jg, n_bytes, n_streams):
    """The JAX package's split_streams_w + decode_coeffs_w, as rows."""
    return np.asarray(_jax_decoder(jg, n_bytes, n_streams)(jnp.asarray(words))).T


LANES = 37  # not a multiple of the kernel's 32 lanes a block (the crafted cases' too)

DECODE_CASES = [
    # (secpar, geometry, stream bytes: None = the pipeline's, "min" = min_bytes, streams a lane)
    (128, "ch", None, 1),
    (256, "ch", None, 1),
    (256, "ag", None, 1),   # an alpha stream: 60 whole index rows, swaps 60-194 read j = 0
    (256, "ch", 5000, 1),   # cut 9 bytes into an index row
    (128, "ch", "min", 1),  # at min_bytes: only w index rows
    (256, "ag", "min", 1),
    (128, "ag", None, 3),   # the group stage's blob at secpar=128: streams 1,195 bytes apart
    (256, "ag", None, 4),   # ... at secpar=256: 3,968 bytes apart (word-aligned)
]


@pytest.mark.parametrize("secpar,which,n_bytes,n_streams", DECODE_CASES)
def test_xof_decode_lanes_match_plain_and_jax(lib, secpar, which, n_bytes, n_streams):
    geo, n_pipe = _geometry(secpar, which)
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    n = {None: n_pipe, "min": tg.min_bytes}.get(n_bytes, n_bytes)
    L = LANES
    words = _streams(secpar * 7 + n + n_streams, n, n_streams, L)
    plain = txd.decode_coeffs_rows(torch.from_numpy(words.view(np.int32)), tg, n, n_streams)
    assert plain.dtype == torch.int32 and plain.shape == (L * n_streams, tg.degree)
    want = _jax_rows(words, jg, n, n_streams)
    np.testing.assert_array_equal(plain.numpy(), want)
    for warps in SHARES:
        np.testing.assert_array_equal(_host_decode(lib, words, tg, n, n_streams, warps), want)
    # the reference decoder on a few streams, read at their byte offsets
    by = words.T.copy().view(np.uint8)
    for row in (0, L * n_streams - 1):
        g, k = divmod(row, n_streams)
        stream = by[g, k * n:(k + 1) * n].tobytes()
        np.testing.assert_array_equal(want[row], host_decode.decode_bytes_to_coefficients(
            stream, *geo))
    assert (want != 0).sum(axis=1).tolist() == [tg.weight_bound] * (L * n_streams)


@pytest.mark.parametrize("n_streams", [1, 2])
def test_xof_decode_magnitudes(lib, n_streams):
    """bound > 1 (no shipped parameter set): the magnitude blocks are
    reduced and the kernel's int32 tile holds them; two streams a lane lie
    at an unaligned offset."""
    geo = (128, Q, 64, 5, 27)
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    n = tg.min_bytes + 41
    words = _streams(77 + n_streams, n, n_streams, 5)
    want = _jax_rows(words, jg, n, n_streams)
    plain = txd.decode_coeffs_rows(torch.from_numpy(words.view(np.int32)), tg, n, n_streams)
    np.testing.assert_array_equal(plain.numpy(), want)
    for warps in SHARES:
        np.testing.assert_array_equal(_host_decode(lib, words, tg, n, n_streams, warps), want)
    assert np.abs(want).max() > 1


@pytest.mark.parametrize("n_streams", [1, 2])
def test_xof_decode_wide_rows(lib, n_streams):
    """Index rows and magnitude blocks of 65 bytes (a 512-bit bias), longer
    than the kernel's 36-byte segment: each row read in two segments; the
    stream cut 25 bytes into an index row, two streams a lane 8,809 bytes
    apart (unaligned)."""
    geos = [(512, Q, 256, 1, 60), (512, Q, 64, 5, 20)]
    for geo in geos:
        tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
        assert tg.bytes_per_index > 36
        n = tg.min_bytes + 1001
        words = _streams(geo[2] + n_streams, n, n_streams, 3)
        want = _jax_rows(words, jg, n, n_streams)
        plain = txd.decode_coeffs_rows(torch.from_numpy(words.view(np.int32)), tg, n, n_streams)
        np.testing.assert_array_equal(plain.numpy(), want)
        for warps in SHARES:
            np.testing.assert_array_equal(_host_decode(lib, words, tg, n, n_streams, warps),
                                          want)


CRAFTED_CASES = [
    # (secpar, geometry, stream bytes as in DECODE_CASES, streams a lane)
    (128, "ch", None, 1),
    (256, "ch", None, 1),
    (256, "ag", None, 1),   # 60 live index rows: swaps 60-194 past the end
    (128, "ag", None, 3),   # the blob, unaligned
    (256, "ag", None, 4),
    (256, "ch", 5000, 1),   # the last live row cut
    (128, "ch", "min", 1),  # exactly w live index rows
]


@pytest.mark.parametrize("secpar,which,n_bytes,n_streams", CRAFTED_CASES)
def test_xof_decode_crafted_placement(lib, secpar, which, n_bytes, n_streams):
    """Streams crafted so that first hits fall on the first and last rows of
    the shares, one slot is hit in every share, every slot or none is hit,
    and slot 0 is or is not hit before the rows past the end: the host
    model at every share count, the plain version and JAX agree."""
    geo, n_pipe = _geometry(secpar, which)
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    n = {None: n_pipe, "min": tg.min_bytes}.get(n_bytes, n_bytes)
    words = txd.crafted_streams(tg, n, n_streams, LANES, seed=secpar + n)
    want = _jax_rows(words, jg, n, n_streams)
    plain = txd.decode_coeffs_rows(torch.from_numpy(words.view(np.int32)), tg, n, n_streams)
    np.testing.assert_array_equal(plain.numpy(), want)
    for warps in txd.CRAFTED_SHARES:
        np.testing.assert_array_equal(_host_decode(lib, words, tg, n, n_streams, warps), want)


def test_crafted_streams_follow_their_plans():
    """The crafted streams do what their plans say, read by the reference
    decoder's closed form (JAX): every slot hit leaves rows 0..w-1 zero, no
    slot hit by a live row leaves every swap row zero but the first past the
    end (slot 0's), slot 0 hit on the last live row of
    an alpha stream fills row d-1-59, slot 0 never hit is taken by the first
    swap past the end (row d-1-60), and a slot hit in every share moves
    once."""
    geo, n = _geometry(256, "ag")
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    d, w = tg.degree, tg.weight_bound
    P = len(txd.PLACEMENT_PLANS)
    words = txd.crafted_streams(tg, n, 1, 2 * P, seed=3)
    rows = _jax_rows(words, jg, n, 1)
    for b in (2, 2 + P):
        assert not rows[b, :w].any() and np.count_nonzero(rows[b]) == w
    T = (n - tg.index_stream_offset) // tg.bytes_per_index
    assert T == 60
    for b in (3, 3 + P):  # only the first swap past the end moves a slot: slot 0
        assert np.count_nonzero(rows[b, 1:w]) == w - 1 and rows[b, 0] == 0
        assert np.count_nonzero(rows[b, w:]) == 1 and rows[b, d - 1 - T] != 0
    for b in (4, 4 + P):
        assert rows[b, d - 1 - (T - 1)] != 0 and rows[b, 0] == 0 and rows[b, d - 1 - T] == 0
    for b in (5, 5 + P):
        assert rows[b, 0] == 0 and rows[b, d - 1 - T] != 0
    for b in (0, P):  # slot 1: first hit at swap 0, every later share's hit reads 0
        assert rows[b, d - 1] != 0 and rows[b, 1] == 0 and rows[b, d - 1 - T] != 0
        assert np.count_nonzero(rows[b, w + 1:]) == 2


def test_xof_decode_wide_moduli(lib):
    """Moduli above 256 (a bound of 70,000; no shipped parameter set): the
    power table in three byte planes, each plane summed by its own dp4a and
    the planes shifted together once a row; two streams a lane, unaligned;
    the host model at every share count against JAX and the plain version."""
    geo = (128, Q, 64, 70000, 27)
    tg, jg = txd.geometry(*geo), jxd.geometry(*geo)
    assert txd._planes(tg) == 3
    n = tg.min_bytes + 23
    for n_streams in (1, 2):
        words = _streams(5 + n_streams, n, n_streams, 7)
        want = _jax_rows(words, jg, n, n_streams)
        plain = txd.decode_coeffs_rows(torch.from_numpy(words.view(np.int32)), tg, n, n_streams)
        np.testing.assert_array_equal(plain.numpy(), want)
        for warps in SHARES:
            np.testing.assert_array_equal(_host_decode(lib, words, tg, n, n_streams, warps), want)
        assert np.abs(want).max() > 256


def test_decode_coeffs_w_is_the_rows_transposed():
    geo, n = _geometry(128, "ag")
    tg = txd.geometry(*geo)
    words = torch.from_numpy(_streams(5, n, 2, 9).view(np.int32))
    rows = txd.decode_coeffs_rows(words, tg, n)
    cols = txd.decode_coeffs_w(words, tg, n)
    assert cols.is_contiguous() and torch.equal(cols, rows.t())
    with pytest.raises(ValueError):
        txd.decode_coeffs_rows(words, tg, n, 3)  # three streams do not fit
    with pytest.raises(ValueError):
        txd.decode_coeffs_rows(words, tg, tg.min_bytes - 1)


# ---------------------------------------------------------------------------
# prehash render
# ---------------------------------------------------------------------------

DIGEST_EDGES = [0, 7, 10**9 - 1, 10**9, 10**9 + 1, 10**18, 10**18 - 1, 2**32 - 1, 2**32,
                10**72 - 1, 10**72, 10**76, 10**77 - 1, 10**77, 10**77 + 1, 2**256 - 1,
                2**255, 10**45 + 10**9 - 1]


def _digest_words(values):
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in values],
                    dtype=np.uint64).astype(np.uint32).T.copy()


CHUNK_EDGES = [10**72 + 1, 10**36, 10**45 + 10**9 - 1, 2**256 - 1, 10**77 - 1, 10**72 - 1,
               10**63 + 10**27, 10**9 * (10**9 - 1)]
CHUNK_VALUES = CHUNK_EDGES + [10**e + o for e in range(78) for o in (-1, 0)]


def test_render_prehash_lanes_match_plain_jax_and_str(lib):
    rng = np.random.default_rng(11)
    # as many digests as the chunk-edge test: JAX's eager ops compile once a shape
    n_rand = len(CHUNK_VALUES) - len(DIGEST_EDGES) - 10
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n_rand)]
    short = [int(rng.integers(0, 2**62)) >> int(rng.integers(0, 62)) for _ in range(10)]
    values = DIGEST_EDGES + rand + short
    d = _digest_words(values)
    B = d.shape[1]
    plain = trw.render_bigint_dec_w(torch.from_numpy(d.view(np.int32)))
    j = jrw.render_bigint_dec_w(jnp.asarray(d))
    np.testing.assert_array_equal(plain.buf.numpy().view(np.uint32), np.asarray(j.buf))
    np.testing.assert_array_equal(plain.length.numpy(), np.asarray(j.length))
    out = np.full((20, B), 0xA5A5A5A5, np.uint32)  # every word must be written
    lens = np.full(B, -1, np.int32)
    lib.host_render_prehash(d.ctypes.data, B, out.ctypes.data, lens.ctypes.data)
    np.testing.assert_array_equal(out, np.asarray(j.buf))
    np.testing.assert_array_equal(lens, np.asarray(j.length))
    by = out.T.copy().view(np.uint8)
    for b, v in enumerate(values):
        s = str(v).encode()
        assert lens[b] == len(s) and by[b, :len(s)].tobytes() == s and not by[b, len(s):].any()


def test_render_prehash_chunk_edges(lib):
    """Digests whose base-10^9 chunks are zero in the middle (10^72 + 1,
    10^36, 10^45 + 10^9 - 1, 10^63 + 10^27) or all nines (2^256 - 1, 10^77 -
    1, 10^72 - 1), and every power of ten and its predecessor up to 10^77:
    the host model, the plain version and JAX equal str()."""
    values = CHUNK_VALUES
    d = _digest_words(values)
    B = d.shape[1]
    j = jrw.render_bigint_dec_w(jnp.asarray(d))
    plain = trw.render_bigint_dec_w(torch.from_numpy(d.view(np.int32)))
    np.testing.assert_array_equal(plain.buf.numpy().view(np.uint32), np.asarray(j.buf))
    np.testing.assert_array_equal(plain.length.numpy(), np.asarray(j.length))
    out = np.full((20, B), 0xA5A5A5A5, np.uint32)
    lens = np.full(B, -1, np.int32)
    lib.host_render_prehash(d.ctypes.data, B, out.ctypes.data, lens.ctypes.data)
    np.testing.assert_array_equal(out, np.asarray(j.buf))
    np.testing.assert_array_equal(lens, np.asarray(j.length))
    by = out.T.copy().view(np.uint8)
    for b, v in enumerate(values):
        s = str(v).encode()
        assert lens[b] == len(s) and by[b, :len(s)].tobytes() == s and not by[b, len(s):].any()


# ---------------------------------------------------------------------------
# lattice target
# ---------------------------------------------------------------------------


def _lattice_inputs(q, G, N, d, rank, beta, omega, seed):
    """Centered vks with edge values, canonical c_hat and alpha_hat, observed
    equal to the target except in group 1 (one coefficient off by one),
    norms and weights within their limits except a norm breach in group 2
    and a weight breach in group 3 (groups 4 and 5 sit exactly at the
    limits)."""
    rng = np.random.default_rng(seed)
    vks = rng.integers(-(q // 2), q // 2 + 1, size=(G, N, 2, d)).astype(np.int32)
    vks[0, 0, 0, :5] = [0, 1, -1, q // 2, -(q // 2)]
    c = rng.integers(0, q, size=(G, N, d))
    a = rng.integers(0, q, size=(G, N, d))
    c[0, 0, :3] = [0, 1, q - 1]
    a[0, 0, :3] = [q - 1, 0, 1]
    F = get_field(q)
    tv = [torch.from_numpy(x) for x in (vks, c, a)]
    vk_u = F.to_unsigned(tv[0])
    t = F.add_mod(F.mont_mul(F.to_mont(tv[1]), vk_u[..., 0, :]), vk_u[..., 1, :])
    observed = F.sum_mod(F.mont_mul(F.to_mont(tv[2]), t), axis=-2).numpy().copy()
    observed[1, d // 2] = (observed[1, d // 2] + 1) % q
    nrm = rng.integers(0, beta + 1, size=(G, rank)).astype(np.int32)
    wgt = rng.integers(0, omega + 1, size=(G, rank)).astype(np.int32)
    nrm[2, rank - 1] = beta + 1
    wgt[3, 0] = omega + 1
    nrm[4, 0], wgt[5, rank - 1] = beta, omega
    return vks, c, a, observed, nrm, wgt


def _jax_target(vks, c, a, q):
    """The JAX package's j_lattice target sum (device_pipeline.py:549-551)."""
    F = jf.get_field(q)
    vk_u = F.to_unsigned(jnp.asarray(vks))
    t = F.add_mod(F.mont_mul(F.to_mont(jnp.asarray(c, jnp.uint32)), vk_u[..., 0, :]),
                  vk_u[..., 1, :])
    return np.asarray(F.sum_mod(F.mont_mul(F.to_mont(jnp.asarray(a, jnp.uint32)), t), axis=-2))


@pytest.mark.parametrize("secpar,G,N", [(128, 11, 3), (256, 9, 4)])
def test_lattice_target_lanes_match_plain_and_jax(lib, secpar, G, N):
    params = ftpu.fusion_setup(secpar, 3)
    q, d, rank = params.modulus, params.degree, params.rank
    beta, omega = min(params.beta_vf, 2**31 - 1), params.omega_vf
    vks, c, a, observed, nrm, wgt = _lattice_inputs(q, G, N, d, rank, beta, omega, secpar + G)
    target = _jax_target(vks, c, a, q)
    want_eq = (target == observed).all(axis=-1)
    want = [want_eq, nrm.max(axis=-1) <= beta, wgt.max(axis=-1) <= omega]
    assert want_eq.tolist() == [g != 1 for g in range(G)]
    assert want[1].tolist() == [g != 2 for g in range(G)]
    assert want[2].tolist() == [g != 3 for g in range(G)]
    tv = [torch.from_numpy(x) for x in (vks, c, a, observed, nrm, wgt)]
    F = get_field(q)
    for fn in (lattice_target, lattice_target_plain):
        got = fn(F, *tv, beta, omega)
        for g_, w_ in zip(got, want):
            assert g_.dtype == torch.bool
            np.testing.assert_array_equal(g_.numpy(), w_)
    outs = np.full((3, G), 7, np.uint8)
    lib.host_lattice_target(*(x.ctypes.data for x in (vks, c, a, observed, nrm, wgt)), G, N, d,
                            rank, q, (1 << 64) // q, beta, omega, *(o.ctypes.data for o in outs))
    for o, w_ in zip(outs, want):
        np.testing.assert_array_equal(o, w_.astype(np.uint8))


@pytest.mark.parametrize("secpar", [128, 256])
@pytest.mark.parametrize("slices", [1, 3, 8, 64])
def test_lattice_target_split_lanes_match_plain(lib, slices, secpar):
    """The split check at N = 64 (G = 6 groups: a tampered target, a norm
    and a weight breach, both limits met exactly): 1, 3 (slices of 22, 21
    and 21 signers), 8 and 64 slices of the signers, the partial sums
    written over marks, give the plain version's verdicts, at d = 64 and
    256."""
    params = ftpu.fusion_setup(secpar, 3)
    q, d, rank = params.modulus, params.degree, params.rank
    beta, omega = min(params.beta_vf, 2**31 - 1), params.omega_vf
    G, N = 6, 64
    ins = _lattice_inputs(q, G, N, d, rank, beta, omega, secpar + slices)
    want = lattice_target_plain(get_field(q), *(torch.from_numpy(x) for x in ins), beta, omega)
    assert want[0].tolist() == [g != 1 for g in range(G)]
    partial = np.full((slices, G, d), 0xA5A5A5A5, np.uint32)
    outs = np.full((3, G), 7, np.uint8)
    lib.host_lattice_target_split(*(x.ctypes.data for x in ins), G, N, d, rank, q,
                                  (1 << 64) // q, beta, omega, slices, partial.ctypes.data,
                                  *(o.ctypes.data for o in outs))
    for o, w_ in zip(outs, want):
        np.testing.assert_array_equal(o, w_.numpy().astype(np.uint8))
    assert (partial < q).all()  # every partial sum written, reduced mod q
    spans = np.zeros(2 * slices, np.int32)
    lib.host_slice_signers(N, slices, spans.ctypes.data)
    k0, k1 = spans[0::2], spans[1::2]
    assert k0[0] == 0 and k1[-1] == N and (k0[1:] == k1[:-1]).all()
    assert (k1 - k0).max() - (k1 - k0).min() <= 1


def test_lattice_split_by_shape():
    """One slice (the one-launch kernel) at the short cell's 8,192 groups of
    4 and wherever the groups fill the card; at 32 groups of 1,024 on 132
    SMs, 66 slices of 15 or 16 signers."""
    assert lattice_split(8192, 4, 132) == 1
    assert lattice_split(32, 4, 132) == 1
    assert lattice_split(4096, 1024, 132) == 1
    assert lattice_split(32, 1024, 132) == 66
    assert lattice_split(1, 1024, 132) == 128
    assert lattice_split(2, 64, 132) == 8
