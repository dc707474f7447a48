"""The CUDA kernels' arithmetic, compiled for the host CPU.

``csrc/*.cu`` keep each kernel's per-lane and per-row work (Keccak-f and the
sponge lanes; the Cooley-Tukey and Gentleman-Sande butterflies, Shoup
multiplies, the NTT's centered loads and stores and the centered reduction;
the preimage folds' and the spec assembler's op-table walks, decimal
rendering and word stream) in functions that also compile as plain C++: without nvcc,
``FCT_HD`` is ``static inline`` and the ``__global__`` parts drop out.  These
tests build them with the host C++ compiler, with a serial loop in place of
the CUDA grid, and hold them against the plain torch versions and hashlib.
Where a kernel's threads cooperate (the absorb's pairs, the signer folds'
warp tiles, the NTTs' and the aggregate check's warp per row), the loop
runs them in lockstep and each shuffle or warp reduction reads the other
threads' registers.  The launch geometry, cp.async
and the ctypes binding run only on the card (tests/test_torch_cuda_kernels.py,
marked ``cuda``)."""
import ctypes
import shutil
import subprocess
from hashlib import sha3_256, shake_256
from pathlib import Path

import numpy as np
import pytest
import torch

from fusion_cryptography_tpu_torch import fusion_setup
from fusion_cryptography_tpu_torch.interop import device_serial as ds
from fusion_cryptography_tpu_torch.ops import keccak as tk
from fusion_cryptography_tpu_torch.ops import preimage_fold as pf
from fusion_cryptography_tpu_torch.ops.field import Q
from fusion_cryptography_tpu_torch.ops.intt_norm_weight import agg_check_plain, agg_table
from fusion_cryptography_tpu_torch.ops import ntt as tntt
from fusion_cryptography_tpu_torch.ops.ntt import make_plan, ntt_fwd_u

CSRC = Path(__file__).resolve().parents[1] / "fusion_cryptography_tpu_torch" / "csrc"

# A serial loop over the batch (sponge) or the rows and butterflies (INTT)
# around the kernels' own device functions.
HOST_LOOPS = r"""
#include <algorithm>
#include <vector>

#include "keccak_sponge.cu"
#include "intt_norm_weight.cu"
#include "ntt.cu"
#include "preimage_fold.cu"
#include "assemble_spec.cu"

// keccak_f1600_pair with the pair's two threads run in turn, s[e] the words
// of role e: each exchange reads the partner's words from before it.
static void host_permute_pair(uint32_t s[2][25]) {
  for (int round = 0; round < 24; ++round) {
    uint32_t c[2][5], p[2][25];
    for (int e = 0; e < 2; ++e) il_parity(s[e], c[e]);
    for (int e = 0; e < 2; ++e) il_theta(s[e], c[e], c[1 - e], e);
    std::copy(&s[0][0], &s[0][0] + 50, &p[0][0]);
    for (int e = 0; e < 2; ++e) il_rho_pi_chi_iota(s[e], p[1 - e], e, round);
  }
}

// sponge_absorb_pair's arithmetic for lane b, its two threads run in turn.
static void host_absorb_pair_lane(const uint32_t* words, const int32_t* nblk, uint32_t* state,
                                  int max_blocks, int64_t batch, int64_t b) {
  uint32_t s[2][25] = {};
  int n = nblk[b];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
  for (int j = 0; j < n; ++j) {
    uint32_t u[2][17];
    for (int e = 0; e < 2; ++e)
      for (int l = 0; l < 17; ++l)
        u[e][l] = unzip32(words[((int64_t)j * 34 + 2 * l + 1 - e) * batch + b]);
    for (int e = 0; e < 2; ++e)
      for (int l = 0; l < 17; ++l) s[e][l] ^= byte_perm(u[e][l], u[1 - e][l], pair_sel(e));
    host_permute_pair(s);
  }
  for (int e = 0; e < 2; ++e)
    for (int l = 0; l < 25; ++l)
      state[(int64_t)(2 * l + 1 - e) * batch + b] =
          zip32(byte_perm(s[e][l], s[1 - e][l], pair_sel(e)));
}

// keccak_f1600_warp with the warp's 32 threads run in turn at each step,
// reg[t] thread t's lane: each stores its lane in the table (poisoned
// first: the columns' padding is loaded, never used); after the
// __syncwarp() each forms its theta and rho; each shuffle reads the source
// thread's value from before the gather.  Returns false if a thread past
// 24 ever differs from thread 24.
static bool host_permute_warp(W64 reg[32]) {
  WarpTable tb;
  std::fill(&tb.cols[0].lo, &tb.cols[0].lo + 2 * 30, 0xA5A5A5A5u);
  bool mirrored = true;
  for (int round = 0; round < 24; ++round) {
    W64 b[32];
    for (int t = 0; t < 32; ++t) tb.cols[warp_lane(t).own] = reg[t];
    for (int t = 0; t < 32; ++t) b[t] = warp_theta_rho(tb, reg[t], warp_lane(t));
    for (int t = 0; t < 32; ++t) {
      const WarpLane w = warp_lane(t);
      reg[t] = warp_chi_iota(b[w.src[0]], b[w.src[1]], b[w.src[2]], w, round);
    }
    for (int t = 25; t < 32; ++t)
      mirrored &= reg[t].lo == reg[24].lo && reg[t].hi == reg[24].hi;
  }
  return mirrored;
}

// keccak_absorb_warp_kernel's arithmetic for lane b, its 32 threads in turn.
static bool host_absorb_warp_lane(const uint32_t* words, const int32_t* nblk, uint32_t* state,
                                  int max_blocks, int64_t batch, int64_t b) {
  W64 reg[32] = {};
  int n = nblk[b];
  n = n < 0 ? 0 : (n > max_blocks ? max_blocks : n);
  bool mirrored = true;
  for (int j = 0; j < n; ++j) {
    const uint32_t* blk = words + (int64_t)j * 34 * batch + b;
    for (int t = 0; t < 32; ++t) {
      const int row = warp_rate_row(t);
      warp_absorb_words(reg[t], {blk[row * batch], blk[(row + 1) * batch]}, t);
    }
    mirrored &= host_permute_warp(reg);
  }
  for (int t = 0; t < 25; ++t) {
    state[(int64_t)(2 * t) * batch + b] = reg[t].lo;
    state[(int64_t)(2 * t + 1) * batch + b] = reg[t].hi;
  }
  return mirrored;
}

// team 1: the one-thread lane function; team 2: the pair, emulated; team
// 32: the warp, emulated.  Returns 0, or -1 if a warp's threads past 24
// left thread 24's lane.
extern "C" int host_absorb(const uint32_t* words, const int32_t* nblk,
                           uint32_t* state, int max_blocks, int64_t batch, int team) {
  bool mirrored = true;
  for (int64_t b = 0; b < batch; ++b) {
    if (team == 1)
      sponge_absorb_lane(words, nblk, state, max_blocks, batch, b);
    else if (team == 2)
      host_absorb_pair_lane(words, nblk, state, max_blocks, batch, b);
    else
      mirrored &= host_absorb_warp_lane(words, nblk, state, max_blocks, batch, b);
  }
  return mirrored ? 0 : -1;
}

// n states of 25 lanes, each permuted ``times`` times: keccak_f1600 on
// ``lanes``, the pair's permutation on the same states given as
// interleaved words (even[k], odd[k]: 25 words each), and the warp's on
// them given as 50 words (low and high word of each lane) in ``warp``.
// Returns 0, or -1 if the warp's threads past 24 left thread 24's lane.
extern "C" int host_permute(uint64_t* lanes, uint32_t* even, uint32_t* odd, uint32_t* warp,
                            int64_t n, int times) {
  bool mirrored = true;
  for (int64_t k = 0; k < n; ++k) {
    uint32_t s[2][25];
    std::copy(odd + 25 * k, odd + 25 * k + 25, s[0]);
    std::copy(even + 25 * k, even + 25 * k + 25, s[1]);
    W64 reg[32];
    for (int t = 0; t < 32; ++t) {
      const int l = t < 25 ? t : 24;
      reg[t] = {warp[50 * k + 2 * l], warp[50 * k + 2 * l + 1]};
    }
    for (int i = 0; i < times; ++i) {
      keccak_f1600(lanes + 25 * k);
      host_permute_pair(s);
      mirrored &= host_permute_warp(reg);
    }
    std::copy(s[0], s[0] + 25, odd + 25 * k);
    std::copy(s[1], s[1] + 25, even + 25 * k);
    for (int l = 0; l < 25; ++l) {
      warp[50 * k + 2 * l] = reg[l].lo;
      warp[50 * k + 2 * l + 1] = reg[l].hi;
    }
  }
  return mirrored ? 0 : -1;
}

// sponge_squeeze_pair's arithmetic for lane b, its two threads run in turn:
// each role's word of every lane unzipped, the interleaved words formed
// from both, and before each block's store the rate lanes zipped back.
static void host_squeeze_pair_lane(const uint32_t* state, uint32_t* out, int n_words,
                                   int64_t batch, int64_t b) {
  uint32_t u[2][25], s[2][25];
  for (int e = 0; e < 2; ++e)
    for (int l = 0; l < 25; ++l) u[e][l] = unzip32(state[(int64_t)(2 * l + 1 - e) * batch + b]);
  for (int e = 0; e < 2; ++e)
    for (int l = 0; l < 25; ++l) s[e][l] = byte_perm(u[e][l], u[1 - e][l], pair_sel(e));
  for (int k = 0; k < (n_words + 33) / 34; ++k) {
    if (k) host_permute_pair(s);
    for (int e = 0; e < 2; ++e)
      for (int l = 0; l < 17; ++l) {
        const int w = 34 * k + 2 * l + 1 - e;
        if (w < n_words)
          out[(int64_t)w * batch + b] = zip32(byte_perm(s[e][l], s[1 - e][l], pair_sel(e)));
      }
  }
}

// keccak_squeeze_warp_kernel's arithmetic for lane b, its 32 threads in
// turn: threads 0..16 store their lane's two words of each block.
static bool host_squeeze_warp_lane(const uint32_t* state, uint32_t* out, int n_words,
                                   int64_t batch, int64_t b) {
  W64 reg[32];
  for (int t = 0; t < 32; ++t) {
    const int l = warp_lane(t).lane;
    reg[t] = {state[(int64_t)(2 * l) * batch + b], state[(int64_t)(2 * l + 1) * batch + b]};
  }
  bool mirrored = true;
  int left[32];
  for (int t = 0; t < 32; ++t) left[t] = t < 17 ? n_words - 2 * t : 0;
  for (int k = 0; k < (n_words + 33) / 34; ++k) {
    if (k) mirrored &= host_permute_warp(reg);
    for (int t = 0; t < 32; ++t) {
      uint32_t* dst = out + (34 * (int64_t)k + warp_rate_row(t)) * batch + b;
      if (left[t] > 0) dst[0] = reg[t].lo;
      if (left[t] > 1) dst[batch] = reg[t].hi;
      left[t] -= 34;
    }
  }
  return mirrored;
}

// team 1: the one-thread lane function; team 2: the pair, emulated; team
// 32: the warp, emulated (returns as host_absorb)
extern "C" int host_squeeze(const uint32_t* state, uint32_t* out,
                            int n_words, int64_t batch, int team) {
  bool mirrored = true;
  for (int64_t b = 0; b < batch; ++b) {
    if (team == 1)
      sponge_squeeze_lane(state, out, n_words, batch, b);
    else if (team == 2)
      host_squeeze_pair_lane(state, out, n_words, batch, b);
    else
      mirrored &= host_squeeze_warp_lane(state, out, n_words, batch, b);
  }
  return mirrored ? 0 : -1;
}

// The aggregate check's rows, one warp of 32 lanes emulated serially: the
// kernel's own per-lane functions, the shuffles replaced by reads of the
// partner lane's registers from before the stage, the transpose by the same
// padded buffer, the warp reductions by loops over the lanes.  One warp
// accumulates every row of a group (the kernel's warps add theirs mod q).
template <int D>
static void host_agg_check_d(const int32_t* aggs, int64_t groups, int rank,
                             const uint32_t* a_u, const uint32_t* a_sh, const uint32_t* tw,
                             const uint32_t* tw_sh, uint32_t n_inv, uint32_t n_inv_sh,
                             uint32_t q, int64_t* observed, int32_t* nrm, int32_t* wgt) {
  constexpr int E = D / WARP, lE = log2i(E);
  std::vector<uint32_t> s_w(tw, tw + D), s_wsh(tw_sh, tw_sh + D);
  fused_last_twiddle(tw, n_inv, n_inv_sh, q, &s_w[0], &s_wsh[0]);
  std::vector<uint32_t> x(WARP * E), prev(WARP * E), acc(WARP * E), buf(D + D / WARP);
  for (int64_t g = 0; g < groups; ++g) {
    std::fill(acc.begin(), acc.end(), 0u);
    for (int r = 0; r < rank; ++r) {
      const int64_t row = g * rank + r;
      for (int l = 0; l < WARP; ++l) {
        lane_lift_accumulate<E>(aggs + row * D, a_u + (int64_t)r * D, a_sh + (int64_t)r * D, l,
                                q, &x[l * E], &acc[l * E]);
        gs_blocked_stages<D>(&x[l * E], l, s_w.data(), s_wsh.data(), q);
      }
      for (int b = lE; b < 5; ++b) {
        prev = x;
        for (int l = 0; l < WARP; ++l)
          gs_exchange_stage<D>(&x[l * E], &prev[(l ^ (1 << (b - lE))) * E], l, b, s_w.data(),
                               s_wsh.data(), q);
      }
      for (int l = 0; l < WARP; ++l)
        for (int e = 0; e < E; ++e) buf[pad_index(l * E + e)] = x[l * E + e];
      uint32_t m = 0, c = 0;
      for (int l = 0; l < WARP; ++l) {
        for (int e = 0; e < E; ++e) x[l * E + e] = buf[pad_index(l + WARP * e)];
        gs_strided_stages<D>(&x[l * E], s_w.data(), s_wsh.data(), n_inv, n_inv_sh, q);
        uint32_t lm, lc;
        lane_norm_weight<E>(&x[l * E], q, &lm, &lc);
        m = lm > m ? lm : m;
        c += lc;
      }
      nrm[row] = (int32_t)m;
      wgt[row] = (int32_t)c;
    }
    for (int k = 0; k < D; ++k) observed[g * D + k] = acc[k];
  }
}

extern "C" void host_agg_check(const int32_t* aggs, int64_t groups, int rank, int d,
                               const uint32_t* a_u, const uint32_t* a_sh, const uint32_t* tw,
                               const uint32_t* tw_sh, uint32_t n_inv, uint32_t n_inv_sh,
                               uint32_t q, int64_t* observed, int32_t* nrm, int32_t* wgt) {
  switch (d) {
    case 64: host_agg_check_d<64>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                  observed, nrm, wgt); break;
    case 128: host_agg_check_d<128>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                    observed, nrm, wgt); break;
    case 256: host_agg_check_d<256>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                    observed, nrm, wgt); break;
    case 512: host_agg_check_d<512>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh, q,
                                    observed, nrm, wgt); break;
    case 1024: host_agg_check_d<1024>(aggs, groups, rank, a_u, a_sh, tw, tw_sh, n_inv, n_inv_sh,
                                      q, observed, nrm, wgt); break;
  }
}

// The NTT kernels' rows, one warp of 32 lanes emulated serially around the
// kernels' own per-lane functions: each exchange reads the partner lane's
// registers from before the stage, the transpose goes through the same
// padded buffer.  Inverse: blocked load, Gentleman-Sande network, strided
// store; forward: strided load, Cooley-Tukey network, transpose back,
// strided store.
template <int D, typename T>
static void host_ntt_rows_d(const T* x, T* y, int64_t rows, const uint32_t* tw,
                            const uint32_t* tw_sh, int inverse, uint32_t n_inv,
                            uint32_t n_inv_sh, uint32_t q) {
  constexpr int E = D / WARP, lE = log2i(E);
  std::vector<uint32_t> s_w(tw, tw + D), s_wsh(tw_sh, tw_sh + D);
  if (inverse) fused_last_twiddle(tw, n_inv, n_inv_sh, q, &s_w[0], &s_wsh[0]);
  const uint32_t *w = s_w.data(), *wsh = s_wsh.data();
  std::vector<uint32_t> v(WARP * E), prev(WARP * E), buf(D + D / WARP);
  for (int64_t row = 0; row < rows; ++row) {
    const T* xr = x + row * D;
    T* yr = y + row * D;
    if (inverse) {
      for (int l = 0; l < WARP; ++l) {
        load_blocked<E>(xr, l, q, &v[l * E]);
        gs_blocked_stages<D>(&v[l * E], l, w, wsh, q);
      }
      for (int b = lE; b < 5; ++b) {
        prev = v;
        for (int l = 0; l < WARP; ++l)
          gs_exchange_stage<D>(&v[l * E], &prev[(l ^ (1 << (b - lE))) * E], l, b, w, wsh, q);
      }
      for (int l = 0; l < WARP; ++l)
        for (int e = 0; e < E; ++e) buf[pad_index(l * E + e)] = v[l * E + e];
      for (int l = 0; l < WARP; ++l) {
        for (int e = 0; e < E; ++e) v[l * E + e] = buf[pad_index(l + WARP * e)];
        gs_strided_stages<D>(&v[l * E], w, wsh, n_inv, n_inv_sh, q);
        store_strided<E>(yr, l, q, &v[l * E]);
      }
    } else {
      for (int l = 0; l < WARP; ++l) {
        load_strided<E>(xr, l, q, &v[l * E]);
        ct_strided_stages<D>(&v[l * E], w, wsh, q);
      }
      for (int l = 0; l < WARP; ++l)
        for (int e = 0; e < E; ++e) buf[pad_index(l + WARP * e)] = v[l * E + e];
      for (int l = 0; l < WARP; ++l)
        for (int e = 0; e < E; ++e) v[l * E + e] = buf[pad_index(l * E + e)];
      for (int b = 4; b >= lE; --b) {
        prev = v;
        for (int l = 0; l < WARP; ++l)
          ct_exchange_stage<D>(&v[l * E], &prev[(l ^ (1 << (b - lE))) * E], l, b, w, wsh, q);
      }
      for (int l = 0; l < WARP; ++l) {
        ct_blocked_stages<D>(&v[l * E], l, w, wsh, q);
        for (int e = 0; e < E; ++e) buf[pad_index(l * E + e)] = v[l * E + e];
      }
      for (int l = 0; l < WARP; ++l) {
        for (int e = 0; e < E; ++e) v[l * E + e] = buf[pad_index(l + WARP * e)];
        store_strided<E>(yr, l, q, &v[l * E]);
      }
    }
  }
}

template <typename T>
static void host_ntt_rows(const T* x, T* y, int64_t rows, int d, const uint32_t* tw,
                          const uint32_t* tw_sh, int inverse, uint32_t n_inv,
                          uint32_t n_inv_sh, uint32_t q) {
  switch (d) {
    case 64: host_ntt_rows_d<64>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q); break;
    case 128: host_ntt_rows_d<128>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q); break;
    case 256: host_ntt_rows_d<256>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q); break;
    case 512: host_ntt_rows_d<512>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q); break;
    case 1024: host_ntt_rows_d<1024>(x, y, rows, tw, tw_sh, inverse, n_inv, n_inv_sh, q); break;
  }
}

extern "C" void host_ntt_u(const int64_t* x, int64_t* y, int64_t rows, int d,
                           const uint32_t* tw, const uint32_t* tw_sh, int inverse,
                           uint32_t n_inv, uint32_t n_inv_sh, uint32_t q) {
  host_ntt_rows(x, y, rows, d, tw, tw_sh, inverse, n_inv, n_inv_sh, q);
}

extern "C" void host_ntt_centered(const int32_t* x, int32_t* y, int64_t rows, int d,
                                  const uint32_t* tw, const uint32_t* tw_sh, int inverse,
                                  uint32_t n_inv, uint32_t n_inv_sh, uint32_t q) {
  host_ntt_rows(x, y, rows, d, tw, tw_sh, inverse, n_inv, n_inv_sh, q);
}

// The signer folds through the plain one-thread-a-lane walk (run_ops
// with Writer), lane by lane.
extern "C" void host_signer_fold_a(const int32_t* ops, int n_ops, const uint32_t* pool,
                                   const int32_t* vk2d_t, const uint32_t* pre_w,
                                   int pre_rows, const int32_t* pre_len, int64_t batch,
                                   uint32_t* ch_out, int ch_width, int32_t* ch_total,
                                   uint32_t* vk_out, int vk_width, int32_t* vk_len) {
  for (int64_t b = 0; b < batch; ++b) {
    Writer ws[2] = {make_writer(ch_out + b, batch, ch_width),
                    make_writer(vk_out + b, batch, vk_width)};
    const Source ex[1] = {make_source(pre_w + b, batch, pre_rows, pre_len[b])};
    run_ops<2>(ops, n_ops, pool, vk2d_t + b, batch, ex, ws);
    finish(ws[0]);
    finish(ws[1]);
    ch_total[b] = ws[0].total;
    vk_len[b] = ws[1].total;
  }
}

extern "C" void host_signer_fold_b(const int32_t* ops, int n_ops, const uint32_t* pool,
                                   const uint32_t* vk_buf, int vk_rows,
                                   const int32_t* vk_len, const uint32_t* pre_w,
                                   int pre_rows, const int32_t* pre_len,
                                   const int32_t* c_hat_t, int64_t batch,
                                   uint32_t* tri_out, int tri_width, int32_t* tri_total) {
  for (int64_t b = 0; b < batch; ++b) {
    Writer ws[1] = {make_writer(tri_out + b, batch, tri_width)};
    const Source ex[2] = {make_source(vk_buf + b, batch, vk_rows, vk_len[b]),
                          make_source(pre_w + b, batch, pre_rows, pre_len[b])};
    run_ops<1>(ops, n_ops, pool, c_hat_t + b, batch, ex, ws);
    finish(ws[0]);
    tri_total[b] = ws[0].total;
  }
}

// The signer fold kernels' tiles, one after another: the kernels' own tile
// functions with L = 32, so one call runs a warp's 32 threads in lockstep
// (fold a: 16 lanes, two threads each; fold b: 32 lanes), the shuffles
// reads of the source thread's registers and the warp reductions loops
// over the threads.  Each tile's ring and stage buffers are poisoned first,
// so a row stored from a slot no thread wrote, or a value read from a row
// not staged, fails the comparison.  ring 0: the kernels' kRing rows;
// otherwise R = 32, the shallowest ring (a window of 13 rows: more threads
// lag and lead).
template <int R>
static void host_fold_a_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                              const int32_t* vk2d_t, const uint32_t* pre_w, int pre_rows,
                              const int32_t* pre_len, int64_t batch, uint32_t* ch_out,
                              int ch_width, int32_t* ch_total, uint32_t* vk_out, int vk_width,
                              int32_t* vk_len) {
  std::vector<uint32_t> smem(R * kWarp + kStageWords);
  for (int64_t b0 = 0; b0 < batch; b0 += kWarp / 2) {  // 16 lanes a warp, two threads a lane
    std::fill(smem.begin(), smem.end(), 0xA5A5A5A5u);
    signer_fold_a_tile<kWarp, R>(ops, n_ops, pool, vk2d_t, pre_w, pre_rows, pre_len, batch, b0,
                                 0, smem.data(), ch_out, ch_width, ch_total, vk_out, vk_width,
                                 vk_len);
  }
}

template <int R>
static void host_fold_b_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                              const uint32_t* vk_buf, int vk_rows, const int32_t* vk_len,
                              const uint32_t* pre_w, int pre_rows, const int32_t* pre_len,
                              const int32_t* c_hat_t, int64_t batch, uint32_t* tri_out,
                              int tri_width, int32_t* tri_total) {
  std::vector<uint32_t> smem(R * kWarp + kStageWords);
  for (int64_t b0 = 0; b0 < batch; b0 += kWarp) {
    std::fill(smem.begin(), smem.end(), 0xA5A5A5A5u);
    signer_fold_b_tile<kWarp, R>(ops, n_ops, pool, vk_buf, vk_rows, vk_len, pre_w, pre_rows,
                                 pre_len, c_hat_t, batch, b0, 0, smem.data(), tri_out,
                                 tri_width, tri_total);
  }
}

// render_dec_halves of n values: bytes [n, 16] and lengths [n]
extern "C" void host_render_halves(const int32_t* v, int64_t n, uint8_t* out, int32_t* len) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t lo;
    uint32_t hi;
    len[i] = render_dec_halves(v[i], lo, hi);
    for (int j = 0; j < 8; ++j) out[16 * i + j] = (uint8_t)(lo >> (8 * j));
    for (int j = 0; j < 4; ++j) out[16 * i + 8 + j] = (uint8_t)(hi >> (8 * j));
  }
}

extern "C" void host_signer_fold_a_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                                         const int32_t* vk2d_t, const uint32_t* pre_w,
                                         int pre_rows, const int32_t* pre_len, int64_t batch,
                                         uint32_t* ch_out, int ch_width, int32_t* ch_total,
                                         uint32_t* vk_out, int vk_width, int32_t* vk_len,
                                         int ring) {
  (ring == 0 ? host_fold_a_tiles<kRing> : host_fold_a_tiles<32>)(
      ops, n_ops, pool, vk2d_t, pre_w, pre_rows, pre_len, batch, ch_out, ch_width, ch_total,
      vk_out, vk_width, vk_len);
}

extern "C" void host_signer_fold_b_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                                         const uint32_t* vk_buf, int vk_rows,
                                         const int32_t* vk_len, const uint32_t* pre_w,
                                         int pre_rows, const int32_t* pre_len,
                                         const int32_t* c_hat_t, int64_t batch,
                                         uint32_t* tri_out, int tri_width, int32_t* tri_total,
                                         int ring) {
  (ring == 0 ? host_fold_b_tiles<kRing> : host_fold_b_tiles<32>)(
      ops, n_ops, pool, vk_buf, vk_rows, vk_len, pre_w, pre_rows, pre_len, c_hat_t, batch,
      tri_out, tri_width, tri_total);
}

// agg_fold's blocks, one after another: a tile of TG groups by TW output
// rows, NWARPS warps of TG lanes, R staged rows per pass, the lengths of OPS
// ops held at once.  Warp 0's walk (the kernel's
// agg_walk) runs lane by lane, its vote and min/max reductions as loops over
// the lanes; each __syncthreads is a phase boundary.  The staging
// buffer is poisoned before every pass, so a word composed from a row that
// no thread copied fails the comparison.  With ``op_at`` and ``prefix``
// the prefix launch runs first (its PW warps' shares lane by lane, into
// ``prefix`` pre-filled by the caller), and the runs of a tile are dealt to
// ``grid_y`` blocks as the kernel's grid does then (block y takes the y-th
// share of consecutive runs), each lane's first op found from its last
// (agg_run_start), WIDE ops held at once, and each group stages its own
// window where the tile spreads wider than R rows (the kernel's kWide).
template <int TG, int TW, int R, int NWARPS, int OPS, int PW, int WIDE>
static void host_agg_fold_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                                const AggSrc& src, int64_t groups, uint32_t* out, int out_width,
                                int32_t* total, const int32_t* op_at, int32_t* prefix,
                                int grid_y, int64_t* passes, int64_t* own) {
  constexpr int WPT = (TW + NWARPS - 1) / NWARPS;
  std::vector<uint32_t> stage(R * TG), acc(NWARPS * TG * WPT);
  const int runs = (out_width + TW - 1) / TW;
  if (prefix != nullptr) {
    for (int64_t g = 0; g < groups; ++g) {
      int before = 0;
      for (int part = 0; part < PW; ++part) {  // the shares in turn: their sums, then
        int e0, e1;                            // the prefix from the sums before
        agg_prefix_share(op_at[2 * n_ops + 1], PW, part, e0, e1);
        const int sum = agg_share_sum(src, e0, e1, g);
        agg_share_prefix(src, e0, e1, g, groups, before, prefix);
        before += sum;
      }
      total[g] = op_at[2 * n_ops] + before;
    }
  }
  const int blocks_y = prefix != nullptr ? grid_y : 1;
  const int per = (runs + blocks_y - 1) / blocks_y;
  const int hold = prefix != nullptr ? WIDE : OPS;
  for (int64_t g0 = 0; g0 < groups; g0 += TG) {
    for (int y = 0; y < blocks_y; ++y) {
      int hint[TG];
      std::fill(hint, hint + TG, -1);
      for (int run = y * per; run < std::min(runs, (y + 1) * per); ++run) {
      const int w0 = run * TW, w1 = std::min(w0 + TW, out_width);
      const int b0 = 4 * w0, b1 = 4 * w1;
      std::fill(acc.begin(), acc.end(), 0u);
      int jbase = 0, s[TG] = {0};
      if (prefix != nullptr) {
        jbase = 0x7fffffff;
        for (int t = 0; t < TG; ++t) {
          const int64_t g = g0 + t;
          if (g >= groups) continue;
          if (hint[t] < 0) hint[t] = (int)((int64_t)b0 * n_ops / (total[g] > 0 ? total[g] : 1));
          hint[t] = agg_last_op_at(op_at, prefix, groups, g, n_ops, b0, hint[t]);
          jbase = std::min(jbase, hint[t]);
        }
        for (int t = 0; t < TG; ++t)
          s[t] = g0 + t < groups ? agg_op_start(op_at, prefix, groups, g0 + t, jbase) : 0;
      }
      for (;;) {
        const int count = std::min(n_ops - jbase, hold);
        int lens[OPS][TG], starts[OPS][TG];
        for (int k = 0; k < count; ++k)
          for (int t = 0; t < TG; ++t)
            lens[k][t] = g0 + t < groups ? agg_op_len(ops, jbase + k, src, g0 + t) : 0;
        // the walk: each lane's offsets, the first and last op overlapping
        // some group, the list and its triples' unions of source rows
        int first = OPS, last = -1;
        for (int t = 0; t < TG; ++t) {
          for (int k = 0; k < count; ++k) {
            starts[k][t] = s[t];
            if (g0 + t < groups && agg_overlaps(s[t], lens[k][t], b0, b1)) {
              first = std::min(first, k);
              last = std::max(last, k);
            }
            s[t] += lens[k][t];
          }
        }
        const int n = last < first ? 0 : last - first + 1;
        int u_lo[OPS], u_hi[OPS];
        for (int q = 0; q < n; ++q) {
          u_lo[q] = 0x7fffffff;
          u_hi[q] = -0x7fffffff - 1;
          for (int t = 0; t < TG; ++t) {
            const int k = first + q;
            if (g0 + t < groups && agg_overlaps(starts[k][t], lens[k][t], b0, b1)) {
              int lo, hi;
              agg_window_rows(starts[k][t], lens[k][t], b0, b1, lo, hi);
              u_lo[q] = std::min(u_lo[q], lo);
              u_hi[q] = std::max(u_hi[q], hi);
            }
          }
        }
        bool more = false;
        for (int t = 0; t < TG; ++t) more = more || (g0 + t < groups && s[t] < b1);
        more = more && jbase + count < n_ops;
        // the block, op by op
        for (int q = 0; q < n; ++q) {
          const int k = first + q;
          const int32_t* o = ops + (jbase + k) * kOpFields;
          if (o[0] == kOpConst) {
            for (int w = 0; w < NWARPS; ++w)
              for (int t = 0; t < TG; ++t)
                agg_compose<WPT>(&acc[(w * TG + t) * WPT], w0 + w, NWARPS, w1, starts[k][t],
                                 lens[k][t], pool + o[2], 1, 0, (lens[k][t] + 3) >> 2);
            continue;
          }
          if (prefix != nullptr && u_hi[q] - u_lo[q] >= R) {  // each group its own window
            ++*passes;
            ++*own;
            std::fill(stage.begin(), stage.end(), 0xA5A5A5A5u);
            int lo[TG], hi[TG];
            for (int t = 0; t < TG; ++t) {
              lo[t] = 0;
              hi[t] = -1;
              if (g0 + t < groups && agg_overlaps(starts[k][t], lens[k][t], b0, b1))
                agg_window_rows(starts[k][t], lens[k][t], b0, b1, lo[t], hi[t]);
            }
            for (int w = 0; w < NWARPS; ++w)
              for (int t = 0; t < TG; ++t)
                agg_stage_rows<TG>(stage.data(), src, o[2], g0 + t, g0 + t < groups, lo[t],
                                   hi[t] + 1 - lo[t], w, NWARPS, t);
            for (int w = 0; w < NWARPS; ++w)
              for (int t = 0; t < TG; ++t)
                agg_compose<WPT>(&acc[(w * TG + t) * WPT], w0 + w, NWARPS, w1, starts[k][t],
                                 lens[k][t], stage.data() + t, TG, lo[t], hi[t] + 1 - lo[t]);
            continue;
          }
          for (int c_lo = u_lo[q]; c_lo <= u_hi[q]; c_lo += R) {
            const int c_n = std::min(R, u_hi[q] + 1 - c_lo);
            ++*passes;
            std::fill(stage.begin(), stage.end(), 0xA5A5A5A5u);
            for (int w = 0; w < NWARPS; ++w)
              for (int t = 0; t < TG; ++t)
                agg_stage_rows<TG>(stage.data(), src, o[2], g0 + t, g0 + t < groups, c_lo, c_n,
                                   w, NWARPS, t);
            for (int w = 0; w < NWARPS; ++w)
              for (int t = 0; t < TG; ++t)
                agg_compose<WPT>(&acc[(w * TG + t) * WPT], w0 + w, NWARPS, w1, starts[k][t],
                                 lens[k][t], stage.data() + t, TG, c_lo, c_n);
          }
        }
        jbase += count;
        if (!more) break;
      }
      for (int t = 0; t < TG && g0 + t < groups; ++t) {
        const int64_t g = g0 + t;
        if (prefix == nullptr && run == 0) {
          int st = s[t];
          for (int k = jbase; k < n_ops; ++k) st += agg_op_len(ops, k, src, g);
          total[g] = st;
        }
        for (int w = 0; w < NWARPS; ++w)
          for (int u = 0; u < WPT; ++u) {
            const int word = w0 + w + u * NWARPS;
            if (word < w1) out[(int64_t)word * groups + g] = acc[(w * TG + t) * WPT + u];
          }
      }
      }
    }
  }
}

// tile 0: TG 4, TW 7, R 9, 2 warps, the lengths of 3 ops held (passes over
// sub-windows on a spread up to R rows, each group's own window past it,
// walks that run out of lengths), a prefix
// launch of 3 warps, 2 ops held with prefix offsets; tile 1: the kernel's
// own geometry
extern "C" void host_agg_fold(const int32_t* ops, int n_ops, const uint32_t* pool,
                              const uint32_t* tb, const int32_t* tl, int64_t row_stride,
                              int64_t signer_stride, int64_t group_stride,
                              int64_t len_signer_stride, int64_t len_group_stride,
                              int tri_rows, int64_t groups, uint32_t* out,
                              int out_width, int32_t* total, const int32_t* op_at,
                              int32_t* prefix, int grid_y, int tile, int64_t* passes,
                              int64_t* own) {
  const AggSrc src{tb, tl, row_stride, signer_stride, group_stride, len_signer_stride,
                   len_group_stride, tri_rows};
  if (tile == 0)
    host_agg_fold_tiles<4, 7, 9, 2, 3, 3, 2>(ops, n_ops, pool, src, groups, out, out_width,
                                             total, op_at, prefix, grid_y, passes, own);
  else
    host_agg_fold_tiles<kAggTG, kAggTW, kAggR, kAggWarps, kAggOps, kPrefixWarps, kAggOpsWide>(
        ops, n_ops, pool, src, groups, out, out_width, total, op_at, prefix, grid_y, passes,
        own);
}

// The first op at or before byte b of group g from each guess, as a
// kernel's lane finds it.
extern "C" int host_agg_last_op_at(const int32_t* op_at, const int32_t* prefix, int64_t groups,
                                   int64_t g, int n_ops, int b, int guess) {
  return agg_last_op_at(op_at, prefix, groups, g, n_ops, b, guess);
}

// A spec's table through the plain one-thread walk (run_ops), lane by
// lane, each extra read through the kernel's table (spec_extra).
struct HostSpecLane {
  const int64_t* table;
  int64_t b;
  Source operator[](int e) const { return spec_extra(table, e, b); }
};

extern "C" void host_assemble_spec(const int32_t* ops, int n_ops, const uint32_t* pool,
                                   const int32_t* values, int64_t vstride,
                                   const int64_t* extras, int64_t batch, uint32_t* out,
                                   int out_width, int32_t* total) {
  for (int64_t b = 0; b < batch; ++b) {
    Writer ws[1] = {make_writer(out + b, batch, out_width)};
    run_ops<1>(ops, n_ops, pool, values ? values + b : values, vstride, HostSpecLane{extras, b},
               ws);
    finish(ws[0]);
    total[b] = ws[0].total;
  }
}

// The assemble_spec kernel's tiles, one after another (the kernel's own
// tile function with L = 32, as host_fold_b_tiles), each tile's ring and
// stage buffers poisoned first.  ring 0: the kernel's kRing rows; otherwise
// 32.
template <int R>
static void host_spec_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                            const int32_t* values, int64_t vstride, const int64_t* extras,
                            int64_t batch, uint32_t* out, int out_width, int32_t* total) {
  std::vector<uint32_t> smem(R * kWarp + kStageWords);
  for (int64_t b0 = 0; b0 < batch; b0 += kWarp) {
    std::fill(smem.begin(), smem.end(), 0xA5A5A5A5u);
    assemble_spec_tile<kWarp, R>(ops, n_ops, pool, values, vstride, extras, batch, b0, 0,
                                 smem.data(), out, out_width, total);
  }
}

extern "C" void host_assemble_spec_tiles(const int32_t* ops, int n_ops, const uint32_t* pool,
                                         const int32_t* values, int64_t vstride,
                                         const int64_t* extras, int64_t batch, uint32_t* out,
                                         int out_width, int32_t* total, int ring) {
  (ring == 0 ? host_spec_tiles<kRing> : host_spec_tiles<32>)(
      ops, n_ops, pool, values, vstride, extras, batch, out, out_width, total);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("kernel_host")
    src = out / "host_loops.cpp"
    src.write_text(HOST_LOOPS)
    so = out / "libkernel_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", f"-I{CSRC}",
                    "-o", str(so), str(src)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    P, I32, I64, U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    lib.host_absorb.argtypes = [P, P, P, I32, I64, I32]
    lib.host_permute.argtypes = [P, P, P, P, I64, I32]
    lib.host_squeeze.argtypes = [P, P, I32, I64, I32]
    lib.host_agg_check.argtypes = [P, I64, I32, I32, P, P, P, P, U32, U32, U32, P, P, P]
    lib.host_ntt_u.argtypes = [P, P, I64, I32, P, P, I32, U32, U32, U32]
    lib.host_ntt_centered.argtypes = [P, P, I64, I32, P, P, I32, U32, U32, U32]
    lib.host_signer_fold_a.argtypes = [P, I32, P, P, P, I32, P, I64, P, I32, P, P, I32, P]
    lib.host_signer_fold_b.argtypes = [P, I32, P, P, I32, P, P, I32, P, P, I64, P, I32, P]
    lib.host_render_halves.argtypes = [P, I64, P, P]
    lib.host_signer_fold_a_tiles.argtypes = [P, I32, P, P, P, I32, P, I64, P, I32, P, P, I32, P,
                                             I32]
    lib.host_signer_fold_b_tiles.argtypes = [P, I32, P, P, I32, P, P, I32, P, P, I64, P, I32, P,
                                             I32]
    lib.host_agg_fold.argtypes = [P, I32, P, P, P, I64, I64, I64, I64, I64, I32, I64, P, I32,
                                  P, P, P, I32, I32, P, P]
    lib.host_agg_last_op_at.argtypes = [P, P, I64, I64, I32, I32, I32]
    lib.host_assemble_spec.argtypes = [P, I32, P, P, I64, P, I64, P, I32, P]
    lib.host_assemble_spec_tiles.argtypes = [P, I32, P, P, I64, P, I64, P, I32, P, I32]
    return lib


# threads per sponge: one (64-bit form), the interleaved pair, the warp
SPONGE_TEAMS = (1, 2, 32)


def _absorb(lib, padded, nblk, team):
    """The absorb of ``team`` threads per sponge over every lane, the state
    pre-filled with -1 (every word must be written); a warp's idle threads
    must keep thread 24's lane."""
    state = torch.full((50, padded.shape[1]), -1, dtype=torch.int32)
    assert lib.host_absorb(padded.data_ptr(), nblk.data_ptr(), state.data_ptr(),
                           padded.shape[0] // tk.RATE_WORDS, padded.shape[1], team) == 0
    return state


def _squeeze(lib, state, n_words, team=1):
    """The squeeze of ``team`` threads per sponge over every lane, into
    words pre-filled with -1 (every word must be written)."""
    out = torch.full((n_words, state.shape[1]), -1, dtype=torch.int32)
    assert lib.host_squeeze(state.data_ptr(), out.data_ptr(), n_words, state.shape[1],
                            team) == 0
    return out


@pytest.mark.parametrize("pad_head", [0x1F, 0x06], ids=["shake256", "sha3_256"])
def test_sponge_lanes_match_plain_and_hashlib(lib, pad_head):
    rng = np.random.default_rng(pad_head)
    lens = np.array([0, 1, 135, 136, 137, 271, 272, 700]
                    + list(rng.integers(0, 800, 24)), np.int32)
    rows = -(-(800 + 1) // tk.RATE) * tk.RATE_WORDS
    by = rng.integers(0, 256, size=(lens.size, 4 * rows), dtype=np.uint8)
    by[np.arange(4 * rows)[None, :] >= lens[:, None]] = 0
    words = torch.from_numpy(by.view(np.int32).T.copy())
    padded, nblk = tk.pad_words(words, torch.from_numpy(lens), pad_head, assume_clean=True)
    want = tk.absorb_padded(padded, nblk)
    for team in SPONGE_TEAMS:
        state = _absorb(lib, padded, nblk, team)
        np.testing.assert_array_equal(state.numpy(), want.numpy())
    for n_words in (1, 8, 34, 35, 300):
        for team in SPONGE_TEAMS:
            out = _squeeze(lib, state, n_words, team)
            np.testing.assert_array_equal(
                out.numpy(), tk.shake256_squeeze_words(state, n_words).numpy())
    got = _squeeze(lib, state, 300).t().contiguous().view(torch.uint8).numpy()
    for i, n in enumerate(lens):
        msg = by[i, :n].tobytes()
        want = shake_256(msg).digest(1200) if pad_head == 0x1F else sha3_256(msg).digest()
        assert got[i, : len(want)].tobytes() == want, int(n)


def _interleave(lanes):
    """uint64 lanes -> (even bits, odd bits) as uint32 words."""
    bits = (lanes[..., None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    even = (bits[..., 0::2] * weights).sum(-1).astype(np.uint32)
    odd = (bits[..., 1::2] * weights).sum(-1).astype(np.uint32)
    return even, odd


def _permute(lib, lanes, times):
    """``times`` Keccak-f of each uint64 state [n, 25]: (the one-thread
    keccak_f1600's, the pair's (even, odd) words, the warp's lanes)."""
    even, odd = (np.ascontiguousarray(w) for w in _interleave(lanes))
    single, warp = lanes.copy(), lanes.copy()
    assert lib.host_permute(single.ctypes.data, even.ctypes.data, odd.ctypes.data,
                            warp.ctypes.data, lanes.shape[0], times) == 0
    return single, (even, odd), warp


def test_pair_permutation_matches_keccak_f(lib):
    """The interleaved pair's and the warp's Keccak-f (every thread
    emulated) against the one-thread keccak_f1600 and the plain torch
    keccak_f, on random states and the all-zero and all-one states."""
    rng = np.random.default_rng(1600)
    lanes = rng.integers(0, 2**64, size=(64, 25), dtype=np.uint64)
    lanes[0], lanes[1] = 0, np.uint64(2**64 - 1)
    single, (even, odd), warp = _permute(lib, lanes, 1)
    plain = tk.keccak_f(torch.from_numpy(lanes.view(np.int64).T.copy())).T.numpy()
    np.testing.assert_array_equal(single.view(np.int64), plain)
    want_even, want_odd = _interleave(single)
    np.testing.assert_array_equal(even, want_even)
    np.testing.assert_array_equal(odd, want_odd)
    np.testing.assert_array_equal(warp, single)


def test_warp_permutation_chained_matches_keccak_f(lib):
    """1,200 Keccak-f in a row on the warp (emulated) and the pair, from
    random, all-zero and all-one states, against the one-thread
    keccak_f1600 chained as long and the plain torch keccak_f."""
    rng = np.random.default_rng(1201)
    lanes = rng.integers(0, 2**64, size=(4, 25), dtype=np.uint64)
    lanes[0], lanes[1] = 0, np.uint64(2**64 - 1)
    single, (even, odd), warp = _permute(lib, lanes, 1200)
    plain = torch.from_numpy(lanes.view(np.int64).T.copy())
    for _ in range(1200):
        plain = tk.keccak_f(plain)
    np.testing.assert_array_equal(single.view(np.int64), plain.T.numpy())
    np.testing.assert_array_equal(warp, single)
    want_even, want_odd = _interleave(single)
    np.testing.assert_array_equal(even, want_even)
    np.testing.assert_array_equal(odd, want_odd)


@pytest.mark.parametrize("team", SPONGE_TEAMS)
def test_sponge_thousand_blocks_match_hashlib(lib, team):
    """Messages of 1,000 to 1,103 rate blocks (up to 150,000 B), absorbed
    and squeezed (2,111 words: 62 blocks, the last part full) at each team
    (emulated), against hashlib's SHAKE256 and the one-thread state."""
    rng = np.random.default_rng(1103)
    lens = np.array([999 * tk.RATE + 5, 1000 * tk.RATE - 1, 150000], np.int32)
    rows = -(-(150000 + 1) // tk.RATE) * tk.RATE_WORDS
    by = rng.integers(0, 256, size=(lens.size, 4 * rows), dtype=np.uint8)
    by[np.arange(4 * rows)[None, :] >= lens[:, None]] = 0
    words = torch.from_numpy(by.view(np.int32).T.copy())
    padded, nblk = tk.pad_words(words, torch.from_numpy(lens), 0x1F, assume_clean=True)
    assert nblk.tolist() == [1000, 1000, 1103]
    state = _absorb(lib, padded, nblk, team)
    np.testing.assert_array_equal(state.numpy(), _absorb(lib, padded, nblk, 1).numpy())
    got = np.ascontiguousarray(_squeeze(lib, state, 2111, team).numpy().T).view(np.uint8)
    for i, n in enumerate(lens):
        assert got[i].tobytes() == shake_256(by[i, :n].tobytes()).digest(4 * 2111), int(n)


@pytest.mark.parametrize("pad_head", [0x1F, 0x06], ids=["shake256", "sha3_256"])
def test_sponge_lanes_rate_edges_and_longest(lib, pad_head):
    """Lengths 0, 135, 136, 137 and 42,787 bytes (315 blocks, the longest
    aggregation preimage at secpar 256, N = 4), each team, against the
    plain absorb and hashlib."""
    rng = np.random.default_rng(pad_head + 1)
    lens = np.array([0, 135, 136, 137, 42787], np.int32)
    rows = -(-(42787 + 1) // tk.RATE) * tk.RATE_WORDS
    by = rng.integers(0, 256, size=(lens.size, 4 * rows), dtype=np.uint8)
    by[np.arange(4 * rows)[None, :] >= lens[:, None]] = 0
    words = torch.from_numpy(by.view(np.int32).T.copy())
    padded, nblk = tk.pad_words(words, torch.from_numpy(lens), pad_head, assume_clean=True)
    assert nblk.tolist() == [1, 1, 2, 2, 315]
    want = tk.absorb_padded(padded, nblk)
    for team in SPONGE_TEAMS:
        state = _absorb(lib, padded, nblk, team)
        np.testing.assert_array_equal(state.numpy(), want.numpy())
        got = _squeeze(lib, state, 8, team).t().contiguous().view(torch.uint8).numpy()
        for i, n in enumerate(lens):
            msg = by[i, :n].tobytes()
            digest = shake_256(msg).digest(32) if pad_head == 0x1F else sha3_256(msg).digest()
            assert got[i].tobytes() == digest, (team, int(n))


@pytest.mark.parametrize("n_words", [1, 33, 34, 35, 68, 300])
def test_squeeze_pair_matches_plain_and_hashlib(lib, n_words):
    """The squeeze at a warp and at two threads a sponge (the warp and the
    pair emulated) and at one, into words pre-filled with -1: no
    permutation (n_words <= 34), a
    partial last block, exactly two blocks and nine; against the plain
    squeeze and hashlib, on states of messages across the rate edges."""
    rng = np.random.default_rng(n_words)
    lens = np.array([0, 1, 135, 136, 137, 300] + list(rng.integers(0, 400, 11)), np.int32)
    rows = -(-(400 + 1) // tk.RATE) * tk.RATE_WORDS
    by = rng.integers(0, 256, size=(lens.size, 4 * rows), dtype=np.uint8)
    by[np.arange(4 * rows)[None, :] >= lens[:, None]] = 0
    words = torch.from_numpy(by.view(np.int32).T.copy())
    state = tk.shake256_absorb_words(words, torch.from_numpy(lens))
    want = tk.shake256_squeeze_words(state, n_words)
    for team in SPONGE_TEAMS:
        got = _squeeze(lib, state, n_words, team)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    got = np.ascontiguousarray(got.numpy().T).view(np.uint8)
    for i, n in enumerate(lens):
        assert got[i].tobytes() == shake_256(by[i, :n].tobytes()).digest(4 * n_words), int(n)


def agg_inputs(plan, G, rank, seed):
    """int32 aggregates [G, rank, d]: centered values, a zero row, NTTs of
    sparse polynomials (weights below d), rows of the in-range int32 edges;
    over the Fusion prime also the out-of-range edges and a row of random
    int32 (the plain version's int64 stage sweep stays exact on those only
    for a modulus this close to 2**31)."""
    d, q = plan.degree, plan.modulus
    rng = np.random.default_rng(seed)
    x = rng.integers(-(q // 2), q // 2 + 1, size=(G, rank, d), dtype=np.int64)
    x[0, 0] = 0
    for k in range(min(4, rank - 1)):
        poly = np.zeros(d, np.int64)
        poly[rng.choice(d, size=k + 1, replace=False)] = rng.integers(1, q, size=k + 1)
        x[0, k + 1] = plan.field.to_centered(ntt_fwd_u(plan, torch.from_numpy(poly))).numpy()
    edges = [0, 1, -1, q // 2, -(q // 2)]
    x[1, 0, : len(edges)] = edges
    x[1, 1] = q // 2
    x[1, 2] = -(q // 2)
    if q == Q:
        x[1, 0, 5:13] = [q // 2 + 1, -(q // 2) - 1, q - 1, q, -q, -q - 1, 2**31 - 1, -(2**31)]
        x[1, 1] = -(2**31)
        x[1, 2] = 2**31 - 1
        x[-1, -1] = rng.integers(-(2**31), 2**31, size=d)
    return torch.from_numpy(x.astype(np.int32))


# d up to 256 over the Fusion prime (2d divides q - 1 up to d = 256); 512 and
# 1024 over 2013265921 = 15 * 2**27 + 1, also in (2**30, 2**31)
NTT_DEGREES = [(Q, 64, 23584283), (Q, 128, 128339038), (Q, 256, 3337519),
               (2013265921, 512, 341742893), (2013265921, 1024, 1340477990)]


@pytest.mark.parametrize("q,d,root", NTT_DEGREES)
def test_intt_norm_weight_rows_match_plain(lib, q, d, root):
    plan = make_plan(q, d, root)
    G, rank = 3, 7
    aggs = agg_inputs(plan, G, rank, d + 1)
    pub = np.random.default_rng(d).integers(-(q // 2), q // 2 + 1, size=(rank, d))
    table = agg_table(plan.field, pub, torch.device("cpu"))
    tw, tw_sh = plan.twiddles(True, torch.device("cpu"))
    observed = torch.full((G, d), -1, dtype=torch.int64)
    nrm = torch.full((G, rank), -1, dtype=torch.int32)
    wgt = torch.full((G, rank), -1, dtype=torch.int32)
    lib.host_agg_check(aggs.data_ptr(), G, rank, d, table.a_u.data_ptr(), table.a_sh.data_ptr(),
                       tw.data_ptr(), tw_sh.data_ptr(), plan.n_inv, plan.n_inv_shoup, q,
                       observed.data_ptr(), nrm.data_ptr(), wgt.data_ptr())
    want = agg_check_plain(plan, table, aggs)
    for got, exp in zip((observed, nrm, wgt), want):
        np.testing.assert_array_equal(got.numpy(), exp.numpy())
    assert int(wgt[0, 0]) == 0 and sorted(wgt[0, 1:5].tolist()) != [d] * 4


@pytest.mark.parametrize("q,d,root", NTT_DEGREES)
def test_ntt_rows_match_plain(lib, q, d, root):
    """Both I/O forms, both directions, through the warp network at every
    degree, on residues with rows of 0 and q-1 and on centered values with
    0, +-1 and +-(q-1)/2."""
    plan = make_plan(q, d, root)
    rng = np.random.default_rng(d + 2)
    u = rng.integers(0, q, size=(37, d), dtype=np.int64)
    u[0], u[1], u[2, :3] = 0, q - 1, [0, 1, q - 1]
    c = rng.integers(-(q // 2), q // 2 + 1, size=(37, d), dtype=np.int64)
    c[0], c[1, :5], c[2] = 0, [0, 1, -1, q // 2, -(q // 2)], -(q // 2)
    forms = [(lib.host_ntt_u, torch.from_numpy(u), tntt.ntt_fwd_u_plain, tntt.ntt_inv_u_plain),
             (lib.host_ntt_centered, torch.from_numpy(c.astype(np.int32)), tntt.ntt_fwd_plain,
              tntt.ntt_inv_plain)]
    def run(host, x, inverse):
        tw, tw_sh = plan.twiddles(bool(inverse), torch.device("cpu"))
        y = torch.full_like(x, -1)
        host(x.data_ptr(), y.data_ptr(), x.shape[0], d, tw.data_ptr(), tw_sh.data_ptr(),
             inverse, plan.n_inv, plan.n_inv_shoup, plan.modulus)
        return y

    for host, x, fwd, inv in forms:
        for inverse, plain in ((0, fwd), (1, inv)):
            np.testing.assert_array_equal(run(host, x, inverse).numpy(), plain(plan, x).numpy())
        np.testing.assert_array_equal(run(host, run(host, x, 0), 1).numpy(), x.numpy())


def _fold_inputs(params, B, seed):
    """Centered values with the edge cases 0, +-1, +-(q-1)/2 and the int32
    extremes; prehash digit words with ragged lengths 1..78 and stray bytes
    past each length (both versions must ignore them)."""
    d, q = params.degree, params.modulus
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(q // 2), q // 2 + 1, (3 * d, B), dtype=np.int64)
    edges = [0, 1, -1, q // 2, -(q // 2), 9, -10, 2**31 - 1, -(2**31)]
    vals[: len(edges), 0] = edges
    vals[:, 1] = 0
    vals[:, 2] = rng.integers(-9, 10, 3 * d)
    vals = torch.from_numpy(vals.astype(np.int32))
    lens = rng.integers(1, ds.PREHASH_W + 1, B).astype(np.int32)
    lens[:3] = [1, ds.PREHASH_W, 4]
    by = rng.integers(0, 256, (B, 4 * pf.PRE_ROWS), dtype=np.uint8)
    digits = rng.integers(ord("0"), ord("9") + 1, (B, 4 * pf.PRE_ROWS), dtype=np.uint8)
    live = np.arange(4 * pf.PRE_ROWS)[None, :] < lens[:, None]
    by = np.where(live, digits, by)
    pre_w = torch.from_numpy(by.view(np.int32).T.copy())
    return vals[: 2 * d].contiguous(), vals[2 * d :].contiguous(), pre_w, torch.from_numpy(lens)


@pytest.mark.parametrize("secpar", [128, 256])
def test_fold_lanes_match_plain(lib, secpar):
    params = fusion_setup(secpar, 3)
    B, N = 37, 3
    vk2d_t, c_hat_t, pre_w, pre_len = _fold_inputs(params, B, secpar)

    ta = ds.signer_fold_a_table(params)
    ch_words, vk_words = ta.widths
    chb = torch.full((ch_words, B), -1, dtype=torch.int32)  # every word must be written
    cht = torch.empty(B, dtype=torch.int32)
    vkb = torch.full((vk_words, B), -1, dtype=torch.int32)
    vkl = torch.empty(B, dtype=torch.int32)
    ops, pool = ta.on("cpu")
    lib.host_signer_fold_a(ops.data_ptr(), ops.shape[0], pool.data_ptr(), vk2d_t.data_ptr(),
                           pre_w.data_ptr(), pf.PRE_ROWS, pre_len.data_ptr(), B,
                           chb.data_ptr(), ch_words, cht.data_ptr(), vkb.data_ptr(),
                           vk_words, vkl.data_ptr())
    want = pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    for got, exp in zip((chb, cht, vkb, vkl), want):
        np.testing.assert_array_equal(got.numpy(), exp.numpy())

    tb_table = ds.signer_fold_b_table(params)
    (tri_words,) = tb_table.widths
    trib = torch.full((tri_words, B), -1, dtype=torch.int32)
    trit = torch.empty(B, dtype=torch.int32)
    ops, pool = tb_table.on("cpu")
    lib.host_signer_fold_b(ops.data_ptr(), ops.shape[0], pool.data_ptr(), vkb.data_ptr(),
                           vk_words, vkl.data_ptr(), pre_w.data_ptr(), pf.PRE_ROWS,
                           pre_len.data_ptr(), c_hat_t.data_ptr(), B, trib.data_ptr(),
                           tri_words, trit.data_ptr())
    want = pf.signer_fold_b_plain(params, vkb, vkl, pre_w, pre_len, c_hat_t)
    np.testing.assert_array_equal(trib.numpy(), want[0].numpy())
    np.testing.assert_array_equal(trit.numpy(), want[1].numpy())

    # agg_fold over G = 12 groups of N = 3 signers, the [Wtri, G*N] triple
    # buffer's lanes group-major, at the small tile and the kernel's own
    G = B // N
    tbuf = trib[:, : G * N].view(-1, G, N).transpose(1, 2)
    tlen = trit[: G * N].view(G, N).t()
    want = pf.agg_fold_plain(params, N, tbuf, tlen)
    for tile in (0, 1):
        out, total, _, _ = _host_agg_fold(lib, params, N, tbuf, tlen, tile)
        np.testing.assert_array_equal(out.numpy(), want[0].numpy())
        np.testing.assert_array_equal(total.numpy(), want[1].numpy())


def drift_fold_inputs(params, B, seed):
    """_fold_inputs with the widest drift a warp can see in its first tile:
    lane 0 renders every value as "0" and has 1 prehash digit, lane 1 renders
    every value in 11 bytes (-(q-1)/2) and has 78; lane 2 holds the int32
    edges and lane 3 small values (the first B of these lanes when B < 4).
    The prehash digits of lanes 32..63 end at most 17 words in (lane 33's
    exactly: one word into a second chunk of 16) and those of lanes 64..
    at most 16 (lane 64's exactly: a chunk with nothing after it)."""
    q = params.modulus
    vk2d_t, c_hat_t, pre_w, pre_len = _fold_inputs(params, max(B, 4), seed)
    for t in (vk2d_t, c_hat_t):
        t[:, 2] = t[:, 0]
        t[:, 3] = torch.from_numpy(np.random.default_rng(seed).integers(-9, 10, t.shape[0]))
        t[:, 0] = 0
        t[:, 1] = -(q // 2)
    pre_len[:2] = torch.tensor([1, ds.PREHASH_W], dtype=torch.int32)
    pre_len[32:64] = pre_len[32:64].clamp(max=71)
    pre_len[64:] = pre_len[64:].clamp(max=67)
    pre_len[33:34] = 68
    pre_len[64:65] = 64
    return tuple(t[..., :B].contiguous() for t in (vk2d_t, c_hat_t, pre_w, pre_len))


def _host_fold_tiles(lib, params, vk2d_t, c_hat_t, pre_w, pre_len, ring):
    """Both signer folds through their kernels' tile functions (a warp's 32
    lanes in lockstep, ``ring`` 0 for the kernels' ring, 1 for 32 rows), fold
    b on fold a's str(vk); every output pre-filled with -1 ->
    (ch_wbuf, ch_total, vk_buf, vk_len), (tri_wbuf, tri_total)."""
    B = vk2d_t.shape[-1]
    ta, tb = ds.signer_fold_a_table(params), ds.signer_fold_b_table(params)
    ch_words, vk_words = ta.widths
    (tri_words,) = tb.widths
    a = [torch.full(shape, -1, dtype=torch.int32)
         for shape in ((ch_words, B), (B,), (vk_words, B), (B,))]
    ops, pool = ta.on("cpu")
    lib.host_signer_fold_a_tiles(ops.data_ptr(), ops.shape[0], pool.data_ptr(),
                                 vk2d_t.data_ptr(), pre_w.data_ptr(), pf.PRE_ROWS,
                                 pre_len.data_ptr(), B, a[0].data_ptr(), ch_words,
                                 a[1].data_ptr(), a[2].data_ptr(), vk_words, a[3].data_ptr(), ring)
    b = [torch.full(shape, -1, dtype=torch.int32) for shape in ((tri_words, B), (B,))]
    ops, pool = tb.on("cpu")
    lib.host_signer_fold_b_tiles(ops.data_ptr(), ops.shape[0], pool.data_ptr(), a[2].data_ptr(),
                                 vk_words, a[3].data_ptr(), pre_w.data_ptr(), pf.PRE_ROWS,
                                 pre_len.data_ptr(), c_hat_t.data_ptr(), B, b[0].data_ptr(),
                                 tri_words, b[1].data_ptr(), ring)
    return a, b


@pytest.mark.parametrize("B", [69, 4])
@pytest.mark.parametrize("ring", [0, 1], ids=["kernel_ring", "ring32"])
@pytest.mark.parametrize("secpar", [128, 256])
def test_fold_tiles_match_plain(lib, secpar, ring, B):
    """The signer fold kernels' tiled walk (32 lanes in lockstep, whole rows
    staged in a ring) == the plain versions, every word of -1-filled outputs:
    a first tile whose lanes 0 and 1 drift far more than a ring apart (the
    laggard and leader paths, at the kernels' ring and at 32 rows), a last tile of B %
    32 lanes (B = 69; B = 4 is the lifecycle's one group)."""
    params = fusion_setup(secpar, 3)
    vk2d_t, c_hat_t, pre_w, pre_len = drift_fold_inputs(params, B, secpar + B)
    got_a, got_b = _host_fold_tiles(lib, params, vk2d_t, c_hat_t, pre_w, pre_len, ring)
    want_a = pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    for got, exp in zip(got_a, want_a):
        np.testing.assert_array_equal(got.numpy(), exp.numpy())
    want_b = pf.signer_fold_b_plain(params, want_a[2], want_a[3], pre_w, pre_len, c_hat_t)
    for got, exp in zip(got_b, want_b):
        np.testing.assert_array_equal(got.numpy(), exp.numpy())
    # lane 1 ran more than the kernels' 64-row ring ahead of lane 0
    assert int(want_a[3][1] - want_a[3][0]) > 4 * 64 * 4


def test_render_dec_halves_matches_str(lib):
    """The tiled walk's decimal render == str() on every power of ten and its
    neighbours, both signs, the int32 extremes, random int32, and every
    value of each 5-digit half (0..99,999, and 100,000 * h for every upper
    half h; one sign each)."""
    tens = [10**k + d for k in range(10) for d in (-2, -1, 0, 1, 2)]
    edges = [0, 2**31 - 1, -(2**31), -(2**31) + 1] + tens + [-t for t in tens]
    rnd = np.random.default_rng(13).integers(-(2**31), 2**31, 200_000)
    halves = np.concatenate([np.arange(100_000), -100_000 * np.arange(21_475)])
    v = np.concatenate([np.array([t for t in edges if -(2**31) <= t < 2**31]), rnd,
                        halves]).astype(np.int32)
    out = np.zeros((v.size, 16), np.uint8)
    lens = np.zeros(v.size, np.int32)
    lib.host_render_halves(v.ctypes.data, v.size, out.ctypes.data, lens.ctypes.data)
    for i, x in enumerate(v.tolist()):
        want = str(x).encode()
        assert lens[i] == len(want) and out[i, :len(want)].tobytes() == want, x


def _random_table(rng, d, n_ops, n_extras, masks):
    """A random op table over ``d`` value rows and ``n_extras`` extras:
    consts of 0..70 bytes, cells with separators of 0..8 bytes and 0..d
    values, extras; each op for a writer mask drawn from ``masks`` ->
    (ops int32[n, 6], pool int32[...])."""
    pool, ops = [], []

    def intern(data):
        at = len(pool)
        pool.extend(np.frombuffer(data + b"\0" * (-len(data) % 4), "<u4").view(np.int32).tolist())
        return at

    for _ in range(n_ops):
        kind, mask = rng.integers(0, 3), int(rng.choice(masks))
        if kind == ds.OP_CONST:
            data = bytes(rng.integers(1, 256, rng.integers(0, 71)).astype(np.uint8))
            ops.append((ds.OP_CONST, mask, intern(data), len(data), 0, 0))
        elif kind == ds.OP_CELLS:
            sep = bytes(rng.integers(1, 256, rng.integers(0, 9)).astype(np.uint8))
            i0 = int(rng.integers(0, d))
            count = int(rng.integers(0, d - i0 + 1))
            ops.append((ds.OP_CELLS, mask, intern(sep), len(sep), i0, count))
        else:
            ops.append((ds.OP_EXTRA, mask, int(rng.integers(0, n_extras)), 0, 0, 0))
    return np.array(ops, np.int32), np.array(pool or [0], np.int32)


def _concat_table(ops, pool, values, extras, writer):
    """Writer ``writer``'s bytes of each lane by concatenation: values
    int32[K, B], extras [(bytes uint8[B, n], lengths)]."""
    pool_b = pool.view(np.uint8)
    out = []
    for b in range(values.shape[1]):
        parts = []
        for kind, mask, a0, a1, a2, a3 in ops.tolist():
            if not (mask >> writer) & 1:
                continue
            if kind == ds.OP_CONST:
                parts.append(pool_b[4 * a0:4 * a0 + a1].tobytes())
            elif kind == ds.OP_CELLS:
                sep = pool_b[4 * a0:4 * a0 + a1].tobytes()
                parts += [sep + str(int(values[a2 + i, b])).encode() for i in range(a3)]
            else:
                by, ln = extras[a0]
                parts.append(by[b, :int(ln[b])].tobytes())
        out.append(b"".join(parts))
    return out


def _expected_words(want, width):
    exp = np.zeros((len(want), 4 * width), np.uint8)
    for b, w in enumerate(want):
        exp[b, :min(len(w), 4 * width)] = np.frombuffer(w[:4 * width], np.uint8)
    return exp.view(np.int32).T


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("fold", ["a", "b"])
def test_tile_walk_any_table(lib, fold, seed):
    """The tiled walk on random op tables (long separators, long consts,
    empty cells, extras of any length, widths that cut the content short)
    == byte concatenation, every word of -1-filled outputs, at the kernels'
    ring and at 32 rows; 69 lanes with the drift of drift_fold_inputs.
    Fold b's tile (one thread a lane) on tables of one writer; fold a's
    (two threads a lane, one per output) on ops for writer 1, 2 or both."""
    params = fusion_setup(128, 3)
    d, B = params.degree, 69
    rng = np.random.default_rng(seed)
    vk2d_t, c_hat_t, pre_w, pre_len = drift_fold_inputs(params, B, seed)
    by_pre = pre_w.t().contiguous().view(torch.uint8).numpy()
    if fold == "b":
        ops, pool = _random_table(rng, d, 12, 2, [1])
        vk_words = 40
        ex_len = torch.from_numpy(rng.integers(0, 4 * vk_words + 1, B).astype(np.int32))
        ex_len[:3] = torch.tensor([0, 4 * vk_words, 4 * 16 + 1], dtype=torch.int32)
        ex_buf = torch.from_numpy(rng.integers(-(2**31), 2**31, (vk_words, B)).astype(np.int32))
        by_ex = ex_buf.t().contiguous().view(torch.uint8).numpy()
        wants = [_concat_table(ops, pool, c_hat_t, [(by_ex, ex_len), (by_pre, pre_len)], 0)]
    else:
        ops, pool = _random_table(rng, 2 * d, 12, 1, [1, 2, 3])
        wants = [_concat_table(ops, pool, vk2d_t, [(by_pre, pre_len)], j) for j in (0, 1)]
    longest = max(len(w) for want in wants for w in want)
    for width in (-(-longest // 4) + 3, longest // 8):
        for ring in (0, 1):
            outs = [torch.full((width, B), -1, dtype=torch.int32) for _ in wants]
            totals = [torch.full((B,), -1, dtype=torch.int32) for _ in wants]
            if fold == "b":
                lib.host_signer_fold_b_tiles(ops.ctypes.data, ops.shape[0], pool.ctypes.data,
                                             ex_buf.data_ptr(), vk_words, ex_len.data_ptr(),
                                             pre_w.data_ptr(), pf.PRE_ROWS, pre_len.data_ptr(),
                                             c_hat_t.data_ptr(), B, outs[0].data_ptr(), width,
                                             totals[0].data_ptr(), ring)
            else:
                lib.host_signer_fold_a_tiles(ops.ctypes.data, ops.shape[0], pool.ctypes.data,
                                             vk2d_t.data_ptr(), pre_w.data_ptr(), pf.PRE_ROWS,
                                             pre_len.data_ptr(), B, outs[0].data_ptr(), width,
                                             totals[0].data_ptr(), outs[1].data_ptr(), width,
                                             totals[1].data_ptr(), ring)
            for out, total, want in zip(outs, totals, wants):
                np.testing.assert_array_equal(out.numpy(), _expected_words(want, width))
                np.testing.assert_array_equal(total.numpy(), [len(w) for w in want])


def _host_agg_fold(lib, params, N, tbuf, tlen, tile, prefix=False, grid_y=1):
    """agg_fold's blocks run serially (tile 0: 4 groups by 7 rows, 9 staged
    rows; tile 1: the kernel's geometry), outputs pre-filled with -1, with
    the prefix launch first when ``prefix`` (its scratch pre-filled with
    marks; the runs of a tile dealt to ``grid_y`` blocks) -> (out, total,
    staging passes, passes that staged each group's own window)."""
    table = ds.agg_fold_table(params, N)
    ops, pool = table.on("cpu")
    (out_words,) = table.widths
    G = tlen.shape[1]
    op_at = torch.from_numpy(pf.agg_op_at(table.ops)) if prefix else None
    scratch = torch.full((N, G), -7, dtype=torch.int32) if prefix else None
    out = torch.full((out_words, G), -1, dtype=torch.int32)
    total = torch.full((G,), -1, dtype=torch.int32)
    passes = torch.zeros(1, dtype=torch.int64)
    own = torch.zeros(1, dtype=torch.int64)
    lib.host_agg_fold(ops.data_ptr(), ops.shape[0], pool.data_ptr(), tbuf.data_ptr(),
                      tlen.data_ptr(), *tbuf.stride(), *tlen.stride(), tbuf.shape[0], G, out.data_ptr(), out_words, total.data_ptr(),
                      None if op_at is None else op_at.data_ptr(),
                      None if scratch is None else scratch.data_ptr(), grid_y, tile,
                      passes.data_ptr(), own.data_ptr())
    return out, total, int(passes), int(own)


def agg_triples(params, G, N, seed, signer_major, lens=None, device="cpu"):
    """Stand-in triples for agg_fold: random nonzero bytes, zero past each
    length, lengths over the triple's whole range [spec_min_total, out_max]
    (group 0's triple 0 the shortest, group 1's the longest, so the next
    triple's offset spreads across one tile by the whole range) unless
    ``lens`` int[G, N] is given; one buffer int32[Wtri, G*N] and lengths
    int32[G*N] (on ``device``), lanes group-major (g*N + k) or signer-major
    (k*G + g), as the views [Wtri, N, G] and [N, G] that agg_fold takes."""
    tri_spec = ds.triple_spec(params)
    lo, hi = ds.spec_min_total(tri_spec, [1]), tri_spec.out_max
    words = -(-hi // 4)
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(lo, hi + 1, (G, N))
        lens[0, 0], lens[min(1, G - 1), 0] = lo, hi
    lens = np.asarray(lens, np.int32)
    by = rng.integers(1, 256, (G, N, 4 * words), dtype=np.uint8)
    by[np.arange(4 * words)[None, None, :] >= lens[..., None]] = 0
    w = by.view(np.int32)  # [G, N, words]
    if signer_major:
        buf = torch.from_numpy(w.transpose(2, 1, 0).reshape(words, N * G).copy()).to(device)
        ln = torch.from_numpy(lens.T.reshape(-1).copy()).to(device)
        return buf.view(words, N, G), ln.view(N, G)
    buf = torch.from_numpy(w.transpose(2, 0, 1).reshape(words, G * N).copy()).to(device)
    ln = torch.from_numpy(lens.reshape(-1).copy()).to(device)
    return buf.view(words, G, N).transpose(1, 2), ln.view(G, N).t()


def agg_bytes_reference(params, N, tbuf, tlen):
    """The aggregation preimage by byte concatenation over the op table:
    (words int32[Wagg, G], totals int32[G])."""
    tbs, tls = tbuf.unbind(1), tlen.unbind(0)
    table = ds.agg_fold_table(params, N)
    pool = table.pool.view(np.uint8)
    (width,) = table.widths
    G = tlen.shape[1]
    out = np.zeros((G, 4 * width), np.uint8)
    totals = np.zeros(G, np.int32)
    for g in range(G):
        parts = []
        for kind, _, a0, a1, _, _ in table.ops:
            if kind == ds.OP_CONST:
                parts.append(pool[4 * a0:4 * a0 + a1].tobytes())
            else:
                n = int(tls[a0][g])
                parts.append(tbs[a0][:, g].contiguous().numpy().view(np.uint8)[:n].tobytes())
        data = b"".join(parts)
        totals[g] = len(data)
        out[g, :len(data)] = np.frombuffer(data, np.uint8)
    return torch.from_numpy(out.view(np.int32).T.copy()), torch.from_numpy(totals)


@pytest.mark.parametrize("signer_major", [False, True], ids=["group_major", "signer_major"])
@pytest.mark.parametrize("N", [1, 2, 3])
@pytest.mark.parametrize("secpar", [128, 256])
def test_agg_fold_tiles_match_plain(lib, secpar, N, signer_major):
    """agg_fold's block at 4 groups by 7 rows: G = 11 groups (not a multiple
    of the tile), a tile holding the shortest and the longest triple (the
    staged window spreads over many passes of 9 rows), outputs on -1."""
    params = fusion_setup(secpar, 5)
    tbuf, tlen = agg_triples(params, 11, N, 10 * secpar + N, signer_major)
    want = pf.agg_fold_plain(params, N, tbuf, tlen)
    out, total, passes, own = _host_agg_fold(lib, params, N, tbuf, tlen, 0)
    np.testing.assert_array_equal(out.numpy(), want[0].numpy())
    np.testing.assert_array_equal(total.numpy(), want[1].numpy())
    runs = -(-out.shape[0] // 7)
    assert passes > 2 * runs and not own  # the spread forced passes over sub-windows
    got1 = _host_agg_fold(lib, params, N, tbuf, tlen, 1)
    np.testing.assert_array_equal(got1[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got1[1].numpy(), want[1].numpy())


@pytest.mark.parametrize("tile", [0, 1])
def test_agg_fold_tiles_any_length(lib, tile):
    """Lengths outside the triple's range (0 to 7 bytes, the full width, and
    one past it, which the kernel clamps to the width) at N = 5, G = 6 and
    G = 1: every word equals byte concatenation over the op table."""
    params = fusion_setup(128, 6)
    full = 4 * -(-ds.triple_spec(params).out_max // 4)
    lens = [[0, 1, 2, 3, 5], [4, 0, 0, full, 1], [full, full, 0, 2, 3],
            [7, 6, 5, 4, 3], [0, 0, 0, 0, 0], [1, full, 1, full, 1]]
    for G in (1, 6):
        tbuf, tlen = agg_triples(params, G, 5, 7, True, lens[:G])
        want = agg_bytes_reference(params, 5, tbuf, tlen)
        got = _host_agg_fold(lib, params, 5, tbuf, tlen, tile)
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    tlen[3, 0] = full + 9  # signer 3 of group 0
    got = _host_agg_fold(lib, params, 5, tbuf, tlen, tile)
    tlen[3, 0] = full
    want = agg_bytes_reference(params, 5, tbuf, tlen)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


def _host_assemble(lib, spec, values, extras, pad_words=None, ring=None):
    """The plain one-thread walk over every lane (``ring`` None) or the
    assemble_spec kernel's tiles (``ring`` 0: the kernel's ring, 1: 32
    rows), outputs pre-filled with -1 (every word must be written)."""
    prog = ds.spec_table(spec, pad_words)
    ops, pool = prog.on("cpu")
    (width,) = prog.widths
    B = (values if values is not None else extras[0][0]).shape[-1]
    table = torch.tensor([[eb.data_ptr(), eb.stride(0), eb.stride(1), el.data_ptr(),
                           el.stride(0), eb.shape[0]] for eb, el in extras] or [[0] * 6],
                         dtype=torch.int64)
    out = torch.full((width, B), -1, dtype=torch.int32)
    total = torch.full((B,), -1, dtype=torch.int32)
    args = (ops.data_ptr(), ops.shape[0], pool.data_ptr(),
            None if values is None else values.data_ptr(),
            0 if values is None else values.stride(0), table.data_ptr(), B, out.data_ptr(),
            width, total.data_ptr())
    if ring is None:
        lib.host_assemble_spec(*args)
    else:
        lib.host_assemble_spec_tiles(*args, ring)
    return out, total


@pytest.mark.parametrize("secpar", [128, 256])
def test_assemble_spec_lanes_match_plain(lib, secpar):
    """The challenge spec (rate-padded), the triple spec and the aggregation
    spec over N = 3 strided triple views, against assemble_chunks_words."""
    params = fusion_setup(secpar, 4)
    B, N = 37, 3
    vk2d_t, c_hat_t, pre_w, pre_len = _fold_inputs(params, B, secpar + 7)
    pre_len[3] = 0  # an empty extra
    ch_spec, tri_spec = ds.challenge_preimage_spec(params), ds.triple_spec(params)
    pad = ds.signer_fold_a_table(params).widths[0]
    got = _host_assemble(lib, ch_spec, vk2d_t, [(pre_w, pre_len)], pad)
    want = ds.assemble_chunks_words(ch_spec, vk2d_t, [(pre_w, pre_len)], pad_words=pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    tvals = torch.cat([vk2d_t, c_hat_t])
    tb, tl = _host_assemble(lib, tri_spec, tvals, [(pre_w, pre_len)])
    want = ds.assemble_chunks_words(tri_spec, tvals, [(pre_w, pre_len)])
    np.testing.assert_array_equal(tb.numpy(), want[0].numpy())
    np.testing.assert_array_equal(tl.numpy(), want[1].numpy())

    G = B // N
    tbv = tb[:, : G * N].reshape(tb.shape[0], G, N)
    tlv = tl[: G * N].reshape(G, N)
    extras = [(tbv[:, :, k], tlv[:, k]) for k in range(N)]
    agg_spec = ds.agg_preimage_spec(params, N, tri_spec.out_max)
    got = _host_assemble(lib, agg_spec, None, extras)
    want = ds.assemble_chunks_words(agg_spec, None, extras)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("B", [69, 4])
@pytest.mark.parametrize("ring", [0, 1], ids=["kernel_ring", "ring32"])
@pytest.mark.parametrize("secpar", [128, 256])
def test_assemble_spec_tiles_match_plain(lib, secpar, ring, B):
    """The assemble_spec kernel's tiled walk (32 lanes in lockstep, whole
    rows staged in a ring) == assemble_chunks_words, every word of -1-filled
    outputs, at the kernel's ring and at 32 rows: the challenge spec
    (rate-padded) and the triple spec on a first tile whose lanes 0 and 1
    drift far more than a ring apart, and a last tile of B % 32 lanes
    (B = 4: one group); the aggregation spec over N = 3 strided views of
    the triples (23 groups, or 1; group 0 holds the shortest and the longest)."""
    params = fusion_setup(secpar, 4)
    vk2d_t, c_hat_t, pre_w, pre_len = drift_fold_inputs(params, B, secpar + B + 1)
    pre = [(pre_w, pre_len)]
    ch_spec, tri_spec = ds.challenge_preimage_spec(params), ds.triple_spec(params)
    pad = ds.signer_fold_a_table(params).widths[0]
    got = _host_assemble(lib, ch_spec, vk2d_t, pre, pad, ring)
    want = ds.assemble_chunks_words(ch_spec, vk2d_t, pre, pad_words=pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert int(want[1][1] - want[1][0]) > 4 * 64 * 4  # lane 1 ran a ring ahead of lane 0
    tvals = torch.cat([vk2d_t, c_hat_t])
    tb, tl = _host_assemble(lib, tri_spec, tvals, pre, None, ring)
    want = ds.assemble_chunks_words(tri_spec, tvals, pre)
    np.testing.assert_array_equal(tb.numpy(), want[0].numpy())
    np.testing.assert_array_equal(tl.numpy(), want[1].numpy())

    N = 3
    G = B // N
    tbv = tb[:, : G * N].reshape(tb.shape[0], G, N)
    tlv = tl[: G * N].reshape(G, N)
    extras = [(tbv[:, :, k], tlv[:, k]) for k in range(N)]
    agg_spec = ds.agg_preimage_spec(params, N, tri_spec.out_max)
    pad = ds.agg_fold_table(params, N).widths[0]
    got = _host_assemble(lib, agg_spec, None, extras, pad, ring)
    want = ds.assemble_chunks_words(agg_spec, None, extras, pad_words=pad)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("signer_major", [False, True], ids=["group_major", "signer_major"])
@pytest.mark.parametrize("tile,grid_y", [(0, 1), (0, 5), (1, 1), (1, 64)])
def test_agg_fold_prefix_tiles_match_plain(lib, tile, grid_y, signer_major):
    """agg_fold with prefix offsets at N = 64 signers (129 ops, more than
    either tile holds): G = 5 (a part-full tile at 4 groups by 7 rows), the
    triples over their whole range, the runs of a tile dealt to 1, 5 or 64
    blocks, so that runs start mid-table from a guess or from the run
    before; the prefix scratch starts as marks.  Every word and total
    equals the plain version's, and the walks from op 0 give the same."""
    params = fusion_setup(256, 5)
    N = 64
    tbuf, tlen = agg_triples(params, 5, N, 64 + tile, signer_major)
    want = pf.agg_fold_plain(params, N, tbuf, tlen)
    got = _host_agg_fold(lib, params, N, tbuf, tlen, tile, prefix=True, grid_y=grid_y)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert tile == 1 or got[3] > 0  # the tile spread past a pass: each group's own window
    if grid_y == 1:
        walked = _host_agg_fold(lib, params, N, tbuf, tlen, tile)
        np.testing.assert_array_equal(walked[0].numpy(), want[0].numpy())


@pytest.mark.parametrize("tile", [0, 1])
def test_agg_fold_prefix_any_length(lib, tile):
    """The prefix path on lengths outside the triple's range (empty triples
    side by side, full and over-full ones) at N = 40 and G = 3: every word
    equals byte concatenation over the op table."""
    params = fusion_setup(128, 6)
    full = 4 * -(-ds.triple_spec(params).out_max // 4)
    rng = np.random.default_rng(40)
    lens = rng.choice([0, 0, 1, 3, 4, 7, full, full + 9], size=(3, 40))
    lens[1] = 0
    tbuf, tlen = agg_triples(params, 3, 40, 9, True, np.minimum(lens, full))
    tlen.copy_(torch.from_numpy(lens.T.astype(np.int32)))
    want = agg_bytes_reference(params, 40, tbuf, torch.clamp(tlen, max=full))
    got = _host_agg_fold(lib, params, 40, tbuf, tlen, tile, prefix=True, grid_y=3)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_agg_last_op_at_from_any_guess(lib):
    """The op a run starts at, found from every guess (0, the last op, the
    answer, one past and before it, a random one), equals the last op whose
    offset is at most the byte, at every byte of every group (empty triples
    and consts included), N = 6."""
    params = fusion_setup(128, 6)
    N = 6
    table = ds.agg_fold_table(params, N)
    op_at = pf.agg_op_at(table.ops)
    lens = np.array([[5, 0, 0, 9, 1, 30], [0, 0, 0, 0, 0, 0], [12, 12, 12, 12, 12, 12]])
    G = len(lens)
    prefix = np.ascontiguousarray(np.cumsum(lens, axis=1).T.astype(np.int32))  # [N, G]
    n_ops = len(table.ops)
    rng = np.random.default_rng(6)
    for g in range(G):
        starts = [op_at[j, 0] + (prefix[op_at[j, 1] - 1, g] if op_at[j, 1] else 0)
                  for j in range(n_ops)]
        total = op_at[n_ops, 0] + prefix[N - 1, g]
        for b in range(total + 3):
            want = max(j for j in range(n_ops) if starts[j] <= b)
            for guess in (0, n_ops - 1, want, want + 1, want - 1, int(rng.integers(n_ops))):
                got = lib.host_agg_last_op_at(op_at.ctypes.data, prefix.ctypes.data, G, g,
                                              n_ops, b, guess)
                assert got == want, (g, b, guess)
