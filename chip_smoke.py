#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path through its public entry points at the full
secpar=256 configuration — ``build_fleet`` of G=8192 groups of N=4 signers
(32,768 one-time keys, aggregates int32[8192, 83, 256]) and grouped
``verify_batch_device`` — then the same two entry points in the ``"spec"``
assembly configuration, the batched lifecycle (keygen, sign, aggregate,
verify, verify_many, verify_batch) at the same widths, and the object API
(the KAT corpus and one lifecycle), after building every CUDA kernel of
those paths from ``fusion_cryptography_tpu_torch/csrc`` and holding each one
against its plain torch version at the paths' shapes (exact equality: all
integer).

Phases (each fails loudly; any failure exits non-zero):
  1. card, versions, kernel build (one nvcc per source, in parallel)
  2. kernels vs plain versions (the sponge on 4,096 lanes of 0..42,787 B,
     the rate edges among them, the squeeze at one and two threads a
     sponge, and vs hashlib), with timings and
     each kernel's bound (``fusion_cryptography_tpu_torch/bounds.py``);
     ``agg_fold`` on group-major and signer-major lanes, G = 8,192, 8,155
     and 1, outputs on memory filled with -1, one call with host syncs
     forbidden; ``intt_norm_weight`` (the aggregate check: observed
     sum and INTT + norm/weight in one pass) on int32 aggregates of the
     verify call's shape [8192, 83, 256] and of secpar=128's [1024, 195, 64],
     with every int32 edge value; the signer folds on -1-filled outputs at
     B = 32,768 (warp 0's lanes ~1,300 words apart), 32,731 and 4 lanes and
     at secpar=128; ``assemble_spec`` on the challenge, triple
     and aggregation specs of those synthetic inputs, at full width and 37
     lanes fewer, its outputs on memory filled with -1
  3. main path: fleet build (keys/s), verify: one warm call, per-call
     latency (median of 5 synced calls), 5 calls with one final sync; all
     verdicts true, a tampered aggregate fails in exactly its group;
     derive_coeffs_device on CUDA equals the CPU run (the kernels' plain
     versions) on 16 groups; one ``P.lattice`` call makes no host sync;
     ``keccak_absorb`` and ``keccak_squeeze`` at the three launches each
     of one verify call (prehash, challenge, aggregation; captured from the
     call), each equal to the plain absorb or squeeze at one and two
     threads per sponge on -1-filled outputs and timed beside its bound;
     the two signer fold kernels at the inputs of one verify call
     (captured from the call), each equal to its plain version on
     -1-filled outputs, and both timed beside their bounds on those inputs,
     the synthetic ones of phase 2, the same without edge values, without
     edge values or extreme lanes, and those at one group (back to back and
     alone)
  S. the "spec" assembly, with phase 3's fleet alive: build_fleet gives the
     same fleet, verify (the same measurements) gives all verdicts true and
     rejects a tampered aggregate in exactly its group, derive_coeffs_device
     equals the "fold" configuration's over all 8,192 groups; kernel
     ``assemble_spec`` runs twice per verify call, the signer folds never;
     then its two calls of one verify call (challenge and triple spec,
     captured) each equal the plain version on -1-filled outputs, timed
     beside their bounds
  L. lifecycle, with phase 3's fleet alive: keygen of the fleet's 32,768
     keys (vk equals the fleet's), sign of all of them, aggregate and verify
     of 64 groups one call each (each aggregate equals the fleet's), a
     tampered aggregate, verify_many over the 64 groups plus a tampered and
     a short group, verify_batch at G=8192 on the fleet's coefficients;
     CUDA equals the CPU for one group of 4 keys, with short and with long
     non-ASCII messages
  4. the secpar=128 lane (G=1024, N=4): all verdicts true, CUDA equals the
     CPU on 16 groups
  O. the object API on the card: ``kat.generate_corpus`` (seed 20260820, 3
     signers, both levels) byte-equal to all 18 files of
     ``KATs/reference_frozen``, ``kat.run_all`` on them all true; one
     ``api`` lifecycle of 4 keys at secpar=256 whose aggregate prints as
     ``lifecycle.aggregate``'s
  5. every kernel of each path (main, spec, lifecycle, object API) was
     launched while that path was driven (counts cleared just before each,
     read just after)

The last two lines of stdout are the kernel table {"kernels": [...]} and
{"ok": true, "device": {...}}; the card's name and power limit come just
before them.  Run from the repository root: ``python3 chip_smoke.py``.
``python3 chip_smoke.py --fold-times`` builds the kernels and a fleet and
prints only the signer folds' times on their five input sets.
"""
from __future__ import annotations

import filecmp
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from statistics import median

import numpy as np
import torch

from fusion_cryptography_tpu_torch import bounds

SEED = 42
SECPAR, N_GROUPS, N_SIGNERS = 256, 8192, 4
LANE128_GROUPS = 1024

MAIN_PATH_KERNELS = ("keccak_absorb", "keccak_squeeze", "intt_norm_weight",
                     "signer_fold_a", "signer_fold_b", "agg_fold", "ntt_u")
# the "spec" assembly: assemble_spec in place of the signer folds
SPEC_PATH_KERNELS = ("keccak_absorb", "keccak_squeeze", "intt_norm_weight", "agg_fold",
                     "ntt_u", "assemble_spec")
# the lifecycle: the main path's kernels and keygen's sk_hat = NTT(sk)
LIFECYCLE_KERNELS = MAIN_PATH_KERNELS + ("ntt_centered",)
# the object API: keygen and the challenge/coefficient NTTs, verify's pipeline
OBJECT_API_KERNELS = LIFECYCLE_KERNELS
ALL_KERNELS = LIFECYCLE_KERNELS + ("assemble_spec",)
LIFE_GROUPS = 64  # aggregate and verify calls of the lifecycle phase, one group each
REPO = Path(__file__).resolve().parent
FROZEN_KATS = REPO / "KATs" / "reference_frozen"
KAT_SEED, KAT_SIGNERS = 20260820, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events).
    The device first spins for ~0.5 ms, so a kernel shorter than its
    wrapper's host time is queued back to back and timed, not the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) if a.numel() else 0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sponge_inputs(rng, B: int, max_len: int, dev):
    """Random payloads int32[rows, B] (zero past each length) with lengths
    over [0, max_len], including the rate edges 135/136/137."""
    from fusion_cryptography_tpu_torch.ops.keccak import RATE

    lens = rng.integers(0, max_len + 1, size=B).astype(np.int32)
    lens[:6] = [0, 1, 135, 136, 137, max_len]
    rows = -(-(max_len + 1) // RATE) * RATE // 4
    by = torch.from_numpy(rng.integers(0, 256, size=(B, 4 * rows), dtype=np.uint8)).to(dev)
    by = torch.where(torch.arange(4 * rows, device=dev) < torch.from_numpy(lens).to(dev)[:, None],
                     by, 0).to(torch.uint8)
    words = by.contiguous().view(torch.int32).t().contiguous()
    return words, torch.from_numpy(lens).to(dev), by


def phase_kernels(dev, kernel_rows: list) -> None:
    from fusion_cryptography_tpu_torch.ops import keccak, keccak_sponge as ks

    rng = np.random.default_rng(SEED)
    # -- sponge at the aggregation preimage's width (42,787 B max, N=4) -----
    B = 4096
    words, lens, by = sponge_inputs(rng, B, 42787, dev)
    padded, nblk = ks._pad_words_lm(words, lens)
    st_k = ks.absorb(padded, nblk)
    st_p = keccak.absorb_padded(padded, nblk)
    err_a = max_abs_err(st_k, st_p)
    require(err_a == 0, "keccak_absorb != plain absorb")
    errs_s = []
    for n_bytes in (8423, 15872):
        nw = -(-n_bytes // 4)
        out_k = ks.squeeze(st_k, nw)
        out_p = keccak.shake256_squeeze_words(st_p, nw)
        errs_s.append(max_abs_err(out_k, out_p))
        require(errs_s[-1] == 0, f"keccak_squeeze != plain squeeze ({n_bytes} B)")
        for team in SPONGE_TEAMS:
            out_t = torch.full_like(out_p, -1)
            ks._squeeze_launch(st_k, nw, team, out_t)
            errs_s.append(max_abs_err(out_t, out_p))
            require(errs_s[-1] == 0, f"keccak_squeeze ({team} thread(s) a sponge, {n_bytes} B) "
                    "!= plain squeeze")
        got = out_k[:, :64].t().contiguous().view(torch.uint8).cpu().numpy()
        pay = by[:64].cpu().numpy()
        ln = lens[:64].cpu().numpy()
        for i in range(64):
            want = hashlib.shake_256(pay[i, : ln[i]].tobytes()).digest(n_bytes)
            require(got[i, :n_bytes].tobytes() == want, f"SHAKE256 lane {i} != hashlib")
    dig = ks.sha3_256_words_w(words[:, :64].contiguous(), lens[:64])
    got = dig.t().contiguous().view(torch.uint8).cpu().numpy()
    for i in range(64):
        want = hashlib.sha3_256(by[i, : int(lens[i])].cpu().numpy().tobytes()).digest()
        require(got[i].tobytes() == want, f"SHA3-256 lane {i} != hashlib")
    log(f"sponge: B={B}, lengths 0..42787 B: absorb and squeeze (8423, 15872 B; the squeeze "
        "at one and two threads a sponge too) equal the plain versions; 64 lanes equal "
        "hashlib shake_256/sha3_256")
    t_abs = cuda_ms(lambda: ks.absorb(padded, nblk), 3)
    t_abs_p = cuda_ms(lambda: keccak.absorb_padded(padded, nblk), 1)
    nw = -(-15872 // 4)
    t_sq = cuda_ms(lambda: ks.squeeze(st_k, nw), 5)
    t_sq_p = cuda_ms(lambda: keccak.shake256_squeeze_words(st_p, nw), 1)
    n_perm = int(nblk.to(torch.int64).sum().item())
    b_abs = bounds.keccak_absorb(nblk)
    b_sq = bounds.keccak_squeeze(B, nw)
    log(f"  keccak_absorb  {t_abs:.3f} ms  (plain {t_abs_p:.3f} ms, bound "
        f"{b_abs['bound_ms']:.4f} ms by {b_abs['bound_by']}: {n_perm} permutations)")
    log(f"  keccak_squeeze {t_sq:.3f} ms  (plain {t_sq_p:.3f} ms, bound "
        f"{b_sq['bound_ms']:.4f} ms by {b_sq['bound_by']})  [{nw} words]")
    # the rows' ms, plain_ms and bound are the verify call's three launches
    # (phase_sponge_shapes); these are the edge checks'
    kernel_rows += [
        dict(name="keccak_absorb", route="cuda",
             source="fusion_cryptography_tpu_torch/csrc/keccak_sponge.cu",
             replaces="fusion_cryptography_tpu/ops/keccak_pallas.py:81",
             max_abs_err=err_a, edge_ms=t_abs, edge_plain_ms=t_abs_p,
             edge_bound_ms=b_abs["bound_ms"], library_ms=None),
        dict(name="keccak_squeeze", route="cuda",
             source="fusion_cryptography_tpu_torch/csrc/keccak_sponge.cu",
             replaces="fusion_cryptography_tpu/ops/keccak_pallas.py:123",
             max_abs_err=max(errs_s), edge_ms=t_sq, edge_plain_ms=t_sq_p,
             edge_bound_ms=b_sq["bound_ms"], library_ms=None),
    ]
    del padded, words, by, st_k, st_p
    torch.cuda.empty_cache()


SPONGE_LAUNCHES = ("prehash", "challenge", "aggregation")
SPONGE_TEAMS = (1, 2)  # threads per sponge


def capture_sponges(params, fleet) -> tuple:
    """The arguments of the sponge calls of one ``verify_batch_device`` call
    on the fleet: ([(padded words, block counts)] of its absorb calls,
    [(state, n_words)] of its squeeze calls), each in call order."""
    from fusion_cryptography_tpu_torch.ops import keccak_sponge as ks
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    absorbs, squeezes = [], []
    absorb, squeeze = ks.absorb, ks.squeeze

    def record_absorb(words, n_blocks):
        absorbs.append((words.clone(), n_blocks.clone()))
        return absorb(words, n_blocks)

    def record_squeeze(state, n_words):
        squeezes.append((state.clone(), n_words))
        return squeeze(state, n_words)

    ks.absorb, ks.squeeze = record_absorb, record_squeeze
    try:
        dp.verify_batch_device(params, *fleet)
        torch.cuda.synchronize()
    finally:
        ks.absorb, ks.squeeze = absorb, squeeze
    for name, calls in (("absorb", absorbs), ("squeeze", squeezes)):
        require(len(calls) == len(SPONGE_LAUNCHES),
                f"a verify call made {len(calls)} {name} launches, not {len(SPONGE_LAUNCHES)}")
    return absorbs, squeezes


def sum_launches(row: dict, shapes: list, errs: list) -> None:
    """A sponge kernel's row: ms, plain_ms and bound_ms summed over the
    verify call's launches (``shapes``), bound_by that of the larger
    share of the bound."""
    total = {k: sum(sh[k] for sh in shapes) for k in ("ms", "plain_ms", "bound_ms")}
    bound_by = max(("bytes", "operations"),
                   key=lambda k: sum(sh["bound_ms"] for sh in shapes if sh["bound_by"] == k))
    row.update(max_abs_err=max(errs), bound_by=bound_by, shapes=shapes, **total)
    log(f"{row['name']} over the verify call's three launches: {total['ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['ms'] / total['bound_ms']:.2f}x)")


def phase_sponge_shapes(params, fleet, kernel_rows: list) -> None:
    """Kernels ``keccak_absorb`` and ``keccak_squeeze`` at the verify call's
    own launches: the arguments of its three ``absorb`` calls (padded words,
    block counts) and three ``squeeze`` calls (state, words) -- prehash
    SHA3-256, challenge and aggregation SHAKE256 -- captured from one
    ``verify_batch_device`` call on the fleet; each held exactly against the
    plain absorb or squeeze at one and two threads per sponge (each into an
    output pre-filled with -1) and through the wrapper, and timed beside
    its bound (for the absorb also its permutations and the idle-lane ratio
    of one and two threads per sponge).  Each row's ms, plain_ms and
    bound_ms become the sums over the three launches at the wrapper's
    choice."""
    from fusion_cryptography_tpu_torch.ops import keccak, keccak_sponge as ks

    absorbs, squeezes = capture_sponges(params, fleet)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = next(r for r in kernel_rows if r["name"] == "keccak_absorb")
    shapes, errs = [], [row["max_abs_err"]]
    for label, (padded, nblk) in zip(SPONGE_LAUNCHES, absorbs):
        B = nblk.numel()
        torch.cuda.synchronize()
        t0 = time.time()
        want = keccak.absorb_padded(padded, nblk)
        torch.cuda.synchronize()
        t_plain = (time.time() - t0) * 1e3
        team_ms = {}
        for team in SPONGE_TEAMS:
            state = torch.full((50, B), -1, dtype=torch.int32, device=padded.device)
            ks._absorb_launch(padded, nblk, team, state)
            errs.append(max_abs_err(state, want))
            require(errs[-1] == 0, f"keccak_absorb ({label}, {team} thread(s) a sponge) "
                    "!= plain absorb")
            team_ms[team] = cuda_ms(lambda: ks._absorb_launch(padded, nblk, team, state), 5)
        errs.append(max_abs_err(ks.absorb(padded, nblk), want))
        require(errs[-1] == 0, f"keccak_absorb ({label}, wrapper) != plain absorb")
        team = ks.absorb_team(B, sms)
        t_k = cuda_ms(lambda: ks.absorb(padded, nblk), 5)
        b = bounds.keccak_absorb(nblk)
        shape = dict(launch=label, lanes=B, max_blocks=padded.shape[0] // keccak.RATE_WORDS,
                     longest=int(nblk.max()), permutations=int(nblk.to(torch.int64).sum()),
                     team=team, ms=t_k, plain_ms=t_plain, **b,
                     warp_ratio_team1=bounds.keccak_warp_ratio(nblk, 32),
                     warp_ratio_team2=bounds.keccak_warp_ratio(nblk, 16),
                     team1_ms=team_ms[1], team2_ms=team_ms[2])
        shapes.append(shape)
        log(f"keccak_absorb, the verify call's {label} launch: B={B}, {shape['longest']} blocks "
            f"at most, {shape['permutations']} permutations: both teams equal the plain "
            f"absorb; wrapper ({team} thread(s) per sponge) {t_k:.4f} ms, plain "
            f"{t_plain:.1f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({t_k / b['bound_ms']:.2f}x); warp ratio {shape['warp_ratio_team1']:.4f} (1 thread) "
            f"/ {shape['warp_ratio_team2']:.4f} (2 threads)")
        log(f"  one thread a sponge {team_ms[1]:.4f} ms, two {team_ms[2]:.4f} ms")
        del want
    sum_launches(row, shapes, errs)

    row = next(r for r in kernel_rows if r["name"] == "keccak_squeeze")
    shapes, errs = [], [row["max_abs_err"]]
    for label, (state, n_words) in zip(SPONGE_LAUNCHES, squeezes):
        B = state.shape[1]
        torch.cuda.synchronize()
        t0 = time.time()
        want = keccak.shake256_squeeze_words(state, n_words)
        torch.cuda.synchronize()
        t_plain = (time.time() - t0) * 1e3
        team_ms = {}
        for team in SPONGE_TEAMS:
            out = torch.full((n_words, B), -1, dtype=torch.int32, device=state.device)
            ks._squeeze_launch(state, n_words, team, out)
            errs.append(max_abs_err(out, want))
            require(errs[-1] == 0, f"keccak_squeeze ({label}, {team} thread(s) a sponge) "
                    "!= plain squeeze")
            team_ms[team] = cuda_ms(lambda: ks._squeeze_launch(state, n_words, team, out), 5)
        errs.append(max_abs_err(ks.squeeze(state, n_words), want))
        require(errs[-1] == 0, f"keccak_squeeze ({label}, wrapper) != plain squeeze")
        team = ks.squeeze_team(B, n_words, sms)
        t_k = cuda_ms(lambda: ks.squeeze(state, n_words), 5)
        b = bounds.keccak_squeeze(B, n_words)
        shape = dict(launch=label, lanes=B, words=n_words,
                     permutations=B * (-(-n_words // keccak.RATE_WORDS) - 1), team=team,
                     ms=t_k, plain_ms=t_plain, **b, team1_ms=team_ms[1], team2_ms=team_ms[2])
        shapes.append(shape)
        log(f"keccak_squeeze, the verify call's {label} launch: B={B}, {n_words} words, "
            f"{shape['permutations']} permutations: both teams equal the plain squeeze; "
            f"wrapper ({team} thread(s) per sponge) {t_k:.4f} ms, plain {t_plain:.1f} ms, "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({t_k / b['bound_ms']:.2f}x)")
        log(f"  one thread a sponge {team_ms[1]:.4f} ms, two {team_ms[2]:.4f} ms")
        del want
    sum_launches(row, shapes, errs)
    del absorbs, squeezes
    torch.cuda.empty_cache()


def agg_edge_inputs(plan, G: int, rank: int, dev) -> torch.Tensor:
    """Seeded int32 aggregates [G, rank, d] on the card: centered values,
    all-zero rows, NTTs of sparse polynomials (weights below d), a row of
    every in-range and out-of-range int32 edge, rows of -2**31 and of
    2**31 - 1, and a group of random int32."""
    from fusion_cryptography_tpu_torch.ops import ntt

    d, q = plan.degree, plan.modulus
    g = torch.Generator(device=dev).manual_seed(SEED + d)
    aggs = (torch.randint(0, q, (G, rank, d), dtype=torch.int64, device=dev, generator=g)
            - q // 2).to(torch.int32)
    aggs[::97, 0] = 0
    edges = [0, 1, -1, q // 2, -(q // 2), q // 2 + 1, -(q // 2) - 1, q - 1, q, -q, -q - 1,
             2**31 - 1, -(2**31)]
    aggs[1, 0, : len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
    aggs[1, 1], aggs[1, 2] = -(2**31), 2**31 - 1
    aggs[2] = torch.randint(-(2**31), 2**31, (rank, d), dtype=torch.int64, device=dev,
                            generator=g).to(torch.int32)
    sparse = torch.zeros((4, d), dtype=torch.int32, device=dev)
    for k in range(4):
        sparse[k, torch.randperm(d, device=dev, generator=g)[: k + 1]] = 12345 + k
    aggs[3, :4] = ntt.ntt_fwd(plan, sparse)
    return aggs


def phase_agg_check(dev, kernel_rows: list) -> None:
    """Kernel ``intt_norm_weight`` (the observed sum A·agg fused with the
    INTT + norm/weight) at the verify call's own shape, int32 aggregates
    [8192, 83, 256] (696 MB), and at secpar=128's [1024, 195, 64]; each
    against ``agg_check_plain``, exactly, on inputs with every edge value."""
    from fusion_cryptography_tpu_torch.ops.intt_norm_weight import (
        agg_check, agg_check_plain, agg_table)
    from fusion_cryptography_tpu_torch.params import fusion_setup

    errs = []
    for secpar, G in ((SECPAR, N_GROUPS), (128, LANE128_GROUPS)):
        params = fusion_setup(secpar, SEED)
        plan, rank, d = params.plan, params.rank, params.degree
        table = agg_table(plan.field, params.public_challenge, dev)
        aggs = agg_edge_inputs(plan, G, rank, dev)
        got = agg_check(plan, table, aggs)
        want = agg_check_plain(plan, table, aggs)
        errs.append(max(max_abs_err(x, y) for x, y in zip(got, want)))
        require(errs[-1] == 0, f"intt_norm_weight != agg_check_plain (secpar={secpar})")
        require(int(got[2][0, 0]) == 0 and int(got[1][0, 0]) == 0,
                "zero row must give norm 0, weight 0")
        require(int(got[2][3, :4].max()) < d, "sparse rows must weigh less than d")
        log(f"intt_norm_weight: aggregates int32[{G}, {rank}, {d}] (secpar={secpar}, every "
            "int32 edge) equal agg_check_plain (observed sums, norms, weights)")
        del got, want
        if secpar != SECPAR:
            continue
        t_k = cuda_ms(lambda: agg_check(plan, table, aggs), 10)
        t_p = cuda_ms(lambda: agg_check_plain(plan, table, aggs), 1)
        rows = G * rank
        b_k = bounds.agg_check(G, rank, d)
        log(f"  intt_norm_weight {t_k:.3f} ms  (plain {t_p:.3f} ms, bound "
            f"{b_k['bound_ms']:.4f} ms by {b_k['bound_by']})  [{rows} rows]")
        row = dict(name="intt_norm_weight", route="cuda",
                   source="fusion_cryptography_tpu_torch/csrc/intt_norm_weight.cu",
                   replaces="fusion_cryptography_tpu/ops/ntt_mxu_pallas.py:174",
                   ms=t_k, plain_ms=t_p, **b_k, library_ms=None)
        del aggs
        torch.cuda.empty_cache()
    row["max_abs_err"] = max(errs)
    kernel_rows.append(row)
    torch.cuda.empty_cache()


def phase_ntt_kernels(dev, kernel_rows: list) -> None:
    """The two NTT kernels: ``ntt_u`` on the signer stage's residues
    [32,768, 256], ``ntt_centered`` on keygen's centered int32 [65,536, 256]
    (32,768 keys x 2 sides); forward (the direction the paths run) and
    inverse, each against its plain version."""
    from fusion_cryptography_tpu_torch.ops import ntt
    from fusion_cryptography_tpu_torch.params import fusion_setup

    plan = fusion_setup(SECPAR, SEED).plan
    d, q = plan.degree, plan.modulus
    B = N_GROUPS * N_SIGNERS
    g = torch.Generator(device=dev).manual_seed(SEED)
    u = torch.randint(0, q, (B, d), dtype=torch.int64, device=dev, generator=g)
    u[0], u[1] = 0, q - 1
    c = (torch.randint(0, q, (2 * B, d), dtype=torch.int64, device=dev, generator=g)
         - q // 2).to(torch.int32)
    c[0, :5] = torch.tensor([0, 1, -1, q // 2, -(q // 2)], dtype=torch.int32)
    c[1], c[2], c[3] = 0, -(q // 2), q // 2
    cases = [
        ("ntt_u", "fusion_cryptography_tpu/ops/ntt_mxu_pallas.py:87", u, 16,
         ntt.ntt_fwd_u, ntt.ntt_fwd_u_plain, ntt.ntt_inv_u, ntt.ntt_inv_u_plain),
        ("ntt_centered", "fusion_cryptography_tpu/ops/ntt_pallas.py:94", c, 8,
         ntt.ntt_fwd, ntt.ntt_fwd_plain, ntt.ntt_inv, ntt.ntt_inv_plain),
    ]
    for name, replaces, x, bytes_per_coef, fwd, fwd_p, inv, inv_p in cases:
        y = fwd(plan, x)
        err = max(max_abs_err(y, fwd_p(plan, x)), max_abs_err(inv(plan, y), inv_p(plan, y)))
        require(err == 0, f"{name} != plain version")
        require(torch.equal(inv(plan, y), x), f"{name}: inverse(forward(x)) != x")
        t_f = cuda_ms(lambda: fwd(plan, x), 20)
        t_fp = cuda_ms(lambda: fwd_p(plan, x), 3)
        t_i = cuda_ms(lambda: inv(plan, y), 20)
        t_ip = cuda_ms(lambda: inv_p(plan, y), 3)
        rows = x.numel() // d
        b_f = bounds.ntt(rows, d, bytes_per_coef)
        b_i = bounds.ntt(rows, d, bytes_per_coef, inverse=True)
        log(f"{name}: [{rows}, {d}] {x.dtype} forward and inverse equal the plain versions; "
            f"forward {t_f:.3f} ms (plain {t_fp:.3f} ms, bound {b_f['bound_ms']:.4f} ms by "
            f"{b_f['bound_by']}), inverse {t_i:.3f} ms (plain {t_ip:.3f} ms, bound "
            f"{b_i['bound_ms']:.4f} ms)")
        kernel_rows.append(dict(
            name=name, route="cuda", source="fusion_cryptography_tpu_torch/csrc/ntt.cu",
            replaces=replaces, max_abs_err=err, ms=t_f, plain_ms=t_fp, **b_f, library_ms=None,
            inverse_ms=t_i, inverse_plain_ms=t_ip, inverse_bound_ms=b_i["bound_ms"]))
    del u, c, y
    torch.cuda.empty_cache()


def fold_inputs(params, B: int, dev, edge_share: float = 0.05, extremes: bool = True):
    """Seeded lanes at the signer stage's shapes: centered values with 0,
    +-1 and +-(q-1)/2 among them (a share ``edge_share`` of the values),
    prehash digits of 1..78 bytes; with ``extremes`` lane 0 renders every
    value as "0" with one digit (the shortest triple), lane 1 every value as
    -(q-1)/2 with 78 digits (the longest): in str(vk) these two lanes drift
    ~1,300 words apart, far more than the fold kernels' 64-row rings."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf

    d, q = params.degree, params.modulus
    rng = np.random.default_rng(SEED + d)
    vals = rng.integers(-(q // 2), q // 2 + 1, (3 * d, B), dtype=np.int64)
    edge = rng.random((3 * d, B)) < edge_share
    vals[edge] = rng.choice([0, 1, -1, q // 2, -(q // 2)], size=int(edge.sum()))
    lens = rng.integers(1, ds.PREHASH_W + 1, B).astype(np.int32)
    if extremes:
        vals[:, 0] = 0
        vals[:, 1] = -(q // 2)
        lens[:2] = [1, ds.PREHASH_W]
    by = rng.integers(ord("0"), ord("9") + 1, (B, 4 * pf.PRE_ROWS), dtype=np.uint8)
    by[np.arange(4 * pf.PRE_ROWS)[None, :] >= lens[:, None]] = 0
    vals = torch.from_numpy(vals.astype(np.int32)).to(dev)
    return (vals[: 2 * d].contiguous(), vals[2 * d :].contiguous(),
            torch.from_numpy(by.view(np.int32).T.copy()).to(dev), torch.from_numpy(lens).to(dev))


def check_signer_folds(params, vk2d_t, c_hat_t, pre_w, pre_len, label: str) -> int:
    """Both signer fold kernels == their plain versions, every word and
    length, each into outputs pre-filled with -1 (fold b on the kernel's
    str(vk)) -> the largest absolute error (0)."""
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf

    want_a = pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)
    got_a = pf._signer_fold_a_launch(params, vk2d_t, pre_w, pre_len,
                                     [torch.full_like(w, -1) for w in want_a])
    err = max(max_abs_err(x, y) for x, y in zip(got_a, want_a))
    require(err == 0, f"signer_fold_a ({label}) != plain version")
    want_b = pf.signer_fold_b_plain(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t)
    got_b = pf._signer_fold_b_launch(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t,
                                     [torch.full_like(w, -1) for w in want_b])
    err = max([err] + [max_abs_err(x, y) for x, y in zip(got_b, want_b)])
    require(err == 0, f"signer_fold_b ({label}) != plain version")
    return err


def phase_fold_kernels(dev, kernel_rows: list) -> None:
    """The two signer fold kernels at the main path's shapes: B = G*N =
    32,768 signer lanes (warp 0 with the widest drift, :func:`fold_inputs`),
    held exactly against their plain versions on -1-filled outputs at B,
    B - 37 and 4 lanes and at secpar=128 (B - 37), and timed on these
    synthetic inputs (their times at the verify call's own inputs come from
    :func:`phase_fold_shapes`); then ``agg_fold`` on their triples
    (:func:`phase_agg_fold`)."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf
    from fusion_cryptography_tpu_torch.params import fusion_setup

    params = fusion_setup(SECPAR, SEED)
    d, G, N = params.degree, N_GROUPS, N_SIGNERS
    B = G * N
    vk2d_t, c_hat_t, pre_w, pre_len = fold_inputs(params, B, dev)
    errs = []
    for cut in (B, B - 37, 4):
        errs.append(check_signer_folds(params, *(t[..., :cut].contiguous() for t in (
            vk2d_t, c_hat_t, pre_w, pre_len)), f"B={cut}"))
    p128 = fusion_setup(128, SEED)
    errs.append(check_signer_folds(p128, *fold_inputs(p128, B - 37, dev), "secpar=128"))
    got_a = pf.signer_fold_a(params, vk2d_t, pre_w, pre_len)
    got_b = pf.signer_fold_b(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t)
    want_b = pf.signer_fold_b_plain(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t)
    require(all(torch.equal(x, y) for x, y in zip(got_b, want_b)), "signer_fold_b wrapper")
    del want_b
    tri_spec = ds.triple_spec(params)
    tri_min = ds.spec_min_total(tri_spec, [1])
    tlen = got_b[1]
    require(int(tlen[0]) == tri_min and int(tlen[1]) == tri_spec.out_max,
            f"triple lengths {int(tlen[0])}, {int(tlen[1])} must span "
            f"{tri_min}..{tri_spec.out_max}")
    vk_drift = int(got_a[3][1] - got_a[3][0]) // 4
    log(f"folds: B={B}, {B - 37} and 4 lanes (secpar={SECPAR}) and {B - 37} (secpar=128), "
        f"triples of {int(tlen.min())}..{int(tlen.max())} B, warp 0's lanes 0 and 1 "
        f"{vk_drift} words apart in str(vk): signer_fold_a and signer_fold_b equal their "
        "plain versions on -1-filled outputs (every word, zero tails included)")

    cases = [
        ("signer_fold_a", "fusion_cryptography_tpu/ops/fold_pallas.py:502",
         lambda: pf.signer_fold_a(params, vk2d_t, pre_w, pre_len),
         lambda: pf.signer_fold_a_plain(params, vk2d_t, pre_w, pre_len)),
        ("signer_fold_b", "fusion_cryptography_tpu/ops/fold_pallas.py:587",
         lambda: pf.signer_fold_b(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t),
         lambda: pf.signer_fold_b_plain(params, got_a[2], got_a[3], pre_w, pre_len, c_hat_t)),
    ]
    for name, replaces, kernel, plain in cases:
        t_p = cuda_ms(plain, 2)
        kernel_rows.append(dict(
            name=name, route="cuda",
            source="fusion_cryptography_tpu_torch/csrc/preimage_fold.cu",
            replaces=replaces, max_abs_err=max(errs), plain_ms=t_p, library_ms=None))
    del vk2d_t, c_hat_t, pre_w
    phase_agg_fold(params, got_b[0], tlen, dev, kernel_rows)
    del got_a, got_b
    torch.cuda.empty_cache()


def launch_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` launched alone, ``reps`` times (CUDA
    events around each launch, the device idle before it): no launch
    overlaps the tail of the one before, as in a verify call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return median(times)


def capture_signer_folds(params, fleet) -> dict:
    """The arguments of the signer fold calls of one ``verify_batch_device``
    call on the fleet: {"signer_fold_a": (vk2d_t, pre_w, pre_len),
    "signer_fold_b": (vk_buf, vk_len, pre_w, pre_len, c_hat_t)}."""
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    captured: dict = {}
    saved = {name: getattr(pf, name) for name in ("signer_fold_a", "signer_fold_b")}

    def recorder(name):
        def record(p, *args):
            captured.setdefault(name, []).append(tuple(a.clone() for a in args))
            return saved[name](p, *args)
        return record

    for name in saved:
        setattr(pf, name, recorder(name))
    try:
        dp.verify_batch_device(params, *fleet)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(pf, name, fn)
    require(sorted(captured) == sorted(saved) and all(len(v) == 1 for v in captured.values()),
            f"a verify call made signer fold calls {[(k, len(v)) for k, v in captured.items()]}")
    return {name: calls[0] for name, calls in captured.items()}


def signer_fold_times(params, fleet, dev) -> dict:
    """Both signer fold kernels timed on five input sets, each back to back
    (``cuda_ms``, 10 launches) and alone (``launch_ms``, median of 5): the
    verify call's own inputs (captured from one call on the fleet), the
    synthetic ones of :func:`fold_inputs`, the same without edge values,
    and without edge values or the two extreme lanes (uniform centered
    values, random prehash lengths), and those uniform ones at one group
    (B = 4, the lifecycle's single-group calls), with each set's bound;
    at the verify call's inputs also the wrapper's host time per call
    (50 calls without a sync) -> {kernel: {set: {"ms", "alone_ms",
    "bound_ms", "bound_by"[, "host_ms"]}}}.  Uses only the public wrappers."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf

    d, B = params.degree, fleet[0].shape[0] * fleet[0].shape[1]
    ch_w, vk_w = ds.signer_fold_a_table(params).widths
    (tri_w,) = ds.signer_fold_b_table(params).widths
    captured = capture_signer_folds(params, fleet)
    sets = {"verify_call": (captured["signer_fold_a"], captured["signer_fold_b"])}
    for label, share, extremes, lanes in (("synthetic", 0.05, True, B),
                                          ("synthetic_no_edges", 0.0, True, B),
                                          ("synthetic_uniform", 0.0, False, B),
                                          ("one_group", 0.0, False, fleet[0].shape[1])):
        vk2d_t, c_hat_t, pre_w, pre_len = fold_inputs(params, lanes, dev, share, extremes)
        _, _, vkb, vkl = pf.signer_fold_a(params, vk2d_t, pre_w, pre_len)
        sets[label] = ((vk2d_t, pre_w, pre_len), (vkb, vkl, pre_w, pre_len, c_hat_t))
    out: dict = {"signer_fold_a": {}, "signer_fold_b": {}}
    for label, (args_a, args_b) in sets.items():
        run_a = lambda: pf.signer_fold_a(params, *args_a)  # noqa: E731
        run_b = lambda: pf.signer_fold_b(params, *args_b)  # noqa: E731
        bounds_of = {"signer_fold_a": bounds.signer_fold_a(d, args_a[2], ch_w, vk_w),
                     "signer_fold_b": bounds.signer_fold_b(d, args_b[1], args_b[3], tri_w)}
        for name, run in (("signer_fold_a", run_a), ("signer_fold_b", run_b)):
            out[name][label] = dict(ms=cuda_ms(run, 10), alone_ms=launch_ms(run, 5),
                                    **bounds_of[name])
            if label == "verify_call":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(50):
                    run()
                out[name][label]["host_ms"] = (time.perf_counter() - t0) / 50 * 1e3
                torch.cuda.synchronize()
    del sets, captured
    torch.cuda.empty_cache()
    for name, by_set in out.items():
        log(f"{name} by input set (back to back / alone, bound): " + "; ".join(
            f"{label} {t['ms']:.4f} / {t['alone_ms']:.4f} ms ({t['bound_ms']:.4f} ms by "
            f"{t['bound_by']}, {t['ms'] / t['bound_ms']:.2f}x)" for label, t in by_set.items())
            + f"; the wrapper's host time {by_set['verify_call']['host_ms']:.4f} ms a call")
    return out


def phase_fold_shapes(params, fleet, kernel_rows: list) -> None:
    """The signer fold kernels at the verify call's own inputs: each captured
    call held exactly against the plain version on -1-filled outputs, then
    :func:`signer_fold_times`.  Each row's ms and bound are the verify
    call's inputs' (back to back), beside the synthetic inputs' and the
    other sets' under ``by_inputs``."""
    captured = capture_signer_folds(params, fleet)
    vk2d_t, pre_w, pre_len = captured["signer_fold_a"]
    c_hat_t = captured["signer_fold_b"][4]
    err = check_signer_folds(params, vk2d_t, c_hat_t, pre_w, pre_len, "the verify call's inputs")
    del captured, vk2d_t, pre_w, pre_len, c_hat_t
    log("signer folds at the inputs of one verify call (captured): both equal their plain "
        "versions on -1-filled outputs")
    times = signer_fold_times(params, fleet, fleet[0].device)
    for name, by_set in times.items():
        row = next(r for r in kernel_rows if r["name"] == name)
        own = by_set["verify_call"]
        row.update(ms=own["ms"], bound_ms=own["bound_ms"], bound_by=own["bound_by"],
                   synthetic_ms=by_set["synthetic"]["ms"],
                   synthetic_bound_ms=by_set["synthetic"]["bound_ms"], by_inputs=by_set,
                   max_abs_err=max(row["max_abs_err"], err))


def phase_agg_fold(params, tri_buf: torch.Tensor, tri_len: torch.Tensor, dev,
                   kernel_rows: list) -> None:
    """Kernel ``agg_fold`` on G = 8,192 groups of N = 4 triples (signer_fold_b's
    output, lane b = group b // 4; group 0 holds the shortest triple and the
    longest, the widest spread a tile can see), held exactly against
    ``agg_fold_plain`` on the lanes as signer_fold_b laid them out
    (group-major, a triple's columns N apart) and as the pipeline lays them
    out (signer-major, a triple's columns contiguous), on the first G - 37
    groups (not a multiple of the 32-group tile) and on group 0 alone; the
    outputs of the first two land on a block of the caching allocator
    filled with -1 just before the call.  Timed on both layouts; one call runs under
    ``set_sync_debug_mode("error")``."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf

    G, N = N_GROUPS, N_SIGNERS
    (agg_w,) = ds.agg_fold_table(params, N).widths
    tb_g, tl_g = tri_buf.reshape(-1, G, N), tri_len.reshape(G, N)
    tb_s = tb_g.permute(0, 2, 1).reshape(tb_g.shape[0], N * G)
    tl_s = tl_g.t().reshape(-1)
    layouts = {
        "group_major": ([tb_g[:, :, k] for k in range(N)], [tl_g[:, k] for k in range(N)]),
        "signer_major": ([tb_s[:, k * G:(k + 1) * G] for k in range(N)],
                         [tl_s[k * G:(k + 1) * G] for k in range(N)]),
    }
    want = pf.agg_fold_plain(params, N, *layouts["group_major"])
    errs = []
    for cut in (G, G - 37, 1):
        for name, (tbs, tls) in layouts.items():
            tbs, tls = [t[:, :cut] for t in tbs], [t[:cut] for t in tls]
            torch.cuda.synchronize()
            junk = torch.full((agg_w, cut), -1, dtype=torch.int32, device=dev)
            junk_ptr = junk.data_ptr()
            del junk
            got = pf.agg_fold(params, N, tbs, tls)
            # (one group's output is small enough for the pointer table to
            # take the freed block first)
            require(cut == 1 or got[0].data_ptr() == junk_ptr,
                    f"agg_fold ({name}, G={cut}): the output did not land on the -1 block")
            errs.append(max(max_abs_err(got[0], want[0][:, :cut]),
                            max_abs_err(got[1], want[1][:cut])))
            require(errs[-1] == 0, f"agg_fold ({name}, G={cut}) != agg_fold_plain")
            del got
    tbs, tls = layouts["signer_major"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf.agg_fold(params, N, tbs, tls)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"agg_fold: G={G} x N={N} triples of {int(tri_len.min())}..{int(tri_len.max())} B, "
        f"group-major and signer-major lanes, G={G}, {G - 37} and 1: every word and length "
        "equals agg_fold_plain on -1-filled outputs; one call under "
        "set_sync_debug_mode('error'): no host sync")
    t_s = cuda_ms(lambda: pf.agg_fold(params, N, *layouts["signer_major"]), 10)
    t_g = cuda_ms(lambda: pf.agg_fold(params, N, *layouts["group_major"]), 10)
    t_p = cuda_ms(lambda: pf.agg_fold_plain(params, N, *layouts["signer_major"]), 2)
    bnd = bounds.agg_fold(tls, agg_w)
    log(f"  agg_fold       {t_s:.3f} ms signer-major (the pipeline's lanes), {t_g:.3f} ms "
        f"group-major  (plain {t_p:.3f} ms, bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']}: {t_s / bnd['bound_ms']:.2f}x; the per-thread design this tiled "
        "one replaced took 2.125 ms group-major on an H100 80GB HBM3 at 700 W)")
    kernel_rows.append(dict(
        name="agg_fold", route="cuda", source="fusion_cryptography_tpu_torch/csrc/preimage_fold.cu",
        replaces="fusion_cryptography_tpu/ops/fold_pallas.py:675", max_abs_err=max(errs),
        ms=t_s, group_major_ms=t_g, plain_ms=t_p, **bnd, library_ms=None))
    del tb_s, tl_s, layouts, want, tbs, tls


def check_assemble(spec, values, extras, bnds, pad_words, label: str) -> int:
    """Kernel ``assemble_spec`` == its plain version, every word and length,
    into outputs pre-filled with -1, and through the wrapper -> the largest
    absolute error (0)."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops.assemble_spec import (
        _assemble_spec_launch, assemble_spec)

    want = ds.assemble_chunks_words(spec, values, extras, bnds, pad_words)
    got = _assemble_spec_launch(spec, values, extras, pad_words,
                                tuple(torch.full_like(w, -1) for w in want))
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    require(err == 0, f"assemble_spec ({label}) != plain version")
    got = assemble_spec(spec, values, extras, bnds, pad_words)
    err = max([err] + [max_abs_err(x, y) for x, y in zip(got, want)])
    require(err == 0, f"assemble_spec ({label}, wrapper) != plain version")
    return err


def time_assemble(spec, values, extras, bnds, pad_words) -> dict:
    """Kernel ``assemble_spec`` (through the wrapper) and its plain version
    timed on one input set, with its bound -> {"ms", "plain_ms",
    "bound_ms", "bound_by", "lanes", "values", "width"}."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops.assemble_spec import assemble_spec

    (width,) = ds.spec_table(spec, pad_words).widths
    lanes = (values if values is not None else extras[0][0]).shape[-1]
    n_vals = 0 if values is None else values.shape[0]
    args = (spec, values, extras, bnds, pad_words)
    return dict(
        ms=cuda_ms(lambda: assemble_spec(*args), 10),
        plain_ms=cuda_ms(lambda: ds.assemble_chunks_words(*args), 2),
        **bounds.assemble_spec(n_vals, lanes, [el for _, el in extras], width),
        lanes=lanes, values=n_vals, width=width)


def phase_assemble_kernel(dev, kernel_rows: list) -> None:
    """Kernel ``assemble_spec`` on the three specs at full width, on the
    synthetic inputs of :func:`fold_inputs` (warp 0's lanes ~1,300 words
    apart): the challenge spec (B = 32,768 lanes, values int32[512, B], the
    prehash extra, rate-padded), the triple spec (values int32[768, B]) and
    the aggregation spec (G = 8,192 groups, N = 4 strided triple views: an
    extras-only program), each held exactly against its plain version on
    outputs pre-filled with -1 and through the wrapper, also at B - 37
    lanes, and timed (the row's ms and triple_ms come from the verify
    call's own inputs, :func:`phase_assemble_shapes`)."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import ragged_words as rw
    from fusion_cryptography_tpu_torch.ops.assemble_spec import assemble_spec
    from fusion_cryptography_tpu_torch.params import fusion_setup

    params = fusion_setup(SECPAR, SEED)
    G, N = N_GROUPS, N_SIGNERS
    vk2d_t, c_hat_t, pre_w, pre_len = fold_inputs(params, G * N, dev)
    ch_spec, tri_spec = ds.challenge_preimage_spec(params), ds.triple_spec(params)
    pre, pre_bounds = [(pre_w, pre_len)], [(1, ds.PREHASH_W)]
    tvals = torch.cat([vk2d_t, c_hat_t])
    tri_words = rw.words_for(tri_spec.out_max)
    tb, tl = assemble_spec(tri_spec, tvals, pre, pre_bounds)  # group g = lanes 4g..4g+3
    tbv, tlv = tb.reshape(tri_words, G, N), tl.reshape(G, N)
    tri_bounds = [(ds.spec_min_total(tri_spec, [1]), tri_spec.out_max)] * N
    cases = [
        ("challenge", ch_spec, vk2d_t, pre, pre_bounds, ds.signer_fold_a_table(params).widths[0]),
        ("triple", tri_spec, tvals, pre, pre_bounds, tri_words),
        ("aggregation", ds.agg_preimage_spec(params, N, tri_spec.out_max), None,
         [(tbv[:, :, k], tlv[:, k]) for k in range(N)], tri_bounds,
         ds.agg_fold_table(params, N).widths[0]),
    ]
    row = dict(name="assemble_spec", route="cuda",
               source="fusion_cryptography_tpu_torch/csrc/assemble_spec.cu",
               replaces="fusion_cryptography_tpu/ops/assemble_pallas.py:49", library_ms=None)
    errs = []
    for label, spec, values, extras, bnds, width in cases:
        errs.append(check_assemble(spec, values, extras, bnds, width, f"{label} spec"))
        cut = G * N - 37 if values is not None else G - 37
        errs.append(check_assemble(
            spec, None if values is None else values[:, :cut].contiguous(),
            [(eb[:, :cut], el[:cut]) for eb, el in extras], bnds, width,
            f"{label} spec, {cut} lanes"))
        t = time_assemble(spec, values, extras, bnds, width)
        log(f"assemble_spec, {label} spec (synthetic): {t['lanes']} lanes, {t['values']} values, "
            f"{len(extras)} extras, {width} words equal the plain version on -1-filled outputs "
            f"(also at {cut} lanes); {t['ms']:.3f} ms (plain {t['plain_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']}, {t['ms'] / t['bound_ms']:.2f}x)")
        key = {"challenge": "synthetic_", "triple": "synthetic_triple_",
               "aggregation": "aggregation_"}[label]
        row.update({f"{key}ms": t["ms"], f"{key}plain_ms": t["plain_ms"],
                    f"{key}bound_ms": t["bound_ms"], f"{key}bound_by": t["bound_by"]})
    row["max_abs_err"] = max(errs)
    kernel_rows.append(row)
    del tb, tl, tbv, tlv, tvals, cases
    torch.cuda.empty_cache()


def capture_assemble(params, fleet) -> list:
    """The arguments (spec, values, extras, extra_bounds, pad_words) of the
    ``assemble_spec`` calls of one ``verify_batch_device(...,
    assembly="spec")`` call on the fleet, in call order."""
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    captured = []
    saved = dp.assemble_spec

    def record(spec, values=None, extras=(), extra_bounds=None, pad_words=None):
        captured.append((spec, None if values is None else values.clone(),
                         [(eb.clone(), el.clone()) for eb, el in extras], extra_bounds,
                         pad_words))
        return saved(spec, values, extras, extra_bounds, pad_words)

    dp.assemble_spec = record
    try:
        dp.verify_batch_device(params, *fleet, assembly="spec")
        torch.cuda.synchronize()
    finally:
        dp.assemble_spec = saved
    require(len(captured) == 2, f'a "spec" verify call made {len(captured)} assemble_spec '
            "calls, not 2")
    return captured


def phase_assemble_shapes(params, fleet, kernel_rows: list) -> None:
    """Kernel ``assemble_spec`` at the "spec" verify call's own inputs: its
    two calls (the challenge spec and the triple spec) captured from one
    call on the fleet, each held exactly against the plain version on
    -1-filled outputs and through the wrapper, and timed beside its bound.
    The row's ms and triple_ms (and their plain times and bounds) become
    these."""
    row = next(r for r in kernel_rows if r["name"] == "assemble_spec")
    errs = [row["max_abs_err"]]
    for label, args in zip(("challenge", "triple"), capture_assemble(params, fleet)):
        errs.append(check_assemble(*args, f"the verify call's {label} spec"))
        t = time_assemble(*args)
        log(f"assemble_spec, the verify call's {label} spec: {t['lanes']} lanes, {t['values']} "
            f"values, {t['width']} words equal the plain version on -1-filled outputs; "
            f"{t['ms']:.4f} ms (plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']}, {t['ms'] / t['bound_ms']:.2f}x)")
        key = "" if label == "challenge" else "triple_"
        row.update({f"{key}ms": t["ms"], f"{key}plain_ms": t["plain_ms"],
                    f"{key}bound_ms": t["bound_ms"], f"{key}bound_by": t["bound_by"]})
    row["max_abs_err"] = max(errs)
    torch.cuda.empty_cache()


def drive_main_path(params, G: int, N: int, dev) -> tuple:
    """Fleet build (twice, fresh seeds) and grouped verify -> (fleet tensors,
    metrics, kernel launches while they ran)."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    vks, msgs, aggs = build_fleet(params, G, N, seed0=1, device=dev)
    torch.cuda.synchronize()
    t_fleet_cold = time.time() - t0
    t0 = time.time()
    vks2, msgs2, aggs2 = build_fleet(params, G, N, seed0=1 + 2 * G * N, device=dev)
    torch.cuda.synchronize()
    t_fleet = time.time() - t0
    del vks2, msgs2, aggs2
    require(tuple(aggs.shape) == (G, params.rank, params.degree), "aggregate shape")
    log(f"fleet: {G * N} keys, aggregates {tuple(aggs.shape)}: first build "
        f"{t_fleet_cold:.3f} s, second {t_fleet:.3f} s -> {G * N / t_fleet:,.0f} keys/s")
    fleet_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()  # the verify calls' own peak from here

    def verify():
        return dp.verify_batch_device(params, vks, msgs, aggs)

    t0 = time.time()
    eq, norm_ok, weight_ok = verify()
    torch.cuda.synchronize()
    t_warm = time.time() - t0
    require(bool(eq.all()) and bool(norm_ok.all()) and bool(weight_ok.all()),
            "fleet aggregates must verify")
    lat = []
    for _ in range(5):
        t0 = time.time()
        ok = verify()[0].all().item()
        lat.append(time.time() - t0)
        require(bool(ok), "verify")
    reps = 5
    t0 = time.time()
    outs = [verify() for _ in range(reps)]
    torch.cuda.synchronize()
    t_tp = time.time() - t0
    require(all(bool(o[0].all() & o[1].all() & o[2].all()) for o in outs), "verify reps")
    vps = reps * G / t_tp
    launches = dict(kernels.LAUNCHES)
    verify_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_gb = max(fleet_peak_gb, verify_peak_gb)
    log(f"verify: warm call {t_warm:.3f} s; per-call latency median "
        f"{median(lat):.4f} s ({', '.join(f'{x:.4f}' for x in lat)}); {reps} calls, one "
        f"sync: {t_tp:.3f} s -> {vps:,.0f} verifies/s; peak device memory {peak_gb:.2f} GB "
        f"(fleet builds {fleet_peak_gb:.2f} GB, verify calls {verify_peak_gb:.2f} GB)")
    log(f"kernel launches during fleet build + verify: {launches}")
    metrics = {
        "fleet_keys_per_s": G * N / t_fleet, "fleet_first_s": t_fleet_cold,
        "fleet_s": t_fleet, "verify_warm_s": t_warm,
        "verify_latency_s": median(lat), "verify_latency_all_s": lat,
        "verifies_per_s": vps, "verify_reps": reps,
        "verify_reps_s": t_tp, "peak_mem_gb": peak_gb, "verify_peak_mem_gb": verify_peak_gb,
    }
    return (vks, msgs, aggs), metrics, launches


def check_lattice_no_sync(params, fleet) -> None:
    """One ``P.lattice`` call of the main path's chunk under
    ``torch.cuda.set_sync_debug_mode("error")``: it must not wait for the
    device (no blocking copy, no ``.item()``)."""
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    vks, msgs, aggs = fleet
    P = dp.get_pipeline(params, vks.shape[1], str(vks.device))
    mw, ml = dp._message_tensors(params, msgs, vks.device)
    _, c_hat_u, al = P.hash_chunk(vks, mw, ml)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eq, norm_ok, weight_ok = P.lattice(vks, c_hat_u, al, aggs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(bool(eq.all() & norm_ok.all() & weight_ok.all()), "P.lattice verdicts")
    log(f"P.lattice over {vks.shape[0]} groups ran under set_sync_debug_mode('error'): no host sync")


def check_tamper(params, fleet, assembly: str = "fold") -> None:
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    vks, msgs, aggs = fleet
    bad_g = vks.shape[0] // 3
    bad = aggs.clone()
    bad[bad_g, 0, 0] = (bad[bad_g, 0, 0] + 1) % Q
    eq_b, _, _ = dp.verify_batch_device(params, vks, msgs, bad, assembly=assembly)
    rejected = torch.nonzero(~eq_b).flatten().tolist()
    require(rejected == [bad_g], f"tampered group {bad_g} ({assembly}): rejected {rejected}")
    log(f"tampered aggregate ({assembly}): rejected exactly group {bad_g}")


def drive_spec_path(params, fleet, fold_metrics: dict, dev) -> tuple:
    """The "spec" assembly (kernel ``assemble_spec`` for the two signer
    preimages) through ``build_fleet`` and ``verify_batch_device`` at phase
    3's widths and seed, measured as phase 3 measures them -> (metrics,
    kernel launches while they ran)."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    G, N = fleet[0].shape[0], fleet[0].shape[1]
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    vks, msgs, aggs = build_fleet(params, G, N, seed0=1, device=dev, assembly="spec")
    torch.cuda.synchronize()
    t_fleet = time.time() - t0
    require(torch.equal(vks, fleet[0]) and msgs == fleet[1] and torch.equal(aggs, fleet[2]),
            'build_fleet(assembly="spec") != the "fold" fleet')
    fleet_launches = dict(kernels.LAUNCHES)

    def verify():
        return dp.verify_batch_device(params, vks, msgs, aggs, assembly="spec")

    t0 = time.time()
    eq, norm_ok, weight_ok = verify()
    torch.cuda.synchronize()
    t_warm = time.time() - t0
    require(bool(eq.all()) and bool(norm_ok.all()) and bool(weight_ok.all()),
            'fleet aggregates must verify (assembly="spec")')
    lat = []
    for _ in range(5):
        t0 = time.time()
        ok = verify()[0].all().item()
        lat.append(time.time() - t0)
        require(bool(ok), 'verify (assembly="spec")')
    reps = 5
    t0 = time.time()
    outs = [verify() for _ in range(reps)]
    torch.cuda.synchronize()
    t_tp = time.time() - t0
    require(all(bool(o[0].all() & o[1].all() & o[2].all()) for o in outs), "verify reps (spec)")
    launches = dict(kernels.LAUNCHES)
    n_calls = 1 + 5 + reps
    per_call = {k: launches.get(k, 0) - fleet_launches.get(k, 0) for k in launches}
    require(per_call.get("assemble_spec", 0) == 2 * n_calls and fleet_launches.get(
        "assemble_spec", 0) == 2, f"assemble_spec launches: fleet {fleet_launches}, "
            f"{n_calls} verify calls {per_call}")
    require(launches.get("signer_fold_a", 0) == 0 and launches.get("signer_fold_b", 0) == 0,
            f'signer folds launched in the "spec" configuration: {launches}')
    vps = reps * G / t_tp
    log(f'spec assembly: fleet of {G * N} keys in {t_fleet:.3f} s -> {G * N / t_fleet:,.0f} '
        f'keys/s (equals the fold fleet; fold: {fold_metrics["fleet_keys_per_s"]:,.0f}); verify '
        f'warm call {t_warm:.3f} s, per-call latency median {median(lat):.4f} s '
        f'({", ".join(f"{x:.4f}" for x in lat)}; fold {fold_metrics["verify_latency_s"]:.4f}), '
        f'{reps} calls, one sync: {t_tp:.3f} s -> {vps:,.0f} verifies/s (fold '
        f'{fold_metrics["verifies_per_s"]:,.0f})')
    log(f"kernel launches during the spec fleet build + verify: {launches}")
    del vks, aggs, outs
    check_tamper(params, fleet, assembly="spec")
    out_s = dp.derive_coeffs_device(params, *fleet, assembly="spec")
    out_f = dp.derive_coeffs_device(params, *fleet)
    for name, a, b in zip(("eq", "norm_ok", "weight_ok", "cc", "alphas"), out_s, out_f):
        require(torch.equal(a, b), f'derive_coeffs_device {name}: "spec" != "fold"')
    log(f'spec assembly: derive_coeffs_device equals the "fold" configuration over all {G} '
        "groups (verdicts, challenge and alpha coefficients)")
    metrics = {
        "spec_fleet_keys_per_s": G * N / t_fleet, "spec_fleet_s": t_fleet,
        "spec_verify_warm_s": t_warm, "spec_verify_latency_s": median(lat),
        "spec_verify_latency_all_s": lat, "spec_verifies_per_s": vps,
        "spec_verify_reps_s": t_tp,
    }
    return metrics, launches


def drive_object_api(dev) -> tuple:
    """The object API on the card: the KAT corpus of ``KATs/reference_frozen``
    regenerated and checked, and one lifecycle of 4 keys at secpar=256 ->
    (metrics, kernel launches while they ran)."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.interop import api, kat, serial
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    names = sorted(p.name for p in FROZEN_KATS.glob("*.csv"))
    require(len(names) == 18, f"{FROZEN_KATS} must hold the 18 frozen KAT files")
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        t0 = time.time()
        paths = kat.generate_corpus(tmp, KAT_SEED, (128, 256), KAT_SIGNERS, device=dev)
        t_gen = time.time() - t0
        require(sorted(paths) == names, f"generate_corpus wrote {sorted(paths)}")
        bad = [n for n in names if not filecmp.cmp(FROZEN_KATS / n, paths[n], shallow=False)]
        require(not bad, f"KAT files differ from KATs/reference_frozen: {bad}")
        t0 = time.time()
        res = kat.run_all(Path(tmp), device=dev)
        t_check = time.time() - t0
        require(len(res) == 10 and all(v and all(v) for v in res.values()),
                f"kat.run_all: {res}")
    log(f"object API: generate_corpus (seed {KAT_SEED}, {KAT_SIGNERS} signers, secpar 128 and "
        f"256) on the card in {t_gen:.3f} s: all 18 files byte-equal to KATs/reference_frozen; "
        f"kat.run_all on them in {t_check:.3f} s: {sum(len(v) for v in res.values())} rows of "
        f"{len(res)} files true")
    p = api.fusion_setup(SECPAR, SEED)
    seeds, msgs = [11, 12, 13, 14], ["o1", "o2", "o3", "o4"]
    t0 = time.time()
    keys = [api.keygen(p, s, device=dev) for s in seeds]
    sigs = [api.sign(p, k, m) for k, m in zip(keys, msgs)]
    vks = [k[1] for k in keys]
    agg = api.aggregate(p, vks, msgs, sigs)
    verdict = api.verify(p, vks, msgs, agg)
    t_life = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    require(agg.signature_hat.device.type == "cuda", "the api aggregate must live on the card")
    require(verdict == (True, ""), f"api verify: {verdict}")
    kb = lc.keygen(p, seeds, device=dev)
    want = serial.sig_str(p, lc.aggregate(p, kb.vk, msgs, lc.sign(p, kb, msgs).sig))
    require(str(agg) == want, "str(api.aggregate) != str(lifecycle.aggregate)")
    log(f"object API: keygen, sign, aggregate and verify of {len(seeds)} keys at secpar={SECPAR} "
        f"in {t_life:.3f} s; str(aggregate) equals lifecycle.aggregate's")
    log(f"kernel launches during the object API phase: {launches}")
    metrics = {"kat_generate_s": t_gen, "kat_check_s": t_check, "object_api_lifecycle_s": t_life}
    return metrics, launches


def check_cuda_vs_cpu(params, fleet, groups: int = 16) -> None:
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    vks, msgs, aggs = fleet
    N = vks.shape[1]
    m = msgs[: groups * N]
    out_c = dp.derive_coeffs_device(params, vks[:groups], m, aggs[:groups])
    out_h = dp.derive_coeffs_device(params, vks[:groups].cpu(), m, aggs[:groups].cpu())
    for name, a, b in zip(("eq", "norm_ok", "weight_ok", "cc", "alphas"), out_c, out_h):
        require(torch.equal(a.cpu(), b), f"derive_coeffs_device {name}: CUDA != CPU")
    require(bool(out_h[0].all()), "CPU run must verify")
    log(f"secpar={params.secpar}: derive_coeffs_device on CUDA equals the CPU run (plain versions) on {groups} "
        "groups (eq, norms, weights, challenge and alpha coefficients)")


def drive_lifecycle(params, fleet, dev) -> tuple:
    """The batched lifecycle at full width beside phase 3's fleet (same
    seeds and messages) -> (metrics, kernel launches while it ran, one
    aggregate for the CUDA-vs-CPU check)."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc
    from fusion_cryptography_tpu_torch.scheme.device_setup import vk_sort_ranks

    vks_f, _, aggs_f = fleet
    G, N = vks_f.shape[0], vks_f.shape[1]
    B, d, rank = G * N, params.degree, params.rank
    messages = [f"group{g}:msg{i}" for g in range(G) for i in range(N)]  # the fleet's, unsorted
    # verify_batch's coefficients, derived before the counts are cleared
    _, _, _, cc, al = dp.derive_coeffs_device(params, *fleet)

    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    keys = lc.keygen(params, range(1, B + 1), device=dev)
    torch.cuda.synchronize()
    t_keygen = time.time() - t0
    order = torch.argsort(vk_sort_ranks(params, keys.vk, N), dim=1)
    order = (order + torch.arange(G, device=dev)[:, None] * N).reshape(-1)
    require(torch.equal(keys.vk[order].reshape(G, N, 2, d), vks_f),
            "keygen's vks, sorted within groups, != the fleet's")
    t0 = time.time()
    sigs = lc.sign(params, keys, messages)
    torch.cuda.synchronize()
    t_sign = time.time() - t0
    require(tuple(sigs.sig.shape) == (B, rank, d), "signature shape")
    log(f"lifecycle: keygen of {B} keys {t_keygen:.3f} s -> {B / t_keygen:,.0f} keys/s "
        f"(vk equals the fleet's); sign {t_sign:.3f} s -> {B / t_sign:,.0f} signatures/s")

    t_agg, t_ver, aggs = [], [], []
    for g in range(LIFE_GROUPS):
        sl = slice(g * N, (g + 1) * N)
        t0 = time.time()
        agg = lc.aggregate(params, keys.vk[sl], messages[sl], sigs.sig[sl])
        torch.cuda.synchronize()
        t_agg.append(time.time() - t0)
        require(torch.equal(agg, aggs_f[g]), f"aggregate of group {g} != the fleet's")
        t0 = time.time()
        verdict = lc.verify(params, keys.vk[sl], messages[sl], agg)
        t_ver.append(time.time() - t0)
        require(verdict == (True, ""), f"verify of group {g}: {verdict}")
        aggs.append(agg)
    bad = aggs[0].clone()
    bad[0, 0] += 1
    require(lc.verify(params, keys.vk[:N], messages[:N], bad) == (False, lc.REASON_TARGET),
            "a tampered aggregate must fail the target check")
    log(f"lifecycle: {LIFE_GROUPS} groups, one call each: aggregate median "
        f"{median(t_agg) * 1e3:.2f} ms (each equals the fleet's), verify median "
        f"{median(t_ver) * 1e3:.2f} ms (all true); the tampered aggregate fails the target")

    groups = [(keys.vk[g * N:(g + 1) * N], messages[g * N:(g + 1) * N], aggs[g])
              for g in range(LIFE_GROUPS)]
    groups += [(keys.vk[:N], messages[:N], bad), (keys.vk[N:2 * N], messages[N:2 * N - 1], aggs[1])]
    want = [(True, "")] * LIFE_GROUPS + [(False, lc.REASON_TARGET), (False, lc.REASON_LEN_MISMATCH)]
    t0 = time.time()
    got = lc.verify_many(params, groups)
    t_many = time.time() - t0
    require(got == want, "verify_many verdicts")

    lc.verify_batch(params, vks_f, cc, al, aggs_f)  # warm
    t_vb = []
    for _ in range(3):
        t0 = time.time()
        out = lc.verify_batch(params, vks_f, cc, al, aggs_f)
        require(bool(out[0].all() & out[1].all() & out[2].all()), "verify_batch verdicts")
        t_vb.append(time.time() - t0)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"lifecycle: verify_many of {len(groups)} groups {t_many:.3f} s -> "
        f"{len(groups) / t_many:,.0f} groups/s (expected verdicts); verify_batch G={G}: "
        f"median {median(t_vb):.4f} s -> {G / median(t_vb):,.0f} verifies/s (all true); "
        f"peak device memory {peak_gb:.2f} GB")
    log(f"kernel launches during the lifecycle: {launches}")
    metrics = {
        "life_keygen_keys_per_s": B / t_keygen, "life_sign_per_s": B / t_sign,
        "life_aggregate_ms": median(t_agg) * 1e3, "life_verify_ms": median(t_ver) * 1e3,
        "life_verify_many_groups_per_s": len(groups) / t_many,
        "life_verify_batch_per_s": G / median(t_vb), "life_peak_mem_gb": peak_gb,
    }
    return metrics, launches


def check_lifecycle_cuda_vs_cpu(params, dev) -> None:
    """keygen -> sign -> aggregate -> verify of one group of 4 keys on the
    card and on the CPU (the plain versions), with short messages and with
    long non-ASCII ones (137-182 bytes, past the 136-byte sponge rate); for
    the long ones also the group's challenge and alpha coefficients
    (``derive_coeffs_device``)."""
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    seeds = [5, 6, 7, 8]
    long_msgs = ["\u00e9" * 90 + "m0", "\u2713" * 50, "x" * 135 + "\u00fc",
                 "\u65e5\u672c\u8a9e" * 20]
    require(all(len(m.encode("utf-8")) > 136 for m in long_msgs), "long messages")
    for msgs in (["p", "q", "r", "s"], long_msgs):
        out = {}
        for where in (dev, "cpu"):
            keys = lc.keygen(params, seeds, device=where)
            sigs = lc.sign(params, keys, msgs)
            agg = lc.aggregate(params, keys.vk, msgs, sigs.sig)
            _, vks_s, msgs_s = lc._sorted_group(params, keys.vk, msgs)
            coeffs = dp.derive_coeffs_device(params, vks_s, msgs_s, agg.unsqueeze(0))
            out[where] = ((keys.sk_hat, keys.vk, sigs.sig, agg, *coeffs),
                          lc.verify(params, keys.vk, msgs, agg))
        names = ("sk_hat", "vk", "sig", "aggregate", "eq", "norm_ok", "weight_ok", "cc", "alphas")
        for name, a, b in zip(names, out[dev][0], out["cpu"][0]):
            require(torch.equal(a.cpu(), b), f"lifecycle {name}: CUDA != CPU ({msgs[0][:8]}...)")
        require(out[dev][1] == out["cpu"][1] == (True, ""), "lifecycle verify: CUDA != CPU")
    log("lifecycle: keygen, sign, aggregate, verify and the group's coefficients of 4 keys on "
        "CUDA equal the CPU run, with short messages and with long non-ASCII ones "
        f"({', '.join(str(len(m.encode('utf-8'))) for m in long_msgs)} B)")


def fold_times_only(dev, card: str) -> int:
    """``--fold-times``: the signer fold kernels' times on the five input
    sets of :func:`signer_fold_times` and nothing else, through the public
    wrappers only (so a copy of this script times another tree's kernels)."""
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    params = fusion_setup(SECPAR, SEED)
    fleet = build_fleet(params, N_GROUPS, N_SIGNERS, seed0=1, device=dev)
    times = signer_fold_times(params, fleet, dev)
    log(f"card: {card}")
    log(json.dumps({"fold_times": times}))
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    t_start = time.time()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.time()
    kernels.library()
    log(f"kernels built and loaded in {time.time() - t0:.1f} s")
    for line in kernels.build_report().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    if argv == ["--fold-times"]:
        return fold_times_only(dev, card)
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv} (only --fold-times)")

    # -- 2. kernels vs plain ------------------------------------------------
    kernel_rows: list = []
    phase_kernels(dev, kernel_rows)
    phase_agg_check(dev, kernel_rows)
    phase_fold_kernels(dev, kernel_rows)
    phase_assemble_kernel(dev, kernel_rows)
    phase_ntt_kernels(dev, kernel_rows)

    # -- 3. main path -------------------------------------------------------
    G, N = N_GROUPS, N_SIGNERS
    params = fusion_setup(SECPAR, SEED)
    fleet, metrics, launches = drive_main_path(params, G, N, dev)
    check_tamper(params, fleet)
    check_cuda_vs_cpu(params, fleet)
    check_lattice_no_sync(params, fleet)
    phase_sponge_shapes(params, fleet, kernel_rows)
    phase_fold_shapes(params, fleet, kernel_rows)

    # -- S. the "spec" assembly ---------------------------------------------
    spec_metrics, spec_launches = drive_spec_path(params, fleet, metrics, dev)
    metrics.update(spec_metrics)
    phase_assemble_shapes(params, fleet, kernel_rows)

    # -- L. lifecycle ---------------------------------------------------------
    life_metrics, life_launches = drive_lifecycle(params, fleet, dev)
    metrics.update(life_metrics)
    check_lifecycle_cuda_vs_cpu(params, dev)
    del fleet
    torch.cuda.empty_cache()

    # -- 4. the secpar=128 lane ---------------------------------------------
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    p128 = fusion_setup(128, SEED)
    t0 = time.time()
    fleet128 = build_fleet(p128, LANE128_GROUPS, N, seed0=1, device=dev)
    eq, norm_ok, weight_ok = dp.verify_batch_device(p128, *fleet128)
    require(bool(eq.all() & norm_ok.all() & weight_ok.all()), "secpar=128 lane must verify")
    torch.cuda.synchronize()
    t128 = time.time() - t0
    log(f"secpar=128 lane: fleet of {LANE128_GROUPS} groups x {N} built and verified in "
        f"{t128:.3f} s (first calls), every verdict true")
    check_cuda_vs_cpu(p128, fleet128)
    metrics["lane128_groups"] = LANE128_GROUPS
    metrics["lane128_fleet_and_verify_s"] = t128
    del fleet128

    # -- O. the object API ------------------------------------------------------
    obj_metrics, obj_launches = drive_object_api(dev)
    metrics.update(obj_metrics)

    # -- 5. the paths went through every kernel --------------------------------
    require(sorted(r["name"] for r in kernel_rows) == sorted(ALL_KERNELS),
            "kernel table must list every kernel of the paths")
    paths = (("main", launches, MAIN_PATH_KERNELS), ("spec", spec_launches, SPEC_PATH_KERNELS),
             ("lifecycle", life_launches, LIFECYCLE_KERNELS),
             ("object_api", obj_launches, OBJECT_API_KERNELS))
    for row in kernel_rows:
        name = row["name"]
        for path, counts, path_kernels in paths:
            row[f"launches_{path}"] = int(counts.get(name, 0))
            if name in path_kernels:
                require(row[f"launches_{path}"] > 0,
                        f"kernel {name} never launched on the {path} path")
        row["launches"] = sum(row[f"launches_{path}"] for path, _, _ in paths)

    metrics.update(card=card, secpar=SECPAR, groups=G, signers=N,
                   group_chunk=dp.DEFAULT_GROUP_CHUNK, total_s=time.time() - t_start)
    log(json.dumps({"metrics": metrics}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
