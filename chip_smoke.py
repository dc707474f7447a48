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
     the rate edges among them, the squeeze at one, two and 32 threads a
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
     lanes fewer, its outputs on memory filled with -1; ``ntt_u`` and
     ``ntt_centered`` both ways on -1-filled outputs at [32,768, 256] int64
     and [65,536, 256] int32, at 37 rows fewer, at 4 rows and at d = 64
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
     alone); the glue kernels at the inputs of one verify call (captured):
     ``xof_decode`` (the challenge decode and the alphas' decode read in
     place from the group stage's blob), ``render_prehash`` and
     ``lattice_target``, each equal to its plain version and timed beside
     its bound, with its launches in one verify call and one fleet build;
     ``xof_decode`` also on crafted streams at both launches' shapes (first
     hits on share edges, every slot or none hit, slot 0 before the rows
     past the end or not), and the launches' registers, shared memory,
     blocks an SM and waves of ``xof_decode`` and ``render_prehash``;
     ``place_preimages`` (the prehash sponge's input placed from the flat
     message stream) at the verify call's launch (captured) and at the nist
     traffic's 32,768 messages of 33 * k bytes, k = 1..100, each equal to
     its plain version, on words memory filled with -1 just before, and
     timed beside its bound; ``sample_short`` (the keys' short
     coefficients) at the sign cell's 2,048 streams at d = 64 and the
     fleet's 65,536 at d = 256, on -1-filled outputs, equal to the C
     sampler and timed beside its bound and the C sampler's host time
  X. wide aggregates (BASELINE config 3), with phase 3's fleet alive: a
     fleet of 32 groups of 1,024 built (timed) and verified (a tampered
     aggregate fails alone); ``agg_fold``, ``lattice_target`` and the
     aggregation launch of the sponge captured from one call, held against
     their plain versions (the sponge against hashlib) and timed beside
     their times at the short shape
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
  W. the rest of the package, phase 3's fleet alive at its start:
     ``derive_alphas_grouped`` on that fleet's vk reprs and messages equals
     ``derive_coeffs_device``'s coefficients through kernels 1, 2, 4-7; the
     fleet freed, a fleet of G=32,768 groups x 4 verified in signer chunks of
     8,192 and group windows of 16,384 (one call entirely under
     ``set_sync_debug_mode("error")``, all verdicts true, verifies/s over 5
     calls with one sync, the host's packing time per chunk from the
     program's ``fct.pack`` spans in one traced call, a tampered
     group in the third chunk fails alone, ``derive_coeffs_device`` in
     chunks of 2,048 equals one chunk on 8,192 groups); the segmented
     absorb at 32,768 lanes equals its CPU plain version; the CLI at
     secpar=256 with ``--device cuda`` exits 0 (a tampered message 1) and
     writes the same bytes as ``--device cpu``
  D. ``parallel/`` (the sharding) after ``python -m
     fusion_cryptography_tpu_torch.demo`` on the card: a one-rank NCCL world
     on the card (file rendezvous); ``sharded_verify_device`` on phase 3's
     fleet (rebuilt from its seeds) equals ``verify_batch_device`` in both
     assemblies, a tampered group fails alone, a warm call runs under
     ``set_sync_debug_mode("error")``, and ``pod_scale.verify_throughput``
     times it; ``pod_scale.lifecycle_throughput`` at 16,384 keys (one
     card's share of config 4's 65,536) from ``device_inputs``: keys/s,
     peak memory, vk and agg equal to the unsharded port's on the card,
     every verdict true, and one step traced (port kernels, NCCL, torch
     glue); ``prepare_real`` at B=64 and the step on it equal on the card
     and on the CPU (a gloo world of one, run beside the untimed checks
     and collected before the first timed call); both distributed NTTs at
     S=1 on 8,192 rows equal ``ntt_fwd`` / ``ntt_inv``.  With two cards or
     more, a world of min(4, cards) NCCL ranks (``parallel/_launch``) runs
     the same ``pod_scale`` calls: config 4 at 16,384 keys a card (one step
     traced on rank 0), config 5 cut to 8,192 groups a card (each rank
     building its own; then once more with one group tampered) and both
     NTTs at S = world; each result must equal the one-rank run's, and the
     scaling efficiencies against the one-rank rates are printed; with one
     card a line says that it did not run
  5. every kernel of each path (main, spec, lifecycle, object API, aux =
     phase W, sharded = phase D's one-rank world) was launched while that
     path was driven (counts cleared just before each, read just after),
     and kernels ``intt_norm_weight`` and ``ntt_u`` by the step itself

The last two lines of stdout are the kernel table {"kernels": [...]} and
{"ok": true, "device": {...}}; the card's name and power limit come just
before them.  Run from the repository root: ``python3 chip_smoke.py``.
``python3 chip_smoke.py --fold-times`` builds the kernels and a fleet and
prints only the signer folds' times on their five input sets.
``python3 chip_smoke.py --sponge-teams`` prints only the sponge teams'
times: the wide cell's aggregation chain and the crossover of the warp and
the pair (:func:`sponge_team_times`).
"""
from __future__ import annotations

import filecmp
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from statistics import median

import numpy as np
import torch

from fusion_cryptography_tpu_torch import bounds

SEED = 42
SECPAR, N_GROUPS, N_SIGNERS = 256, 8192, 4
LANE128_GROUPS = 1024

# the verify path's glue stages: the XOF decode (challenges and alphas), the
# prehash render and the lattice target
GLUE_KERNELS = ("xof_decode", "render_prehash", "lattice_target")
MAIN_PATH_KERNELS = ("keccak_absorb", "keccak_squeeze", "intt_norm_weight",
                     "signer_fold_a", "signer_fold_b", "agg_fold", "ntt_u",
                     "place_preimages") + GLUE_KERNELS
# the "spec" assembly: assemble_spec in place of the signer folds
SPEC_PATH_KERNELS = ("keccak_absorb", "keccak_squeeze", "intt_norm_weight", "agg_fold",
                     "ntt_u", "assemble_spec", "place_preimages") + GLUE_KERNELS
# the lifecycle: the main path's kernels and keygen's short coefficients and
# sk_hat = NTT(sk)
LIFECYCLE_KERNELS = MAIN_PATH_KERNELS + ("sample_short", "ntt_centered")
# the object API: keygen and the challenge/coefficient NTTs, verify's pipeline
OBJECT_API_KERNELS = LIFECYCLE_KERNELS
# phase W: the windowed verify, derive_alphas_grouped, the segmented absorb
# and the CLI (its keygen is kernel ntt_centered)
AUX_KERNELS = LIFECYCLE_KERNELS
ALL_KERNELS = LIFECYCLE_KERNELS + ("assemble_spec",)
# phase D: the sharded verify in both assemblies (kernels 1-8 and the glue
# kernels), the step (kernels 3 and 4: no hash stage, no lattice target)
# and prepare_real's keygen (kernels 9 and 14)
SHARDED_KERNELS = ALL_KERNELS
STEP_KERNELS = ("intt_norm_weight", "ntt_u")
WIDE_GROUPS, WIDE_SIGNERS = 32, 1024  # BASELINE config 3: aggregates of 2^10 signatures
D_KEYS = 16384  # one card's share of config 4 (65,536 keys over four cards)
D_REAL_KEYS = 64  # prepare_real on the card and on the CPU
D_NTT_ROWS = 8192
W_GROUPS, W_CHUNK, W_HASH_CHUNK = 32768, 8192, 16384  # four signer chunks, two windows
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
        "at one, two and 32 threads a sponge too) equal the plain versions; 64 lanes equal "
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
SPONGE_TEAMS = (1, 2, 32)  # threads per sponge


def clone_args(x):
    """``x`` with every tensor in it (also inside lists and tuples) cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, list) or type(x) is tuple:
        return type(x)(clone_args(y) for y in x)
    return x


def capture_calls(params, fleet, wraps, **verify_kw) -> dict:
    """{name: [arguments of each call, tensors cloned, in call order]} of the
    functions ``(module, attribute, name)`` of ``wraps`` over one
    ``verify_batch_device(params, *fleet, **verify_kw)`` call on the fleet
    (``profile_verify.record_calls``: every argument positional)."""
    from fusion_cryptography_tpu_torch.profile_verify import record_calls
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    calls = {name: [] for _, _, name in wraps}

    def run():
        dp.verify_batch_device(params, *fleet, **verify_kw)
        torch.cuda.synchronize()

    record_calls(wraps, run, lambda name, args: calls[name].append(clone_args(args)))
    return calls


def capture_sponges(params, fleet) -> tuple:
    """The arguments of the sponge calls of one ``verify_batch_device`` call
    on the fleet: ([(padded words, block counts)] of its absorb calls,
    [(state, n_words)] of its squeeze calls), each in call order."""
    from fusion_cryptography_tpu_torch.ops import keccak_sponge as ks

    calls = capture_calls(params, fleet, [(ks, "absorb", "absorb"), (ks, "squeeze", "squeeze")])
    for name, got in calls.items():
        require(len(got) == len(SPONGE_LAUNCHES),
                f"a verify call made {len(got)} {name} launches, not {len(SPONGE_LAUNCHES)}")
    return calls["absorb"], calls["squeeze"]


def sum_launches(row: dict, shapes: list, errs: list) -> None:
    """A sponge kernel's row: ms, plain_ms and bound_ms summed over the
    verify call's launches (``shapes``), bound_by that of the larger
    share of the bound."""
    total = {k: sum(sh[k] for sh in shapes) for k in ("ms", "plain_ms", "bound_ms")}
    bound_by = max(("bytes", "operations"),
                   key=lambda k: sum(sh["bound_ms"] for sh in shapes if sh["bound_by"] == k))
    row.update(max_abs_err=max(errs), bound_by=bound_by, shapes=shapes, **total)
    log(f"{row['name']} over the verify call's {len(shapes)} launches: {total['ms']:.4f} ms, bound "
        f"{total['bound_ms']:.4f} ms ({total['ms'] / total['bound_ms']:.2f}x)")


def phase_sponge_shapes(params, fleet, kernel_rows: list) -> None:
    """Kernels ``keccak_absorb`` and ``keccak_squeeze`` at the verify call's
    own launches: the arguments of its three ``absorb`` calls (padded words,
    block counts) and three ``squeeze`` calls (state, words) -- prehash
    SHA3-256, challenge and aggregation SHAKE256 -- captured from one
    ``verify_batch_device`` call on the fleet; each held exactly against the
    plain absorb or squeeze at one, two and 32 threads per sponge (each into an
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
                     **{f"team{t}_ms": ms for t, ms in team_ms.items()})
        shapes.append(shape)
        log(f"keccak_absorb, the verify call's {label} launch: B={B}, {shape['longest']} blocks "
            f"at most, {shape['permutations']} permutations: every team equals the plain "
            f"absorb; wrapper ({team} thread(s) per sponge) {t_k:.4f} ms, plain "
            f"{t_plain:.1f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({t_k / b['bound_ms']:.2f}x); warp ratio {shape['warp_ratio_team1']:.4f} (1 thread) "
            f"/ {shape['warp_ratio_team2']:.4f} (2 threads)")
        log(f"  one thread a sponge {team_ms[1]:.4f} ms, two {team_ms[2]:.4f} ms, a warp "
            f"{team_ms[32]:.4f} ms")
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
                     ms=t_k, plain_ms=t_plain, **b,
                     **{f"team{t}_ms": ms for t, ms in team_ms.items()})
        shapes.append(shape)
        log(f"keccak_squeeze, the verify call's {label} launch: B={B}, {n_words} words, "
            f"{shape['permutations']} permutations: every team equals the plain squeeze; "
            f"wrapper ({team} thread(s) per sponge) {t_k:.4f} ms, plain {t_plain:.1f} ms, "
            f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({t_k / b['bound_ms']:.2f}x)")
        log(f"  one thread a sponge {team_ms[1]:.4f} ms, two {team_ms[2]:.4f} ms, a warp "
            f"{team_ms[32]:.4f} ms")
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
    """The two NTT kernels, forward (the direction the paths run) and
    inverse, each into outputs filled with -1 and against its plain
    version, and inverse(forward(x)) == x: ``ntt_u`` on the signer stage's
    residues [32,768, 256], ``ntt_centered`` on keygen's centered int32
    [65,536, 256] (32,768 keys x 2 sides), both timed there; then each at
    a row count that is no multiple of a block's rows, at one lifecycle
    group's 4 rows, and at secpar=128's degree (d = 64).  Each time is the
    mean of 5 launches, few enough that the wrapper's host time stays
    inside ``cuda_ms``'s spin."""
    from fusion_cryptography_tpu_torch.ops import ntt
    from fusion_cryptography_tpu_torch.params import fusion_setup

    plan = fusion_setup(SECPAR, SEED).plan
    plan64 = fusion_setup(128, SEED).plan
    B = N_GROUPS * N_SIGNERS
    g = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(p, rows: int, centered: bool) -> torch.Tensor:
        d, q = p.degree, p.modulus
        x = torch.randint(0, q, (rows, d), dtype=torch.int64, device=dev, generator=g)
        if not centered:
            x[0, :3] = torch.tensor([0, 1, q - 1])
            x[1:2], x[2:3] = 0, q - 1
            return x
        x = (x - q // 2).to(torch.int32)
        x[0, :5] = torch.tensor([0, 1, -1, q // 2, -(q // 2)], dtype=torch.int32)
        x[1:2], x[2:3], x[3:4] = 0, -(q // 2), q // 2
        return x

    def check(name, p, x, fwd_p, inv_p) -> int:
        centered = name == "ntt_centered"
        y = ntt._launch(p, x, False, centered, torch.full_like(x, -1))
        z = ntt._launch(p, y, True, centered, torch.full_like(x, -1))
        err = max(max_abs_err(y, fwd_p(p, x)), max_abs_err(z, inv_p(p, y)))
        require(err == 0, f"{name} {list(x.shape)} != plain version")
        require(torch.equal(z, x), f"{name} {list(x.shape)}: inverse(forward(x)) != x")
        return err

    cases = [
        ("ntt_u", "fusion_cryptography_tpu/ops/ntt_mxu_pallas.py:87", B, 16,
         ntt.ntt_fwd_u, ntt.ntt_fwd_u_plain, ntt.ntt_inv_u, ntt.ntt_inv_u_plain),
        ("ntt_centered", "fusion_cryptography_tpu/ops/ntt_pallas.py:94", 2 * B, 8,
         ntt.ntt_fwd, ntt.ntt_fwd_plain, ntt.ntt_inv, ntt.ntt_inv_plain),
    ]
    for name, replaces, rows, bytes_per_coef, fwd, fwd_p, inv, inv_p in cases:
        centered = name == "ntt_centered"
        x = inputs(plan, rows, centered)
        err = check(name, plan, x, fwd_p, inv_p)
        y = fwd(plan, x)
        d = plan.degree
        t_f = cuda_ms(lambda: fwd(plan, x), 5)
        t_fp = cuda_ms(lambda: fwd_p(plan, x), 3)
        t_i = cuda_ms(lambda: inv(plan, y), 5)
        t_ip = cuda_ms(lambda: inv_p(plan, y), 3)
        b_f = bounds.ntt(rows, d, bytes_per_coef)
        b_i = bounds.ntt(rows, d, bytes_per_coef, inverse=True)
        log(f"{name}: [{rows}, {d}] {x.dtype} forward and inverse equal the plain versions; "
            f"forward {t_f:.4f} ms (plain {t_fp:.3f} ms, bound {b_f['bound_ms']:.4f} ms by "
            f"{b_f['bound_by']}), inverse {t_i:.4f} ms (plain {t_ip:.3f} ms, bound "
            f"{b_i['bound_ms']:.4f} ms)")
        del x, y
        more = {}
        for p, n in ((plan, rows - 37), (plan, 4), (plan64, rows // 8), (plan64, 4)):
            x = inputs(p, n, centered)
            err = max(err, check(name, p, x, fwd_p, inv_p))
            y = fwd(p, x)
            t_f2, t_i2 = cuda_ms(lambda: fwd(p, x), 5), cuda_ms(lambda: inv(p, y), 5)
            more[f"{n}x{p.degree}"] = [t_f2, t_i2]
            b_n = bounds.ntt(n, p.degree, bytes_per_coef)["bound_ms"]
            log(f"  {name} [{n}, {p.degree}]: equal the plain versions; forward {t_f2:.4f} ms, "
                f"inverse {t_i2:.4f} ms (bound {b_n:.4f} ms)")
        kernel_rows.append(dict(
            name=name, route="cuda", source="fusion_cryptography_tpu_torch/csrc/ntt.cu",
            replaces=replaces, max_abs_err=err, ms=t_f, plain_ms=t_fp, **b_f, library_ms=None,
            inverse_ms=t_i, inverse_plain_ms=t_ip, inverse_bound_ms=b_i["bound_ms"],
            other_shapes_ms=more))
        del x, y
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

    names = ("signer_fold_a", "signer_fold_b")
    calls = capture_calls(params, fleet, [(pf, name, name) for name in names])
    require(all(len(v) == 1 for v in calls.values()),
            f"a verify call made signer fold calls {[(k, len(v)) for k, v in calls.items()]}")
    return {name: got[0][1:] for name, got in calls.items()}  # the params dropped


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
    outputs on memory filled with -1.  Timed on both layouts; one call runs under
    ``set_sync_debug_mode("error")``."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf

    G, N = N_GROUPS, N_SIGNERS
    (agg_w,) = ds.agg_fold_table(params, N).widths
    tb_g, tl_g = tri_buf.reshape(-1, G, N), tri_len.reshape(G, N)

    def lanes(cut):  # the first ``cut`` groups' triples [W, N, cut], [N, cut] in each order
        g = (tb_g[:, :cut].transpose(1, 2), tl_g[:cut].t())
        return {"group": g, "signer": (g[0].contiguous(), g[1].contiguous())}

    layouts = lanes(G)
    want = pf.agg_fold_plain(params, N, *layouts["group"])
    errs = []
    for cut in (G, G - 37, 1):
        for name, (tbuf, tlen) in lanes(cut).items():
            outs = [torch.full((agg_w, cut), -1, dtype=torch.int32, device=dev),
                    torch.full((cut,), -1, dtype=torch.int32, device=dev)]
            got = pf._agg_fold_launch(params, N, tbuf, tlen, outs)
            errs.append(max(max_abs_err(got[0], want[0][:, :cut]),
                            max_abs_err(got[1], want[1][:cut])))
            require(errs[-1] == 0, f"agg_fold ({name}-major, G={cut}) != agg_fold_plain")
            del got, outs
    tbuf, tlen = layouts["signer"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf.agg_fold(params, N, tbuf, tlen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"agg_fold: G={G} x N={N} triples of {int(tri_len.min())}..{int(tri_len.max())} B, "
        f"group-major and signer-major lanes, G={G}, {G - 37} and 1: every word and length "
        "equals agg_fold_plain on -1-filled outputs; one call under "
        "set_sync_debug_mode('error'): no host sync")
    t_s = cuda_ms(lambda: pf.agg_fold(params, N, tbuf, tlen), 10)
    t_g = cuda_ms(lambda: pf.agg_fold(params, N, *layouts["group"]), 10)
    t_p = cuda_ms(lambda: pf.agg_fold_plain(params, N, tbuf, tlen), 2)
    bnd = bounds.agg_fold(tlen, N, agg_w)
    log(f"  agg_fold       {t_s:.3f} ms signer-major (the pipeline's lanes), {t_g:.3f} ms "
        f"group-major  (plain {t_p:.3f} ms, bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']}: {t_s / bnd['bound_ms']:.2f}x; the per-thread design this tiled "
        "one replaced took 2.125 ms group-major on an H100 80GB HBM3 at 700 W)")
    kernel_rows.append(dict(
        name="agg_fold", route="cuda", source="fusion_cryptography_tpu_torch/csrc/preimage_fold.cu",
        replaces="fusion_cryptography_tpu/ops/fold_pallas.py:675", max_abs_err=max(errs),
        ms=t_s, group_major_ms=t_g, plain_ms=t_p, **bnd, library_ms=None))
    del layouts, want, tbuf, tlen


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

    captured = capture_calls(params, fleet, [(dp, "assemble_spec", "assemble_spec")],
                             assembly="spec")["assemble_spec"]
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


GLUE_ROWS = {  # kernel -> (source, the JAX function it replaces)
    "xof_decode": ("fusion_cryptography_tpu_torch/csrc/xof_decode.cu",
                   "fusion_cryptography_tpu/ops/xof_decode.py:392"),
    "render_prehash": ("fusion_cryptography_tpu_torch/csrc/render_prehash.cu",
                       "fusion_cryptography_tpu/ops/ragged_words.py:397"),
    "lattice_target": ("fusion_cryptography_tpu_torch/csrc/lattice_target.cu",
                       "fusion_cryptography_tpu/scheme/device_pipeline.py:545"),
}


def phase_wide(params, dev, kernel_rows: list) -> dict:
    """Wide aggregates (BASELINE config 3): a fleet of 32 groups of 1,024
    signers built (timed, with its sort of each group's keys by str(vk))
    and verified (all verdicts true, a tampered aggregate fails alone);
    from one verify call, kernels ``agg_fold`` (its prefix launch and runs
    that start mid-table), ``lattice_target`` (split over the signers, and
    one warp a group) and the aggregation launch of ``keccak_absorb`` and
    ``keccak_squeeze``, each held exactly against its plain version
    (``agg_fold_plain`` and ``lattice_target_plain`` on outputs filled with
    -1 or with the negated verdicts, the sponge's output against hashlib's
    SHAKE256 of each group's preimage), timed beside its bound and beside
    its time at the short shape (the rows of phases 2-3) -> metrics."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds
    from fusion_cryptography_tpu_torch.ops import keccak, keccak_sponge as ks
    from fusion_cryptography_tpu_torch.ops import lattice_target as lt
    from fusion_cryptography_tpu_torch.ops import preimage_fold as pf
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    G, N = WIDE_GROUPS, WIDE_SIGNERS
    torch.cuda.synchronize()
    t0 = time.time()
    fleet = build_fleet(params, G, N, seed0=1 + 4 * N_GROUPS * N_SIGNERS, device=dev)
    torch.cuda.synchronize()
    t_fleet = time.time() - t0
    eq, norm_ok, weight_ok = dp.verify_batch_device(params, *fleet)
    require(bool(eq.all() & norm_ok.all() & weight_ok.all()), "wide fleet must verify")
    bad = fleet[2].clone()
    bad[G // 3, 0, 5] = (bad[G // 3, 0, 5] + 1) % params.modulus
    eq = dp.verify_batch_device(params, fleet[0], fleet[1], bad)[0]
    require(torch.nonzero(~eq).flatten().tolist() == [G // 3], "wide: tampered group must fail")
    del bad
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(3):
        out = dp.verify_batch_device(params, *fleet)
    torch.cuda.synchronize()
    t_call = (time.time() - t0) / 3
    log(f"wide: fleet of {G} groups x {N} built in {t_fleet:.3f} s; verify {t_call * 1e3:.1f} ms "
        f"a call ({G / t_call:.1f} groups/s, {G * N / t_call:,.0f} signatures/s), all true; "
        "a tampered aggregate fails alone")
    del out

    calls = capture_calls(params, fleet, [(pf, "agg_fold", "agg_fold"),
                                          (dp, "lattice_target", "lattice_target"),
                                          (ks, "absorb", "absorb"), (ks, "squeeze", "squeeze")])
    short = {r["name"]: r for r in kernel_rows}
    out_m = dict(wide_groups=G, wide_signers=N, wide_fleet_build_s=t_fleet,
                 wide_verify_call_ms=t_call * 1e3)

    # agg_fold: its prefix launch, then runs that start at their first op
    (_, _, tbuf, tlen) = calls["agg_fold"][0]
    (agg_w,) = ds.agg_fold_table(params, N).widths
    want = pf.agg_fold_plain(params, N, tbuf, tlen)
    outs = [torch.full((agg_w, G), -1, dtype=torch.int32, device=dev),
            torch.full((G,), -1, dtype=torch.int32, device=dev)]
    got = pf._agg_fold_launch(params, N, tbuf, tlen, outs)
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    require(err == 0, "wide: agg_fold != agg_fold_plain")
    t_k = cuda_ms(lambda: pf.agg_fold(params, N, tbuf, tlen), 10)
    t_p = cuda_ms(lambda: pf.agg_fold_plain(params, N, tbuf, tlen), 1)
    b = bounds.agg_fold(tlen, N, agg_w)
    log(f"wide agg_fold: {agg_w} words x {G} groups ({int(got[1].max())} B at most): equals "
        f"agg_fold_plain on -1; {t_k:.4f} ms (short shape {short['agg_fold']['ms']:.4f} ms), "
        f"plain {t_p:.2f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"({t_k / b['bound_ms']:.2f}x)")
    out_m.update(wide_agg_fold_ms=t_k, wide_agg_fold_plain_ms=t_p,
                 wide_agg_fold_bound_ms=b["bound_ms"])
    wbuf, total = want
    del got, outs

    # lattice_target: split over the signers (the wrapper's choice) and one warp a group
    args = calls["lattice_target"][0]
    want = lt.lattice_target_plain(*args)
    require(all(bool(x.all()) for x in want), "wide: the verify call's groups pass")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = lt.lattice_split(G, N, sms)
    times = {}
    for slices in (chosen, 1):
        out = torch.stack([~x for x in want])
        got = lt._lattice_target_launch(*args, slices, out)
        err = max(max_abs_err(x, y) for x, y in zip(got, want))
        require(err == 0, f"wide: lattice_target ({slices} slices) != lattice_target_plain")
        times[slices] = cuda_ms(lambda: lt._lattice_target_launch(*args, slices), 10)
    t_p = cuda_ms(lambda: lt.lattice_target_plain(*args), 1)
    b = bounds.lattice_target(G, N, params.degree, params.rank)
    log(f"wide lattice_target: equals lattice_target_plain over its negated verdicts; "
        f"{chosen} slices {times[chosen]:.4f} ms, one warp a group {times[1]:.4f} ms (short "
        f"shape {short['lattice_target']['ms']:.4f} ms), plain {t_p:.2f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({times[chosen] / b['bound_ms']:.2f}x)")
    out_m.update(wide_lattice_target_ms=times[chosen], wide_lattice_target_one_warp_ms=times[1],
                 wide_lattice_slices=chosen, wide_lattice_target_plain_ms=t_p,
                 wide_lattice_target_bound_ms=b["bound_ms"])

    # the aggregation sponge (the call's third absorb and squeeze) against hashlib
    (padded, nblk), (state, n_words) = calls["absorb"][2], calls["squeeze"][2]
    require(padded.shape[1] == G and state.shape[1] == G, "wide: the aggregation launches")
    xof = ks.squeeze(ks.absorb(padded, nblk), n_words).cpu().numpy()
    pre = wbuf.cpu().numpy()
    for g in range(G):
        data = pre[:, g].tobytes()[:int(total[g])]
        want_g = np.frombuffer(hashlib.shake_256(data).digest(4 * n_words), np.int32)
        require(np.array_equal(xof[:, g], want_g), f"wide: group {g}'s SHAKE256 != hashlib")
    teams = {}
    for team in SPONGE_TEAMS:
        teams[("absorb", team)] = cuda_ms(lambda: ks._absorb_launch(padded, nblk, team), 2)
        teams[("squeeze", team)] = cuda_ms(lambda: ks._squeeze_launch(state, n_words, team), 2)
    ab_team, sq_team = ks.absorb_team(G, sms), ks.squeeze_team(G, n_words, sms)
    short_ab = next(x for x in short["keccak_absorb"]["shapes"] if x["launch"] == "aggregation")
    short_sq = next(x for x in short["keccak_squeeze"]["shapes"] if x["launch"] == "aggregation")
    perms = int(nblk.max()), -(-n_words // keccak.RATE_WORDS) - 1
    for (name, team, ms_short, p) in (("absorb", ab_team, short_ab["ms"], perms[0]),
                                      ("squeeze", sq_team, short_sq["ms"], perms[1])):
        others = ", ".join(f"{t}: {teams[(name, t)]:.2f} ms" for t in SPONGE_TEAMS if t != team)
        log(f"wide keccak_{name} (aggregation launch, {G} sponges, {p} permutations the "
            f"longest): with the squeeze equals hashlib's SHAKE256 of every group's preimage; "
            f"{teams[(name, team)]:.2f} ms at {team} thread(s) a sponge (the other teams "
            f"{others}), {teams[(name, team)] * 1e3 / p:.3f} us a "
            f"permutation (short shape {ms_short:.4f} ms)")
        out_m[f"wide_{name}_ms"] = teams[(name, team)]
        for t in SPONGE_TEAMS:
            out_m[f"wide_{name}_team{t}_ms"] = teams[(name, t)]
        out_m[f"wide_{name}_chain_perms"] = p
    del calls, fleet, wbuf, total, pre, xof
    torch.cuda.empty_cache()
    return out_m


def capture_glue(params, fleet) -> tuple:
    """The arguments of the glue kernels' calls in one ``verify_batch_device``
    call on the fleet ({kernel: [args, ...]} in call order), and every
    kernel's launches in that call and in one ``build_fleet`` of the same
    size (fresh seeds)."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.ops import ragged_words as rw
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    before = Counter(kernels.LAUNCHES)
    calls = capture_calls(params, fleet, [(xd, "decode_coeffs_rows", "xof_decode"),
                                          (rw, "render_bigint_dec_w", "render_prehash"),
                                          (dp, "lattice_target", "lattice_target")])
    per_call = dict(Counter(kernels.LAUNCHES) - before)
    G, N = fleet[0].shape[:2]
    before = Counter(kernels.LAUNCHES)
    other = build_fleet(params, G, N, seed0=1 + 4 * G * N, device=fleet[0].device)
    torch.cuda.synchronize()
    per_fleet = dict(Counter(kernels.LAUNCHES) - before)
    del other
    require([len(calls[k]) for k in GLUE_KERNELS] == [2, 1, 1],
            f"a verify call's glue calls: { {k: len(v) for k, v in calls.items()} }")
    return calls, per_call, per_fleet


def lattice_breaches(args) -> int:
    """Kernel ``lattice_target`` and its plain version on the verify call's
    captured arguments with one group's observed sum off by one, a norm
    breach and a weight breach in two other groups, and a norm and a weight
    exactly at their limits in two more: both must give the same verdicts,
    false in exactly those three groups -> max abs error (0)."""
    from fusion_cryptography_tpu_torch.ops import lattice_target as lt

    field, vks, c_hat, alpha, observed, nrm, wgt, beta, omega = clone_args(args)
    G, d, q = vks.shape[0], vks.shape[3], field.q
    require(G >= 5 and beta < 2**31 - 1, "lattice breaches need 5 groups and beta < 2**31 - 1")
    g_obs, g_nrm, g_wgt = 1, G // 2, G - 1
    observed[g_obs, d // 3] = (observed[g_obs, d // 3] + 1) % q
    nrm[g_nrm, -1], wgt[g_wgt, 0] = beta + 1, omega + 1
    nrm[2, 0], wgt[G - 2, -1] = beta, omega  # at the limits: still accepted
    breached = (field, vks, c_hat, alpha, observed, nrm, wgt, beta, omega)
    got, want = lt.lattice_target(*breached), lt.lattice_target_plain(*breached)
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    falses = [torch.nonzero(~x).flatten().tolist() for x in got]
    require(err == 0 and falses == [[g_obs], [g_nrm], [g_wgt]],
            f"lattice_target on breached groups: verdicts false at {falses}, "
            f"expected {[[g_obs], [g_nrm], [g_wgt]]}; max abs err {err}")
    log(f"lattice_target, the verify call's arguments with a tampered group, a norm breach, a "
        f"weight breach and both limits met exactly: equals the plain version, false in "
        f"exactly groups {g_obs}, {g_nrm}, {g_wgt}")
    return err


# the glue kernels redesigned for Hopper after their first version: each row's
# status, and its launches' registers, shared memory, blocks an SM and waves
REDESIGNED_GLUE = {
    "xof_decode": "redesigned: placement over every warp, rows past the stream's end skipped",
    "render_prehash": "redesigned: branch-free digit render",
}


def launch_shape(name: str, args) -> dict:
    """The launch kernel ``name`` makes for a captured call's arguments
    (blocks, threads, shared memory, registers, blocks an SM, waves)."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd

    if name == "xof_decode":
        words, geom, n, ns = args
        return xd.launch_shape(geom, n, words.shape[1], ns)
    (digest,) = args
    return kernels.launch_shape("fct_render_prehash_shape", digest.shape[1])


def decode_crafted(args) -> int:
    """Kernel ``xof_decode`` against its plain version on crafted streams
    (``xof_decode.crafted_streams``: first hits on the share edges of 1, 3,
    4 and 8 warps, one slot hit in every share, every slot or none hit,
    slot 0 hit or not before the rows past the end) at a captured call's
    geometry, length, lanes and streams a lane -> max abs error (0)."""
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd

    words, geom, n, ns = args
    L = words.shape[1]
    crafted = torch.from_numpy(xd.crafted_streams(geom, n, ns, L, seed=SEED + n).view(
        np.int32)).to(words.device)
    err = max_abs_err(xd.decode_coeffs_rows(crafted, geom, n, ns),
                      xd.decode_rows_plain(crafted, geom, n, ns))
    require(err == 0, f"xof_decode != its plain version on crafted streams ({L} lanes x {ns})")
    log(f"xof_decode on crafted streams, {L} lanes x {ns} stream(s) of {n} bytes: equals the "
        "plain version")
    return err


def phase_glue_shapes(params, fleet, kernel_rows: list) -> None:
    """Kernels ``xof_decode`` (the challenge decode and the alphas' decode
    of the group stage's blob), ``render_prehash`` and ``lattice_target`` at
    the verify call's own launches (arguments captured from one call on the
    fleet): each equal to its plain version exactly, timed beside its bound
    and its plain version on those inputs; the lattice target also on those
    inputs with breaches (:func:`lattice_breaches`).  Each row's ms, plain_ms and
    bound_ms are sums over the call's launches; it also carries the
    launches of one verify call and of one fleet build."""
    from fusion_cryptography_tpu_torch.ops import lattice_target as lt
    from fusion_cryptography_tpu_torch.ops import ragged_words as rw
    from fusion_cryptography_tpu_torch.ops import xof_decode as xd

    calls, per_call, per_fleet = capture_glue(params, fleet)

    def decode(args):
        words, geom, n, ns = args
        return (lambda: xd.decode_coeffs_rows(*args), lambda: xd.decode_rows_plain(*args),
                bounds.xof_decode(geom, n, words.shape[1] * ns),
                dict(lanes=words.shape[1], streams=ns, words=words.shape[0], n_bytes=n))

    def render(args):
        (digest,) = args
        return (lambda: rw.render_bigint_dec_w(digest),
                lambda: rw.render_bigint_dec_plain(digest),
                bounds.render_prehash(digest.shape[1]), dict(lanes=digest.shape[1]))

    def target(args):
        vks, nrm = args[1], args[5]
        G, N, _, d = vks.shape
        return (lambda: lt.lattice_target(*args), lambda: lt.lattice_target_plain(*args),
                bounds.lattice_target(G, N, d, nrm.shape[-1]), dict(groups=G, signers=N))

    def as_ints(out):  # coefficients, a word chunk, or the three verdicts
        parts = (out,) if isinstance(out, torch.Tensor) else (
            (out.buf, out.length) if isinstance(out, rw.WChunk) else out)
        return torch.cat([x.reshape(-1).to(torch.int64) for x in parts])

    labels = {"xof_decode": ("challenge", "alphas"), "render_prehash": ("prehash",),
              "lattice_target": ("lattice",)}
    for name, setup in (("xof_decode", decode), ("render_prehash", render),
                        ("lattice_target", target)):
        shapes, errs = [], []
        for label, args in zip(labels[name], calls[name]):
            kernel, plain, b, shape = setup(args)
            errs.append(max_abs_err(as_ints(kernel()), as_ints(plain())))
            require(errs[-1] == 0, f"{name} ({label}) != its plain version at the verify call's "
                    "inputs")
            t_k = cuda_ms(kernel, 10)
            t_p = cuda_ms(plain, 1)
            shapes.append(dict(launch=label, ms=t_k, plain_ms=t_p, **b, **shape))
            log(f"{name}, the verify call's {label} launch {shape}: equals the plain version; "
                f"{t_k:.4f} ms, plain {t_p:.3f} ms, bound {b['bound_ms']:.4f} ms by "
                f"{b['bound_by']} ({t_k / b['bound_ms']:.2f}x)")
        if name == "lattice_target":
            errs.append(lattice_breaches(calls[name][0]))
        if name == "xof_decode":
            errs += [decode_crafted(args) for args in calls[name]]
        source, replaces = GLUE_ROWS[name]
        row = dict(name=name, route="cuda", source=source, replaces=replaces, library_ms=None,
                   launches_per_verify_call=per_call.get(name, 0),
                   launches_per_fleet_build=per_fleet.get(name, 0))
        if name in REDESIGNED_GLUE:
            row["status"] = REDESIGNED_GLUE[name]
            row["launch_shapes"] = [launch_shape(name, args) for args in calls[name]]
        sum_launches(row, shapes, errs)
        kernel_rows.append(row)
    log(f"launches of one verify call: {per_call}; of one fleet build: {per_fleet}")
    log(json.dumps({"launch_shapes": {r["name"]: r["launch_shapes"] for r in kernel_rows
                                      if "launch_shapes" in r}}))
    del calls
    torch.cuda.empty_cache()
    return per_call, per_fleet


def phase_place_preimages(params, fleet, kernel_rows: list, per_call: dict,
                          per_fleet: dict) -> None:
    """Kernel ``place_preimages`` at the verify call's own launch (its
    arguments captured from one call on the fleet: the fleet's 32,768
    messages, signer-major) and at the nist traffic's shape (32,768
    messages of 33 * k bytes, k = 1..100, signer-major): each equal to its
    plain version exactly, its words on memory filled with -1 just before
    (the caching allocator hands the freed block back), and timed beside
    its bound and its plain version.  The row's ms, plain_ms and bound are
    the verify call's launch; ``nist`` holds the other shape's."""
    from fusion_cryptography_tpu_torch.ops import place_preimages as pp
    from fusion_cryptography_tpu_torch.profile_verify import nist_messages

    (short,) = capture_calls(params, fleet, [(pp, "place_preimages", "place")])["place"]
    prefix, _, _, n_signers, _ = short
    data, lens, _ = pp.encode(nist_messages(len(fleet[1])))
    offsets, stream = pp.split(pp.stream_buffer(data, lens, pin=True).to(prefix.device),
                               len(lens))
    nist = (prefix, offsets, stream, n_signers, pp.rows_for(prefix.numel() + int(lens.max())))
    shapes, errs = {}, []
    for label, args in (("verify call", short), ("nist", nist)):
        _, offsets, stream, _, rows = args
        B = offsets.numel() - 1
        filled = torch.full((rows, B), -1, dtype=torch.int32, device=prefix.device)
        ptr = filled.data_ptr()
        del filled
        got = pp.place_preimages(*args)
        want = pp.place_preimages_plain(*args)
        errs.append(max(max_abs_err(g, w) for g, w in zip(got, want)))
        require(errs[-1] == 0, f"place_preimages ({label}) != its plain version")
        t_k = cuda_ms(lambda: pp.place_preimages(*args), 20)
        t_p = cuda_ms(lambda: pp.place_preimages_plain(*args), 1)
        b = bounds.place_preimages(B, rows, stream.numel())
        shapes[label] = dict(lanes=B, rows=rows, stream_bytes=stream.numel(), ms=t_k,
                             plain_ms=t_p, on_filled=got[0].data_ptr() == ptr, **b)
        log(f"place_preimages, {label}: {B} lanes x {rows} words, {stream.numel()} stream bytes: "
            f"equals the plain version (words on the -1-filled block: "
            f"{shapes[label]['on_filled']}); {t_k:.4f} ms, plain {t_p:.3f} ms, bound "
            f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({t_k / b['bound_ms']:.2f}x)")
    call = shapes["verify call"]
    kernel_rows.append(dict(
        name="place_preimages", route="cuda",
        source="fusion_cryptography_tpu_torch/csrc/place_preimages.cu",
        replaces="none: the JAX package lays the rows out on the host "
                 "(fusion_cryptography_tpu/scheme/device_pipeline.py msg_preimage_words)",
        library_ms=None, max_abs_err=max(errs), ms=call["ms"], plain_ms=call["plain_ms"],
        bound_ms=call["bound_ms"], bound_by=call["bound_by"], nist=shapes["nist"],
        launches_per_verify_call=per_call.get("place_preimages", 0),
        launches_per_fleet_build=per_fleet.get("place_preimages", 0)))
    del short, nist, offsets, stream
    torch.cuda.empty_cache()


def phase_sample_short(dev, kernel_rows: list, per_fleet: dict) -> None:
    """Kernel ``sample_short`` at the sign cell's shape (1,024 keys, every
    other seed from 2**32 - 1,024 as the sign cell takes them, so that keys
    cross into two-word seeds: 2,048 streams at secpar 128's d = 64) and at
    the main path's fleet (32,768 keys from seed 1: 65,536 streams at
    d = 256): each on an int32 output filled with -1, equal to the C sampler
    (``native.sample_short_batch``, its plain version) on the same seeds
    exactly, and timed (the kernel's device time in a trace, and a wrapper
    call's back to back) beside its bound (``bounds.sample_short``) and the C
    sampler's host time (as the host path runs it: one thread below 4,096
    streams, else a thread per 2,048 up to the cores).  Also the launches
    of one ``lifecycle.keygen`` at the sign cell's shape.  The row's ms,
    plain_ms and bound are the sign cell's shape; ``fleet`` holds the
    other."""
    from fusion_cryptography_tpu_torch import kernels, native
    from fusion_cryptography_tpu_torch import profile_verify as pv
    from fusion_cryptography_tpu_torch.ops import sample_short as ss
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    shapes, errs = {}, []
    for label, secpar, seeds in (
            ("sign cell", 128, np.arange(2**32 - 1024, 2**32 + 1024, 2, dtype=np.uint64)),
            ("fleet", SECPAR, np.arange(1, 1 + N_GROUPS * N_SIGNERS, dtype=np.uint64))):
        p = fusion_setup(secpar, SEED)
        B, d = seeds.size, p.degree
        args = (d, p.beta_sk, p.omega_sk, p.modulus)
        out = torch.full((B, 2, d), -1, dtype=torch.int32, device=dev)
        got = ss.sample_short(seeds, *args, dev, out=out)
        plain = []
        for _ in range(3):
            t0 = time.perf_counter()
            want = native.sample_short_batch([x for s in seeds.tolist() for x in (s, s + 1)],
                                             *args)
            plain.append((time.perf_counter() - t0) * 1e3)
        errs.append(max_abs_err(got.cpu(), torch.from_numpy(want.reshape(B, 2, d))))
        require(got is out and errs[-1] == 0,
                f"sample_short ({label}) != the C sampler on the -1-filled output")
        _, _, prof = pv.trace(lambda: [ss.sample_short(seeds, *args, dev, out=out)
                                       for _ in range(20)])
        t_k = median(pv.launch_times(prof)["sample_short"])
        t_call = cuda_ms(lambda: ss.sample_short(seeds, *args, dev, out=out), 20)
        b = bounds.sample_short(B, *args)
        shapes[label] = dict(keys=B, streams=2 * B, degree=d, ms=t_k, call_ms=t_call,
                             plain_ms=median(plain), **b)
        log(f"sample_short, {label}: {B} keys ({2 * B} streams) at d = {d}: equals the C "
            f"sampler on the -1-filled output; kernel {t_k:.4f} ms (median of 20 traced "
            f"launches), {t_call:.4f} ms a wrapper call back to back (seed upload included), "
            f"C sampler {median(plain):.3f} ms (median of 3), bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({t_k / b['bound_ms']:.2f}x; {b['words_per_stream']:.1f} words a "
            f"stream, {b['waves']} waves)")
        del out, got
    before = kernels.LAUNCHES["sample_short"]
    lc.keygen(fusion_setup(128, SEED), range(2**32 - 1024, 2**32 + 1024, 2), device=dev)
    per_keygen = kernels.LAUNCHES["sample_short"] - before
    require(per_keygen == 1, f"one keygen call launched sample_short {per_keygen} times")
    call = shapes["sign cell"]
    kernel_rows.append(dict(
        name="sample_short", route="cuda",
        source="fusion_cryptography_tpu_torch/csrc/sample_short.cu",
        replaces="none: the JAX package samples on the host "
                 "(native/fusion_native.c fn_sample_short_batch)",
        library_ms=None, max_abs_err=max(errs), ms=call["ms"], plain_ms=call["plain_ms"],
        call_ms=call["call_ms"], bound_ms=call["bound_ms"], bound_by=call["bound_by"],
        fleet=shapes["fleet"], launches_per_keygen_call=per_keygen,
        launches_per_fleet_build=per_fleet.get("sample_short", 0)))
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
    mw, mb, _ = dp._message_tensors(params, msgs, vks.device, vks.shape[1])
    _, c_hat_u, al = P.hash_chunk(vks, mw, mb)
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


def check_derive_alphas_grouped(params, fleet) -> dict:
    """``lifecycle.derive_alphas_grouped`` on phase 3's G x N inputs (its vk
    reprs and messages): equal to ``derive_coeffs_device``'s challenge and
    alpha coefficients, through kernels 1, 2, 4, 5, 6 and 7."""
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.interop import serial
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    vks, msgs, aggs = fleet
    G, N, d = vks.shape[0], vks.shape[1], params.degree
    _, _, _, cc, al = dp.derive_coeffs_device(params, vks, msgs, aggs)
    t0 = time.time()
    reprs = [serial.vk_str(params, v) for v in vks.reshape(G * N, 2, d).cpu().numpy()]
    t_reprs = time.time() - t0
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.time()
    cc_g, al_g = lc.derive_alphas_grouped(params, reprs, msgs, G, N, device=vks.device)
    t_derive = time.time() - t0
    ran = {k: kernels.LAUNCHES[k] - before.get(k, 0) for k in kernels.LAUNCHES}
    require(np.array_equal(cc_g, cc.cpu().numpy()) and np.array_equal(al_g, al.cpu().numpy()),
            "derive_alphas_grouped != derive_coeffs_device's coefficients")
    want = ("keccak_absorb", "keccak_squeeze", "ntt_u", "signer_fold_a", "signer_fold_b",
            "agg_fold")
    require(all(ran.get(k, 0) > 0 for k in want), f"derive_alphas_grouped launched {ran}")
    log(f"derive_alphas_grouped on phase 3's {G} x {N} vk reprs and messages: {t_derive:.3f} s "
        f"(reprs rendered in {t_reprs:.3f} s); equals derive_coeffs_device's challenge and "
        f"alpha coefficients; kernel launches {ran}")
    return {"derive_alphas_grouped_s": t_derive}


def drive_windows(params, dev) -> dict:
    """The windowed verify at G = W_GROUPS: signer chunks of W_CHUNK groups,
    group windows of W_HASH_CHUNK (four chunks, two windows)."""
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.profile_verify import span_times
    from fusion_cryptography_tpu_torch.profile_verify import trace as trace_call
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    G, N = W_GROUPS, N_SIGNERS
    t0 = time.time()
    vks, msgs, aggs = build_fleet(params, G, N, seed0=1 + 4 * N_GROUPS * N, device=dev)
    torch.cuda.synchronize()
    t_fleet = time.time() - t0
    require(isinstance(msgs, list) and vks.device == dev and aggs.device == dev, "fleet inputs")

    def verify(a=aggs):
        return dp.verify_batch_device(params, vks, msgs, a, group_chunk=W_CHUNK,
                                      group_hash_chunk=W_HASH_CHUNK)

    verify()  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eq, norm_ok, weight_ok = verify()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(bool(eq.all() & norm_ok.all() & weight_ok.all()),
            f"windowed verify of {G} groups: every verdict must be true")
    reps = 5
    t0 = time.time()
    outs = [verify() for _ in range(reps)]
    torch.cuda.synchronize()
    t_tp = time.time() - t0
    require(all(bool(o[0].all() & o[1].all() & o[2].all()) for o in outs), "windowed reps")
    del outs
    # the host's packing of each chunk's messages: the fct.pack spans of one
    # more call, traced
    _, _, prof = trace_call(verify)
    _, packing = span_times(prof)
    bad_g = 2 * W_CHUNK + W_CHUNK // 7  # in the third signer chunk, the second window
    bad = aggs.clone()
    bad[bad_g, 0, 0] = (bad[bad_g, 0, 0] + 1) % Q
    rejected = torch.nonzero(~verify(bad)[0]).flatten().tolist()
    require(rejected == [bad_g], f"windowed verify, tampered group {bad_g}: rejected {rejected}")
    del bad
    sub = (vks[:N_GROUPS], msgs[:N_GROUPS * N], aggs[:N_GROUPS])
    one = dp.derive_coeffs_device(params, *sub)
    four = dp.derive_coeffs_device(params, *sub, group_chunk=N_GROUPS // 4)
    for name, a, b in zip(("eq", "norm_ok", "weight_ok", "cc", "alphas"), one, four):
        require(torch.equal(a, b), f"derive_coeffs_device(group_chunk={N_GROUPS // 4}) {name} "
                "!= one chunk")
    vps = reps * G / t_tp
    log(f"windowed verify: fleet of {G} groups x {N} in {t_fleet:.3f} s; group_chunk {W_CHUNK}, "
        f"group_hash_chunk {W_HASH_CHUNK}: one call under set_sync_debug_mode('error') (no "
        f"host sync), every verdict true; {reps} calls, one sync: {t_tp:.3f} s -> {vps:,.0f} "
        f"verifies/s; host packing per chunk "
        f"{', '.join(f'{t:.2f}' for t in packing)} ms; a tampered aggregate in group "
        f"{bad_g} fails alone; derive_coeffs_device on {N_GROUPS} groups in chunks of "
        f"{N_GROUPS // 4} equals one chunk")
    return {"window_groups": G, "window_group_chunk": W_CHUNK,
            "window_group_hash_chunk": W_HASH_CHUNK, "window_fleet_s": t_fleet,
            "window_verifies_per_s": vps, "window_verify_reps_s": t_tp,
            "window_packing_ms": packing}


def check_absorb_segments(dev) -> dict:
    """``keccak.shake256_absorb_segments_words`` at B = 32,768 lanes of five
    ragged segments (0-300 bytes each, across the rate): the card's states
    equal the CPU plain version's."""
    from fusion_cryptography_tpu_torch.ops import keccak

    rng = np.random.default_rng(SEED)
    B = N_GROUPS * N_SIGNERS
    segs = []
    for mn, mx in ((130, 150), (1, 300), (7, 7), (0, 140), (136, 136)):
        lens = rng.integers(mn, mx + 1, B).astype(np.int32)
        by = rng.integers(0, 256, size=(B, 4 * (-(-mx // 4))), dtype=np.uint8)
        by[np.arange(by.shape[1])[None, :] >= lens[:, None]] = 0
        segs.append((torch.from_numpy(by.view(np.int32).T.copy()), torch.from_numpy(lens), mn, mx))
    t0 = time.time()
    got = keccak.shake256_absorb_segments_words(
        [(w.to(dev), ln.to(dev), mn, mx) for w, ln, mn, mx in segs])
    torch.cuda.synchronize()
    t_card = time.time() - t0
    want = keccak.shake256_absorb_segments_words(segs)
    require(torch.equal(got.cpu(), want), "shake256_absorb_segments_words: CUDA != CPU")
    log(f"shake256_absorb_segments_words: {B} lanes of 5 ragged segments (7-733 bytes a lane) "
        f"on the card ({t_card:.3f} s, first call) equal the CPU plain version")
    return {"absorb_segments_s": t_card}


def check_cli(dev) -> dict:
    """``python -m fusion_cryptography_tpu_torch`` at secpar=256 (in process):
    setup, two keygens, two signs, aggregate and verify exit 0 with
    ``--device cuda``, a tampered message exits 1 with the reference's
    reason, and every file equals the one ``--device cpu`` writes."""
    import contextlib
    import io

    from fusion_cryptography_tpu_torch.__main__ import main as cli
    from fusion_cryptography_tpu_torch.scheme.lifecycle import REASON_TARGET

    build = REPO / "build"
    build.mkdir(exist_ok=True)
    names = ("params.fp", "sk1.fp", "vk1.fp", "sk2.fp", "vk2.fp", "s1.fp", "s2.fp", "agg.fp")
    times = {}
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for label, where in (("card", dev.type), ("cpu", "cpu")):
            d = Path(tmp) / label
            d.mkdir()
            msgs = ("h\u00e9llo", "world")

            def p(name):
                return str(d / name)

            def run(*argv):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = cli([argv[0], "--device", where, *argv[1:]])
                return rc, out.getvalue().strip()

            def verify(first):
                return run("verify", "--params", p("params.fp"), "--vk", p("vk1.fp"), "--message",
                           first, "--vk", p("vk2.fp"), "--message", msgs[1], "--agg", p("agg.fp"))

            t0 = time.time()
            steps = [run("setup", "--secpar", str(SECPAR), "--seed", "42", "--out", p("params.fp"))]
            for k, seed in ((1, 7), (2, 8)):
                steps.append(run("keygen", "--params", p("params.fp"), "--seed", str(seed),
                                 "--out-sk", p(f"sk{k}.fp"), "--out-vk", p(f"vk{k}.fp")))
            for k in (1, 2):
                steps.append(run("sign", "--params", p("params.fp"), "--sk", p(f"sk{k}.fp"),
                                 "--message", msgs[k - 1], "--out", p(f"s{k}.fp")))
            steps.append(run("aggregate", "--params", p("params.fp"),
                             "--vk", p("vk1.fp"), "--message", msgs[0], "--sig", p("s1.fp"),
                             "--vk", p("vk2.fp"), "--message", msgs[1], "--sig", p("s2.fp"),
                             "--out", p("agg.fp")))
            steps.append(verify(msgs[0]))
            require(all(rc == 0 for rc, _ in steps), f"CLI --device {where}: {steps}")
            require(steps[-1][1] == "OK", f"CLI verify --device {where}: {steps[-1]}")
            bad = verify("HELLO")
            require(bad == (1, f"FAIL: {REASON_TARGET}"), f"CLI tampered --device {where}: {bad}")
            times[label] = time.time() - t0
        differ = [n for n in names if not filecmp.cmp(Path(tmp) / "card" / n,
                                                     Path(tmp) / "cpu" / n, shallow=False)]
        require(not differ, f"CLI files --device {dev.type} != --device cpu: {differ}")
    log(f"CLI at secpar={SECPAR}: setup, 2 keygens, 2 signs, aggregate, verify exit 0 "
        f"(--device {dev.type} {times['card']:.3f} s, cpu {times['cpu']:.3f} s); a tampered "
        "message exits 1 with the reference's reason; all 8 files byte-equal across the devices")
    return {"cli_card_s": times["card"], "cli_cpu_s": times["cpu"]}


def drive_aux(params, fleet, dev) -> tuple:
    """Phase W: ``derive_alphas_grouped`` on phase 3's fleet, which is then
    freed, the windowed verify at G = W_GROUPS, the segmented absorb and the
    CLI -> (metrics, kernel launches while they ran)."""
    from fusion_cryptography_tpu_torch import kernels

    kernels.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    metrics = check_derive_alphas_grouped(params, fleet)
    fleet.clear()
    torch.cuda.empty_cache()
    metrics.update(drive_windows(params, dev))
    torch.cuda.empty_cache()
    metrics.update(check_absorb_segments(dev))
    metrics.update(check_cli(dev))
    launches = dict(kernels.LAUNCHES)
    metrics["phase_w_s"] = time.time() - t0
    log(f"phase W in {metrics['phase_w_s']:.3f} s; kernel launches: {launches}")
    return metrics, launches


@contextmanager
def uncounted():
    """Kernel launches inside are not counted: references and comparisons."""
    from fusion_cryptography_tpu_torch import kernels

    saved = Counter(kernels.LAUNCHES)
    try:
        yield
    finally:
        kernels.LAUNCHES.clear()
        kernels.LAUNCHES.update(saved)


def unsharded_step(params, sk, c, al) -> tuple:
    """The unsharded port's lifecycle on the step's global inputs, on their
    device, in chunks of 4,096 keys: sk_hat = ntt_fwd(sk) (kernel
    ``ntt_centered``), vk = Σ_r A_r ⊙ sk_hat, ``lifecycle.sign_from_c_hat``
    and ``lifecycle.aggregate_from_alpha_hat`` -> (vk int32[B, 2, d], agg
    int32[rank_p, d])."""
    from fusion_cryptography_tpu_torch.ops.ntt import ntt_fwd
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    plan = params.plan
    F = plan.field
    B, rank_p, d = sk.shape[0], sk.shape[2], params.degree
    a = np.zeros((rank_p, d), np.int32)
    a[:params.rank] = params.public_challenge
    a_mont = F.to_mont(F.to_unsigned(torch.from_numpy(a).to(sk.device)))
    c_hat, al_hat = ntt_fwd(plan, c), ntt_fwd(plan, al)
    vk = torch.empty((B, 2, d), dtype=torch.int32, device=sk.device)
    agg_u = torch.zeros((rank_p, d), dtype=torch.int64, device=sk.device)
    for lo in range(0, B, 4096):
        hi = min(B, lo + 4096)
        sk_hat = ntt_fwd(plan, sk[lo:hi])
        vk[lo:hi] = F.to_centered(F.dot_mod(a_mont, F.to_unsigned(sk_hat), axis=-2))
        sig = lc.sign_from_c_hat(params, sk_hat, c_hat[lo:hi])
        part = lc.aggregate_from_alpha_hat(params, sig, al_hat[lo:hi])
        agg_u = F.add_mod(agg_u, F.to_unsigned(part))
    return vk, F.to_centered(agg_u)


def real_step_rank(secpar: int, seed: int, seeds: list, msgs: list) -> dict:
    """On a CPU rank of a world of one (parallel/_launch): prepare_real and
    the step at mesh (1, 1) on the CPU."""
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.parallel import make_mesh
    from fusion_cryptography_tpu_torch.parallel.sharded import prepare_real, sharded_lifecycle_step

    params = fusion_setup(secpar, seed)
    step, _, rank_p = sharded_lifecycle_step(params, make_mesh((1, 1), device="cpu"))
    sk, cc, al, keys, order = prepare_real(params, rank_p, seeds, msgs, device="cpu")
    return {"inputs": (sk, cc, al), "reprs": keys.vk_strs(), "order": order,
            "outputs": [o.numpy() for o in step(sk, cc, al)]}


def call_trace(fn) -> dict:
    """One warm call of ``fn`` under torch.profiler
    (``profile_verify.trace``) -> its wall ms and device busy ms, split into
    the port's kernels, NCCL and the rest (torch glue), and the eight
    largest device rows."""
    from fusion_cryptography_tpu_torch import profile_verify as pv

    fn()
    wall, rows, _ = pv.trace(fn)
    split = {"port_ms": 0.0, "nccl_ms": 0.0, "glue_ms": 0.0}
    for name, us, _ in rows:
        key = "port_ms" if pv.port_kernel(name) else "nccl_ms" if "nccl" in name.lower() \
            else "glue_ms"
        split[key] += us / 1e3
    return {"wall_ms": wall * 1e3, "busy_ms": sum(split.values()), **split,
            "top": [[name[:70], us / 1e3, n] for name, us, n in rows[:8]]}


def log_trace(what: str, t: dict) -> None:
    log(f"{what}: {t['wall_ms']:.2f} ms wall, device busy {t['busy_ms']:.2f} ms: port kernels "
        f"{t['port_ms']:.2f}, NCCL {t['nccl_ms']:.2f}, the rest (torch glue) {t['glue_ms']:.2f}")
    for name, ms, n in t["top"]:
        log(f"  {ms:9.3f} ms  x{n:<4d} {name}")


def multi_card_rank(secpar: int, seed: int, keys: int, groups: int, bad_g: int,
                    ntt_rows: int, device: str = "cuda") -> dict:
    """One rank of the multi-card phase (parallel/_launch, one process a
    card): config 4 (``pod_scale.lifecycle_throughput`` on ``keys`` keys of
    ``device_inputs``, mesh ``make_mesh()``, one step traced), config 5
    (``pod_scale.verify_throughput`` of ``groups`` groups x N_SIGNERS on
    mesh (world, 1), each rank building its own, then once more with group
    ``bad_g`` tampered) and both NTTs at S = world -> this rank's shards,
    rates, trace and launches."""
    import torch.distributed as dist

    from fusion_cryptography_tpu_torch import kernels, pod_scale
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.parallel import distributed_ntt as dn
    from fusion_cryptography_tpu_torch.parallel import make_mesh
    from fusion_cryptography_tpu_torch.parallel.mesh import mesh_device
    from fusion_cryptography_tpu_torch.parallel.sharded import (
        device_inputs, shard, sharded_lifecycle_step, sharded_verify_local)

    params = fusion_setup(secpar, seed)
    world, rank = dist.get_world_size(), dist.get_rank()
    mesh, vmesh = make_mesh(device=device), make_mesh((world, 1), device=device)
    dev = mesh_device(mesh)
    kernels.LAUNCHES.clear()
    inputs = device_inputs(params, mesh, keys)
    life, (vk, agg, eq, norm_ok, w_ok) = pod_scale.lifecycle_throughput(params, mesh, inputs)
    step = sharded_lifecycle_step(params, mesh)[0]
    trace = call_trace(lambda: step(*inputs)) if dev.type == "cuda" else None
    del inputs
    vks, msgs, aggs = pod_scale.local_fleet(params, vmesh, groups)
    ver, _ = pod_scale.verify_throughput(params, vmesh, (vks, msgs, aggs))
    lo = rank * (groups // world)
    if lo <= bad_g < lo + groups // world:
        aggs[bad_g - lo, 0, 0] = (aggs[bad_g - lo, 0, 0] + 1) % Q
    verdicts = sharded_verify_local(params, vmesh, vks, msgs, aggs)
    del vks, msgs, aggs
    smesh = make_mesh((world, 1), ("sp", "rep"), device=device)
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        -(Q // 2), Q // 2 + 1, size=(ntt_rows, params.degree)).astype(np.int32))
    fwd, inv = dn.make_distributed_ntt(params.plan, smesh)
    y = fwd(shard(smesh, x, (None, "sp")).to(dev))
    fwd4, inv4, layout, unlayout = dn.make_fourstep_ntt(params.plan, smesh)
    y4 = fwd4(shard(smesh, layout(x), (None, "sp")).to(dev))
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    return {"vk": vk.cpu().numpy(), "agg": agg.cpu().numpy(),
            "flags": [bool(eq), bool(norm_ok), bool(w_ok)], "life": life, "verify": ver,
            "verdicts": [v.cpu().numpy() for v in verdicts],
            "ntt": [y.cpu().numpy(), inv(y).cpu().numpy()],
            "fourstep": [y4.cpu().numpy(), inv4(y4).cpu().numpy()],
            "trace": trace, "peak_gb": peak,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
            "launches": dict(kernels.LAUNCHES)}


def multi_card_refs(params, mesh, world: int, dev) -> dict:
    """The one-rank run the multi-card phase is held against, on this
    process's one-rank world: the step on D_KEYS x world keys, the verify of
    N_GROUPS x world groups with one tampered, and ntt_fwd of the NTT rows."""
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.ops.ntt import ntt_fwd
    from fusion_cryptography_tpu_torch.parallel.sharded import (
        device_inputs, sharded_lifecycle_step, sharded_verify_device)
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    keys, groups = D_KEYS * world, N_GROUPS * world
    bad_g = (world - 1) * N_GROUPS + N_GROUPS // 7
    step, _, _ = sharded_lifecycle_step(params, mesh)
    inputs = device_inputs(params, mesh, keys)
    vk, agg, eq, norm_ok, w_ok = step(*inputs)
    require(bool(eq & norm_ok & w_ok), f"one-rank step at {keys} keys: verdicts")
    ref = {"keys": keys, "groups": groups, "bad_g": bad_g, "vk": vk.cpu(), "agg": agg.cpu()}
    del inputs, vk, agg
    vks, msgs, aggs = build_fleet(params, groups, N_SIGNERS, seed0=1, device=dev)
    aggs[bad_g, 0, 0] = (aggs[bad_g, 0, 0] + 1) % Q
    ref["verdicts"] = [v.cpu() for v in sharded_verify_device(params, mesh, vks, msgs, aggs)]
    del vks, msgs, aggs
    x = np.random.default_rng(SEED).integers(-(Q // 2), Q // 2 + 1,
                                             size=(D_NTT_ROWS, params.degree)).astype(np.int32)
    ref["x"], ref["ntt"] = x, ntt_fwd(params.plan, torch.from_numpy(x).to(dev)).cpu()
    torch.cuda.empty_cache()
    return ref


def drive_multi_card(params, ref: dict, world: int, one_card: dict) -> dict:
    """The multi-card phase: a world of ``world`` NCCL ranks (one process a
    card) runs config 4, config 5 and both NTTs; each result must equal the
    one-rank run's (``ref``); prints the scaling efficiencies against the
    one-rank rates ``one_card`` (the same ``pod_scale`` calls at the same
    per-card batch)."""
    from fusion_cryptography_tpu_torch import pod_scale
    from fusion_cryptography_tpu_torch.parallel import _launch

    t0 = time.time()
    ranks = _launch.launch(world, f"{Path(__file__).resolve()}:multi_card_rank", SECPAR, SEED,
                           ref["keys"], ref["groups"], ref["bad_g"], D_NTT_ROWS,
                           device="cuda", timeout_s=600)
    t_world = time.time() - t0
    dp, tp = ranks[0]["mesh"]["dp"], ranks[0]["mesh"]["tp"]
    at = lambda i, j: ranks[i * tp + j]  # noqa: E731
    vk = np.concatenate([at(i, 0)["vk"] for i in range(dp)])
    agg = np.concatenate([at(0, j)["agg"] for j in range(tp)])
    rank = params.rank
    require(all(np.array_equal(at(i, j)["vk"], at(i, 0)["vk"]) and
                np.array_equal(at(i, j)["agg"], at(0, j)["agg"])
                for i in range(dp) for j in range(tp)), "multi-card step: replicas differ")
    require(np.array_equal(vk, ref["vk"].numpy()), "multi-card vk != the one-rank run's")
    require(np.array_equal(agg[:rank], ref["agg"].numpy()[:rank]) and not agg[rank:].any(),
            "multi-card agg != the one-rank run's")
    require(all(r["flags"] == [True] * 3 and r["life"]["verified"] for r in ranks),
            "multi-card step verdicts")
    require(all(r["verify"]["verified"] for r in ranks), "multi-card verify: a verdict false")
    for r in ranks:
        require(all(np.array_equal(a, b.numpy()) for a, b in zip(r["verdicts"], ref["verdicts"])),
                "multi-card verify verdicts (tampered) != the one-rank run's")
    rejected = np.nonzero(~ref["verdicts"][0].numpy())[0].tolist()
    require(rejected == [ref["bad_g"]], f"multi-card tampered group: rejected {rejected}")
    for key in ("ntt", "fourstep"):
        y = np.concatenate([r[key][0] for r in ranks], axis=1)
        require(np.array_equal(y, ref["ntt"].numpy()), f"multi-card {key} forward != ntt_fwd")
    back = np.concatenate([r["ntt"][1] for r in ranks], axis=1)
    require(np.array_equal(back, ref["x"]), "multi-card matrix NTT round trip")
    back4 = np.concatenate([r["fourstep"][1] for r in ranks], axis=1)
    S, d = world, params.degree
    back4 = back4.reshape(-1, S, d // S).transpose(0, 2, 1).reshape(-1, d)  # unlayout
    require(np.array_equal(back4, ref["x"]), "multi-card four-step round trip")
    life, ver = ranks[0]["life"], ranks[0]["verify"]  # the slowest rank's, on every rank
    kps, vps = life["keys_per_s"], ver["verifies_per_s"]
    eff_step = pod_scale.scaling_efficiency(kps, one_card["keys_per_s"], world)
    eff_verify = pod_scale.scaling_efficiency(vps, one_card["verifies_per_s"], world)
    log(f"multi-card phase: {world} NCCL ranks, step mesh (dp={dp}, tp={tp}): config 4 at "
        f"{ref['keys']} keys in {life['seconds'] * 1e3:.1f} ms -> {kps:,.0f} keys/s; config 5 "
        f"cut to {ref['groups']} groups ({N_GROUPS} a card, each card building its own) in "
        f"{ver['seconds'] * 1e3:.1f} ms -> {vps:,.0f} verifies/s; both NTTs at S={world} on "
        f"{D_NTT_ROWS} rows; every result equals the one-rank run's (world of {world} in "
        f"{t_world:.1f} s, peak {max(r['peak_gb'] for r in ranks):.2f} GB a card)")
    log(f"scaling efficiency at a constant per-card batch (pod_scale, best of "
        f"{pod_scale.REPS} at the slowest rank): lifecycle {eff_step:.4f} ({kps:,.0f} / "
        f"({world} x {one_card['keys_per_s']:,.0f})), verify {eff_verify:.4f} ({vps:,.0f} / "
        f"({world} x {one_card['verifies_per_s']:,.0f}))")
    log_trace(f"multi-card phase, rank 0: one traced step at {ref['keys']} keys",
              ranks[0]["trace"])
    log(f"kernel launches by rank: {[r['launches'] for r in ranks]}")
    return {"multi_cards": world, "multi_keys_per_s": kps, "multi_verifies_per_s": vps,
            "scaling_efficiency_lifecycle": eff_step, "scaling_efficiency_verify": eff_verify,
            "multi_peak_gb": max(r["peak_gb"] for r in ranks),
            "multi_step_trace": ranks[0]["trace"], "multi_world_s": t_world}


def drive_sharded(params, dev) -> tuple:
    """Phase D: ``parallel/`` on a one-rank NCCL world on the card (file
    rendezvous), then, with two cards or more, a world of min(4, cards)
    NCCL ranks -> (metrics, kernel launches while the one-rank path ran,
    the step's own launches)."""
    import torch.distributed as dist

    from fusion_cryptography_tpu_torch import demo, kernels, pod_scale
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.ops.ntt import ntt_fwd, ntt_inv
    from fusion_cryptography_tpu_torch.parallel import _launch, distributed, make_mesh
    from fusion_cryptography_tpu_torch.parallel import distributed_ntt as dn
    from fusion_cryptography_tpu_torch.parallel.sharded import (
        device_inputs, prepare_real, sharded_lifecycle_step, sharded_verify_device)
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

    t_phase = time.time()
    # the CPU half of the prepare_real check (a gloo world of one) runs
    # beside the untimed checks below and is collected before any timed call
    seeds, msgs_r = [SEED * 1000 + i for i in range(D_REAL_KEYS)], \
        [f"phase-d:{i}" for i in range(D_REAL_KEYS)]
    pool = ThreadPoolExecutor(1)
    cpu_real = pool.submit(_launch.launch, 1, f"{Path(__file__).resolve()}:real_step_rank",
                           SECPAR, SEED, seeds, msgs_r, device="cpu", timeout_s=600)
    require(demo.main(["--device", "cuda"]) == 0, "demo on the card")
    G, N = N_GROUPS, N_SIGNERS
    metrics, multi_ref, cards = {}, None, torch.cuda.device_count()
    with distributed.single_process_world(dev) as rdev:
        require(rdev == dev and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
                f"one-rank world: {rdev}, {dist.get_backend()}")
        mesh = make_mesh((1, 1))
        vks, msgs, aggs = build_fleet(params, G, N, seed0=1, device=dev)  # phase 3's fleet
        bad_g = G // 3
        bad = aggs.clone()
        bad[bad_g, 0, 0] = (bad[bad_g, 0, 0] + 1) % Q
        with uncounted():
            want = {a: dp.verify_batch_device(params, vks, msgs, aggs, assembly=a)
                    for a in ("fold", "spec")}
        kernels.LAUNCHES.clear()
        torch.cuda.synchronize()
        for a in ("fold", "spec"):
            got = sharded_verify_device(params, mesh, vks, msgs, aggs, assembly=a)
            require(all(torch.equal(g, w) for g, w in zip(got, want[a])),
                    f"sharded_verify_device ({a}) != verify_batch_device")
            require(bool(got[0].all() & got[1].all() & got[2].all()), f"sharded verify ({a})")
            rejected = torch.nonzero(
                ~sharded_verify_device(params, mesh, vks, msgs, bad, assembly=a)[0])
            rejected = rejected.flatten().tolist()
            require(rejected == [bad_g], f"sharded verify ({a}), tampered: rejected {rejected}")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eq, norm_ok, w_ok = sharded_verify_device(params, mesh, vks, msgs, aggs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        require(bool(eq.all() & norm_ok.all() & w_ok.all()), "sharded verify under sync check")
        cpu = cpu_real.result()[0]
        pool.shutdown()
        ver, _ = pod_scale.verify_throughput(params, mesh, (vks, msgs, aggs))
        require(ver["verified"], "sharded verify (pod_scale): a verdict false")
        vtrace = call_trace(lambda: sharded_verify_device(params, mesh, vks, msgs, aggs))
        metrics.update(sharded_verifies_per_s=ver["verifies_per_s"],
                       sharded_verify_s=ver["seconds"], sharded_verify_trace=vtrace)
        log(f"phase D, one-rank NCCL world on {dev}: sharded_verify_device on phase 3's "
            f"{G} x {N} fleet equals verify_batch_device in both assemblies, the tampered "
            f"group {bad_g} fails alone; a warm call runs under set_sync_debug_mode('error'); "
            f"pod_scale.verify_throughput: {ver['seconds'] * 1e3:.2f} ms, "
            f"{ver['verifies_per_s']:,.0f} verifies/s (best of {pod_scale.REPS} synced calls)")
        log_trace("phase D: one traced sharded verify", vtrace)
        del vks, msgs, aggs, bad, want

        inputs = device_inputs(params, mesh, D_KEYS)
        before = Counter(kernels.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        life, outs = pod_scale.lifecycle_throughput(params, mesh, inputs)
        step_launches = dict(Counter(kernels.LAUNCHES) - before)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        vk, agg, eq, norm_ok, w_ok = outs
        require(life["verified"], "sharded_lifecycle_step verdicts")
        with uncounted():
            ref_vk, ref_agg = unsharded_step(params, *inputs)
        require(torch.equal(vk, ref_vk) and torch.equal(agg, ref_agg),
                "sharded_lifecycle_step != the unsharded port")
        step = sharded_lifecycle_step(params, mesh)[0]
        trace = call_trace(lambda: step(*inputs))
        metrics.update(sharded_step_keys=D_KEYS, sharded_step_keys_per_s=life["keys_per_s"],
                       sharded_step_s=life["seconds"], sharded_step_peak_gb=peak_gb,
                       sharded_step_trace=trace)
        log(f"phase D: sharded_lifecycle_step at {D_KEYS} keys (one card's share of config 4's "
            f"65,536), secpar={SECPAR}, rank {life['rank_p']}: pod_scale.lifecycle_throughput "
            f"{life['seconds'] * 1e3:.2f} ms -> {life['keys_per_s']:,.0f} keys/s (best of "
            f"{pod_scale.REPS}); peak device memory {peak_gb:.2f} GB; vk and agg equal the "
            f"unsharded port's on the card, every verdict true; the step's launches "
            f"{step_launches} in {pod_scale.REPS + 1} calls")
        log_trace(f"phase D: one traced step at {D_KEYS} keys", trace)
        del inputs, outs, vk, agg, ref_vk, ref_agg

        sk, cc, al, keys, order = prepare_real(params, life["rank_p"], seeds, msgs_r, device=dev)
        out_card = [o.cpu().numpy() for o in
                    sharded_lifecycle_step(params, mesh)[0](sk, cc, al)]
        require(order == cpu["order"] and keys.vk_strs() == cpu["reprs"],
                "prepare_real: order or reprs differ between the card and the CPU")
        require(all(np.array_equal(a, b) for a, b in zip((sk, cc, al), cpu["inputs"])),
                "prepare_real: inputs differ between the card and the CPU")
        require(all(np.array_equal(a, b) for a, b in zip(out_card, cpu["outputs"])),
                "prepare_real: step outputs differ between the card and the CPU")
        require(all(bool(x) for x in out_card[2:]), "prepare_real step verdicts")
        log(f"phase D: prepare_real at B={D_REAL_KEYS} and the step on it give the same arrays, "
            "reprs, order and outputs on the card as on the CPU (a gloo world of one)")

        smesh = make_mesh((1, 1), ("sp", "rep"))
        x = torch.from_numpy(np.random.default_rng(SEED).integers(
            -(Q // 2), Q // 2 + 1, size=(D_NTT_ROWS, params.degree)).astype(np.int32)).to(dev)
        with uncounted():
            want_f, want_i = ntt_fwd(params.plan, x), ntt_inv(params.plan, x)
        fwd, inv = dn.make_distributed_ntt(params.plan, smesh)
        fwd4, inv4, layout, unlayout = dn.make_fourstep_ntt(params.plan, smesh)
        t0 = time.time()
        y = fwd(x)
        torch.cuda.synchronize()
        t_matrix = time.time() - t0
        t0 = time.time()
        y4 = fwd4(layout(x))
        torch.cuda.synchronize()
        t_four = time.time() - t0
        require(torch.equal(y, want_f) and torch.equal(inv(x), want_i) and torch.equal(inv(y), x),
                "make_distributed_ntt at S=1 != ntt_fwd / ntt_inv")
        require(torch.equal(y4, want_f) and torch.equal(unlayout(inv4(y4)), x),
                "make_fourstep_ntt at S=1 != ntt_fwd")
        metrics.update(matrix_ntt_s=t_matrix, fourstep_ntt_s=t_four)
        log(f"phase D: both distributed NTTs at S=1 on {D_NTT_ROWS} rows equal ntt_fwd / ntt_inv "
            f"(forward: matrix form {t_matrix * 1e3:.1f} ms, four-step {t_four * 1e3:.1f} ms, "
            "first calls)")
        launches = dict(kernels.LAUNCHES)
        if cards >= 2:
            with uncounted():
                multi_ref = multi_card_refs(params, mesh, min(4, cards), dev)
    if multi_ref is None:
        log(f"phase D: the multi-card phase did not run: {cards} CUDA card visible, and NCCL "
            "needs a card a rank")
    else:
        one_card = {"keys_per_s": life["keys_per_s"], "verifies_per_s": ver["verifies_per_s"]}
        metrics.update(drive_multi_card(params, multi_ref, min(4, cards), one_card))
    metrics["phase_d_s"] = time.time() - t_phase
    log(f"phase D in {metrics['phase_d_s']:.3f} s; kernel launches on the one-rank path: "
        f"{launches}")
    return metrics, launches, step_launches


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


def sponge_team_times(dev, card: str) -> int:
    """``--sponge-teams``: kernels ``keccak_absorb`` and ``keccak_squeeze``
    at two threads and at a warp a sponge, on random words, each output
    first held against the other team's and the first lane against
    hashlib's SHAKE256 of its words, then timed by CUDA events in turns
    (pair, warp, warp, pair):

    - the wide cell's aggregation chain: 32 sponges of 71,667 blocks, and
      a squeeze of 29,876 permutations (1,015,802 words: the last block
      part full);
    - the crossover: absorbs of 64 blocks at 32 to 8,192 sponges.

    Prints one ``{"sponge_teams": ...}`` line."""
    from fusion_cryptography_tpu_torch.ops import keccak, keccak_sponge as ks

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def words(rows, B):
        return torch.randint(-(2**31), 2**31, (rows, B), dtype=torch.int32, device=dev,
                             generator=gen)

    def in_turns(fn, teams=(2, 32, 32, 2), reps=1):
        ms = {t: [] for t in teams}
        for t in teams:
            ms[t].append(cuda_ms(lambda: fn(t), reps))
        return {t: min(v) for t, v in ms.items()}

    out = {}
    # the wide chain; lane 0's last byte is SHAKE256's padding (0x1F | 0x80),
    # so its blocks are the padded message of their other bytes
    G, blocks, sq_words = 32, 71667, 29877 * keccak.RATE_WORDS - 16
    w = words(blocks * keccak.RATE_WORDS, G)
    w[-1, 0] = (w[-1, 0] & 0x00FFFFFF) | ((0x9F << 24) - (1 << 32))
    nb = torch.full((G,), blocks, dtype=torch.int32, device=dev)
    states = {t: ks._absorb_launch(w, nb, t) for t in (2, 32)}
    require(torch.equal(states[2], states[32]), "wide absorb: the warp != the pair")
    xof = {t: ks._squeeze_launch(states[2], sq_words, t) for t in (2, 32)}
    require(torch.equal(xof[2], xof[32]), "wide squeeze: the warp != the pair")
    msg = w[:, 0].cpu().numpy().tobytes()[:-1]
    tail = xof[32][-4:, 0].cpu().numpy().tobytes()
    want = hashlib.shake_256(msg).digest(4 * sq_words)
    require(xof[32][:16, 0].cpu().numpy().tobytes() == want[:64] and want[-16:] == tail,
            "wide chain: lane 0 != hashlib's SHAKE256")
    t_ab = in_turns(lambda t: ks._absorb_launch(w, nb, t))
    t_sq = in_turns(lambda t: ks._squeeze_launch(states[2], sq_words, t))
    out["wide"] = dict(sponges=G, absorb_blocks=blocks, squeeze_permutations=29876,
                       absorb_ms=t_ab, squeeze_ms=t_sq,
                       absorb_us_a_permutation={t: v * 1e3 / blocks for t, v in t_ab.items()},
                       squeeze_us_a_permutation={t: v * 1e3 / 29876 for t, v in t_sq.items()})
    log(f"wide chain: absorb pair {t_ab[2]:.2f} ms, warp {t_ab[32]:.2f} ms; squeeze pair "
        f"{t_sq[2]:.2f} ms, warp {t_sq[32]:.2f} ms")
    del w, states, xof
    # the crossover
    blocks, rows = 64, []
    for B in (32, 128, 512, 768, 1024, 2048, 4096, 8192):
        w = words(blocks * keccak.RATE_WORDS, B)
        nb = torch.full((B,), blocks, dtype=torch.int32, device=dev)
        require(torch.equal(ks._absorb_launch(w, nb, 2), ks._absorb_launch(w, nb, 32)),
                f"absorb at {B} sponges: the warp != the pair")
        t = in_turns(lambda team: ks._absorb_launch(w, nb, team), reps=3)
        rows.append(dict(sponges=B, blocks=blocks, pair_ms=t[2], warp_ms=t[32],
                         warp_over_pair=t[32] / t[2]))
        log(f"crossover: {B} sponges x {blocks} blocks: pair {t[2]:.4f} ms, warp {t[32]:.4f} ms "
            f"({t[32] / t[2]:.3f})")
    out["crossover"] = rows
    log(f"card: {card}")
    log(json.dumps({"sponge_teams": out}))
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
    if argv == ["--sponge-teams"]:
        return sponge_team_times(dev, card)
    if argv:
        raise SystemExit(f"chip_smoke: unknown arguments {argv} (only --fold-times, "
                         "--sponge-teams)")

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
    per_call, per_fleet = phase_glue_shapes(params, fleet, kernel_rows)
    phase_place_preimages(params, fleet, kernel_rows, per_call, per_fleet)
    phase_sample_short(dev, kernel_rows, per_fleet)
    metrics.update(phase_wide(params, dev, kernel_rows))

    # -- S. the "spec" assembly ---------------------------------------------
    spec_metrics, spec_launches = drive_spec_path(params, fleet, metrics, dev)
    metrics.update(spec_metrics)
    phase_assemble_shapes(params, fleet, kernel_rows)

    # -- L. lifecycle ---------------------------------------------------------
    life_metrics, life_launches = drive_lifecycle(params, fleet, dev)
    metrics.update(life_metrics)
    check_lifecycle_cuda_vs_cpu(params, dev)

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

    # -- W. windowed verify, derive_alphas_grouped, segments, CLI -------------
    fleet = list(fleet)  # drive_aux frees it once derive_alphas_grouped has run
    aux_metrics, aux_launches = drive_aux(params, fleet, dev)
    metrics.update(aux_metrics)

    # -- D. parallel/ on a one-rank NCCL world (and on every card, if more) ---
    torch.cuda.empty_cache()
    d_metrics, d_launches, step_launches = drive_sharded(params, dev)
    metrics.update(d_metrics)
    for name in STEP_KERNELS:
        require(step_launches.get(name, 0) > 0, f"kernel {name} never launched by the step")

    # -- 5. the paths went through every kernel --------------------------------
    require(sorted(r["name"] for r in kernel_rows) == sorted(ALL_KERNELS),
            "kernel table must list every kernel of the paths")
    paths = (("main", launches, MAIN_PATH_KERNELS), ("spec", spec_launches, SPEC_PATH_KERNELS),
             ("lifecycle", life_launches, LIFECYCLE_KERNELS),
             ("object_api", obj_launches, OBJECT_API_KERNELS),
             ("aux", aux_launches, AUX_KERNELS), ("sharded", d_launches, SHARDED_KERNELS))
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
