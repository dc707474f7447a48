#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path through its public entry points at the full
secpar=256 configuration — ``build_fleet`` of G=8192 groups of N=4 signers
(32,768 one-time keys, aggregates int32[8192, 83, 256]) and grouped
``verify_batch_device`` — after building every CUDA kernel of that path from
``fusion_cryptography_tpu_torch/csrc`` and holding each one against its plain
torch version at the main path's shapes (exact equality: all integer).

Phases (each fails loudly; any failure exits non-zero):
  1. card, versions, kernel build
  2. kernels vs plain versions (and the sponge vs hashlib), with timings
  3. fleet build, keys/s
  4. verify: one warm call, per-call latency (median of 5 synced calls),
     5 calls with one final sync;
     all verdicts true, and a tampered aggregate fails in exactly its group
  5. derive_coeffs_device on CUDA equals the same call on CPU tensors
  6. every kernel of the path was launched during phases 3-4

The last two lines of stdout are the kernel table {"kernels": [...]} and
{"ok": true, "device": {...}}; the card's name and power limit come just
before them.  Run from the repository root: ``python3 chip_smoke.py``.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from statistics import median

import numpy as np
import torch

SEED = 42
SECPAR, N_GROUPS, N_SIGNERS = 256, 8192, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
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
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.ops.intt_norm_weight import (
        intt_norm_weight, intt_norm_weight_plain)
    from fusion_cryptography_tpu_torch.params import fusion_setup

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
    log(f"sponge: B={B}, lengths 0..42787 B: absorb and squeeze (8423, 15872 B) "
        "equal the plain versions; 64 lanes equal hashlib shake_256/sha3_256")
    t_abs = cuda_ms(lambda: ks.absorb(padded, nblk), 3)
    t_abs_p = cuda_ms(lambda: keccak.absorb_padded(padded, nblk), 1)
    nw = -(-15872 // 4)
    t_sq = cuda_ms(lambda: ks.squeeze(st_k, nw), 5)
    t_sq_p = cuda_ms(lambda: keccak.shake256_squeeze_words(st_p, nw), 1)
    log(f"  keccak_absorb  {t_abs:.3f} ms  (plain {t_abs_p:.3f} ms)")
    log(f"  keccak_squeeze {t_sq:.3f} ms  (plain {t_sq_p:.3f} ms)  [{nw} words]")
    kernel_rows += [
        dict(name="keccak_absorb", route="cuda",
             source="fusion_cryptography_tpu_torch/csrc/keccak_sponge.cu",
             replaces="fusion_cryptography_tpu/ops/keccak_pallas.py:81",
             max_abs_err=err_a, ms=t_abs, plain_ms=t_abs_p),
        dict(name="keccak_squeeze", route="cuda",
             source="fusion_cryptography_tpu_torch/csrc/keccak_sponge.cu",
             replaces="fusion_cryptography_tpu/ops/keccak_pallas.py:123",
             max_abs_err=max(errs_s), ms=t_sq, plain_ms=t_sq_p),
    ]
    # -- INTT + norm/weight at the lattice's rows (rank 83 x 4096 groups) ---
    plan = fusion_setup(SECPAR, SEED).plan
    M = 83 * 4096
    x = torch.randint(0, Q, (M, plan.degree), dtype=torch.int64, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    x[::97] = 0  # all-zero rows: weight 0, norm 0
    nk, wk = intt_norm_weight(plan, x)
    np_, wp = intt_norm_weight_plain(plan, x)
    err_i = max(max_abs_err(nk, np_), max_abs_err(wk, wp))
    require(err_i == 0, "intt_norm_weight != plain version")
    require(int(wk[0]) == 0 and int(nk[0]) == 0, "zero row must give norm 0, weight 0")
    t_i = cuda_ms(lambda: intt_norm_weight(plan, x), 10)
    t_i_p = cuda_ms(lambda: intt_norm_weight_plain(plan, x), 2)
    log(f"intt_norm_weight: [{M}, {plan.degree}] equal the plain version; "
        f"{t_i:.3f} ms (plain {t_i_p:.3f} ms)")
    kernel_rows.append(
        dict(name="intt_norm_weight", route="cuda",
             source="fusion_cryptography_tpu_torch/csrc/intt_norm_weight.cu",
             replaces="fusion_cryptography_tpu/ops/ntt_mxu_pallas.py:174",
             max_abs_err=err_i, ms=t_i, plain_ms=t_i_p))
    del x, padded, words, by, st_k, st_p
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.ops.field import Q
    from fusion_cryptography_tpu_torch.params import fusion_setup
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
    from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

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

    # -- 2. kernels vs plain ------------------------------------------------
    kernel_rows: list = []
    phase_kernels(dev, kernel_rows)

    # -- 3./4. main path ----------------------------------------------------
    G, N = N_GROUPS, N_SIGNERS
    params = fusion_setup(SECPAR, SEED)
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
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"verify: warm call {t_warm:.3f} s; per-call latency median {median(lat):.4f} s "
        f"({', '.join(f'{x:.4f}' for x in lat)}); {reps} calls, one sync: "
        f"{t_tp:.3f} s -> {vps:,.0f} verifies/s; peak device memory {peak_gb:.2f} GB")
    log(f"kernel launches during fleet build + verify: {launches}")

    bad_g = G // 3
    bad = aggs.clone()
    bad[bad_g, 0, 0] = (bad[bad_g, 0, 0] + 1) % Q
    eq_b, _, _ = dp.verify_batch_device(params, vks, msgs, bad)
    rejected = torch.nonzero(~eq_b).flatten().tolist()
    require(rejected == [bad_g], f"tampered group {bad_g}: rejected {rejected}")
    log(f"tampered aggregate: rejected exactly group {bad_g}")
    del bad

    # -- 5. CUDA vs CPU on the first 16 groups -------------------------------
    g16 = 16
    out_c = dp.derive_coeffs_device(params, vks[:g16], msgs[: g16 * N], aggs[:g16])
    out_h = dp.derive_coeffs_device(params, vks[:g16].cpu(), msgs[: g16 * N], aggs[:g16].cpu())
    for name, a, b in zip(("eq", "norm_ok", "weight_ok", "cc", "alphas"), out_c, out_h):
        require(torch.equal(a.cpu(), b), f"derive_coeffs_device {name}: CUDA != CPU")
    log("derive_coeffs_device: CUDA run equals the CPU run (plain versions) "
        f"on {g16} groups (eq, norms, weights, challenge and alpha coefficients)")

    # -- 6. the main path went through every kernel ---------------------------
    for row in kernel_rows:
        row["launches"] = int(launches.get(row["name"], 0))
        require(row["launches"] > 0, f"kernel {row['name']} never launched on the main path")

    metrics = dict(
        card=card, secpar=SECPAR, groups=G, signers=N, group_chunk=dp.DEFAULT_GROUP_CHUNK,
        fleet_keys_per_s=G * N / t_fleet, fleet_first_s=t_fleet_cold, fleet_s=t_fleet,
        verify_warm_s=t_warm, verify_latency_s=median(lat), verify_latency_all_s=lat,
        verifies_per_s=vps, verify_reps=reps, verify_reps_s=t_tp, peak_mem_gb=peak_gb,
    )
    log(json.dumps({"metrics": metrics}))
    log(f"card: {card}")
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
