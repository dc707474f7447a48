"""The wide cell (``verify.s256n1024.short``: configuration
``fusion256-n1024-g32``, traffic ``short_check2``, driver ``verify_wide``)
on the CPU at a tiny size, and the two counts its driver adds to the work
of a call, held against the reference's own preimages."""
import json

import numpy as np
import torch

from portbench import core, roofline
from portbench.reference import fusion_ref as ref

from harness_util import ROOT, run_cpu

WIDE = "verify.s256n1024.short"
TINY = ({"secpar": 128, "degree": 64, "rank": 195, "groups": 3, "signers": 8},
        {"tamper_share": 0.34})


def wide_cell() -> core.Cell:
    cell = core.Cell(core.manifest(ROOT), WIDE)
    cell.config.update(TINY[0])
    cell.traffic.update(TINY[1])
    return cell


def test_wide_cell_files():
    """The cell's configuration, traffic and metrics as BENCHMARK.json names
    them: 32 groups of 1,024, two reference groups a batch, the five wide
    metrics listed for this cell alone."""
    cell = core.Cell(core.manifest(ROOT), WIDE)
    c, t = cell.config, cell.traffic
    assert (c["driver"], c["secpar"], c["signers"], c["groups"], c["reduced"]) == (
        "verify_wide", 256, 1024, 32, [])
    assert t["check_groups"] == 2 and t["message_length"] == {"fixed": 59}
    names = {m["name"] for m in cell.per_layer}
    wide = {"agg_sponge_ms.wide", "agg_fold_ms.wide", "lattice_target_ms.wide",
            "agg_chain_share.wide", "lattice_target_roofline.wide"}
    assert wide <= names and "verify_roofline" in names
    short = core.Cell(core.manifest(ROOT), "verify.s256n4.short")
    assert not wide & {m["name"] for m in short.per_layer}


def test_wide_cell_runs_on_the_cpu():
    """A tiny run (3 groups of 8 at secpar 128) and a traced one: correct,
    the end-to-end metrics read, the device metrics left out."""
    plain = run_cpu(wide_cell())
    assert plain["correct"] and set(plain["metrics"]) == {"verifies_per_s", "setup_s"}
    traced = run_cpu(wide_cell(), trace=True)
    assert traced["correct"] and not set(traced["metrics"]) & {
        "agg_sponge_ms.wide", "agg_chain_share.wide", "lattice_target_roofline.wide"}
    assert json.dumps(traced)


def test_work_counts_match_the_reference_preimages():
    """``agg_lengths`` equals the length of the preimage the reference
    hashes for each group (``fusion_ref.alphas``' body), and the work count
    adds chain_perms and target_bytes to ``roofline.verify_work``'s."""
    cell = wide_cell()
    rp = ref.setup(128, 42)
    wide = cell.driver_module()
    G, N, d = 3, 20, rp.degree
    seeds = [[900 + 2 * (g * N + k) for k in range(N)] for g in range(G)]
    texts = [[f"m{g}.{k}" * (1 + k % 5) for k in range(N)] for g in range(G)]
    vks, msgs, _ = ref.make_groups(rp, seeds, texts)
    flat = [m for group in msgs for m in group]
    strs = [ref.vk_str(rp, v) for v in vks.reshape(G * N, 2, d)]
    pre = [ref.prehash(rp, m) for m in flat]
    c_hat = ref.challenges(rp, strs, pre)
    lens = []
    for g in range(G):
        body = "[" + ", ".join(f"({v}, {i}, {ref.challenge_str(rp, c)})" for v, i, c in
                               zip(strs[g * N:(g + 1) * N], pre[g * N:(g + 1) * N],
                                   c_hat[g * N:(g + 1) * N])) + "]"
        lens.append(len(rp.ag_dst + b"," + body.encode()))
    np.testing.assert_array_equal(wide.agg_lengths(rp, vks, flat), lens)
    block = ref.agg_block_len(rp)
    assert wide.chain_perms(rp, vks, flat) == (max(lens) // 136 + 1) + (-(-N * block // 136) - 1)
    assert wide.target_bytes(rp, G, N) == G * (16 * N * d + 4 * d + 8 * rp.rank + 3)

    driver = wide.Driver(cell.config, cell.traffic, 5, torch.device("cpu"), None)
    driver.rp = rp
    driver.batches = [type("B", (), {"vks": torch.as_tensor(vks), "msgs": flat, "work": None})()]
    work = driver.work(0)
    base = roofline.verify_work(rp, vks, flat)
    assert {k: work[k] for k in base} == base
    assert work["chain_perms"] == wide.chain_perms(rp, vks, flat) > 0
