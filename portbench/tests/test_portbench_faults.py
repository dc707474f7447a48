"""A run with the timed path broken underneath must come out not correct,
for each fault its cell can have: a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced, and,
across cards, the exchange left out.  The runs are on the CPU at a tiny
size, with the harness's look for a card skipped; the sound run of each
cell comes out correct."""
import pytest
import torch

from harness_util import FOUR_CARD, copy_bench, run_cpu, run_world_cpu, tiny_cell


def _verify_faults(dp, fault, monkeypatch):
    real = dp.verify_batch_device
    memo = []

    def broken(params, vks, msgs, aggs, **kw):
        if fault == "stale" and memo:
            return memo[0]
        if fault == "half":
            G, N, h = vks.shape[0], vks.shape[1], vks.shape[0] // 2
            out = real(params, vks[:h], msgs[:h * N], aggs[:h], **kw)
            return tuple(torch.cat([o, torch.ones(G - h, dtype=torch.bool)]) for o in out)
        out = real(params, vks, msgs, aggs, **kw)
        if fault == "altered":
            eq = out[0].clone()
            eq[0] = ~eq[0]
            out = (eq,) + tuple(out[1:])
        memo.append(out)
        return out

    monkeypatch.setattr(dp, "verify_batch_device", broken)


@pytest.mark.parametrize("cell", ["verify.s256n4.short", "verify.s256n4.nist"])
@pytest.mark.parametrize("fault", [None, "stale", "half", "altered"])
def test_verify_cell(cell, fault, monkeypatch):
    from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp

    if fault:
        _verify_faults(dp, fault, monkeypatch)
    line = run_cpu(tiny_cell(cell))
    assert line["correct"] is (fault is None), line["checks"]
    assert line["metrics"]["verifies_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [None, "stale", "half", "altered"])
def test_sign_cell(fault, monkeypatch):
    from fusion_cryptography_tpu_torch.scheme import lifecycle as lc

    real = lc.sign
    memo = []

    def broken(params, keys, messages):
        if fault == "stale" and memo:
            return memo[0]
        out = real(params, keys, messages)
        if fault == "half":
            out.sig[out.sig.shape[0] // 2:] = 0
        if fault == "altered":
            out.sig[0, 0, 0] += 1
        memo.append(out)
        return out

    if fault:
        monkeypatch.setattr(lc, "sign", broken)
    line = run_cpu(tiny_cell("sign.s128.b1024"), seconds=1.0)
    assert line["correct"] is (fault is None), line["checks"]
    assert line["metrics"]["signatures_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [None, "exchange", "stale", "half", "altered"])
def test_four_card_cell(fault, tmp_path, monkeypatch):
    """A gloo world of four CPU ranks; the fault is planted in each rank at
    start-up (``fault_site/sitecustomize.py``)."""
    site = str(__import__("pathlib").Path(__file__).resolve().parent / "fault_site")
    if fault:
        monkeypatch.setenv("PORTBENCH_FAULT", fault)
        monkeypatch.setenv("PYTHONPATH", site)
    bench = copy_bench(tmp_path, "verify.s256n4x4.short", [FOUR_CARD])
    line = run_world_cpu(bench, "verify.s256n4x4.short")
    assert line["correct"] is (fault is None), line["checks"]
    assert line["device"]["count"] == 4
