"""The four-card cell's per-layer metrics (``verify.s256n4x4.short``): the
cell picks up exactly its six, a traced gloo world of four CPU ranks at the
tiny size leaves out the device readers, and on a card's trace built by
hand the two new readers count what their docstrings say, and read None for
a program that opens no ``fct.shard.gather`` span."""
import time

import pytest

from portbench import core, tracing, world

from harness_util import ROOT, copy_bench

CELL = "verify.s256n4x4.short"
METRICS = {"host_pack_ms.verify", "launches.verify", "collective_ms.dp4",
           "device_idle_share.dp4", "gather_device_ms.dp4", "pack_overlap_share.dp4"}


def test_cell_metrics():
    cell = core.Cell(core.manifest(ROOT), CELL)
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert [m["name"] for m in cell.end_to_end] == ["verifies_per_s", "setup_s"]
    assert cell.chips == 4 and cell.config["driver"] == "sharded_verify"
    assert all(m["moves"] == "verifies_per_s" for m in cell.per_layer)


def test_traced_world_on_the_cpu(tmp_path):
    bench = copy_bench(tmp_path, CELL)
    cell = core.Cell(core.manifest(bench.parent), CELL, bench)
    t = time.time()
    parts = world.launch(4, {
        "workload": CELL, "seed": 2**35 + 19, "seconds": 0.5, "trace": True, "device": "cpu",
        "t_start": t, "bench_dir": str(bench), "timeout_s": 240.0}, 240.0)
    line = core.result(cell, parts, t, "cpu", "cpu", True)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["count"] == 4
    metrics = line["metrics"]
    # device readers read nothing on the CPU; the benchmark's own range does
    for name in ("gather_device_ms.dp4", "collective_ms.dp4", "launches.verify",
                 "device_idle_share.dp4"):
        assert name not in metrics, name
    overlap = metrics.get("pack_overlap_share.dp4")
    assert overlap is None or 0.0 <= overlap["value"] <= 100.0
    assert metrics["host_pack_ms.verify"]["value"] > 0


def _range(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(ts, corr):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 0.2,
            "args": {"correlation": corr}}


def _kernel(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def _reader(name):
    return core.Cell(core.manifest(ROOT), CELL).reader("metrics", name)


@pytest.mark.parametrize("spans", [True, False])
def test_readers_count_by_hand(spans):
    """Two calls.  Device busy [4, 10], [12, 16] and [17, 19] in the first,
    [24, 27], [28, 33] and [34, 38] in the second; ``fct.pack`` at [2, 6]
    and [11, 14] (4 of 7 us busy) and at [21, 25] (1 of 4);
    ``fct.shard.gather`` at [16, 19.5] and [33, 38], launching an NCCL
    kernel of 2 us and one of 3 us, and the second also a copy of 1 us.
    Without the program's spans (an older program) both readers read
    None."""
    events = [_range("call", 0.0, 20.0), _range("call", 20.0, 20.0),
              _launch(3.0, 1), _kernel("signer", 4.0, 6.0, 1),
              _launch(11.0, 2), _kernel("lattice", 12.0, 4.0, 2),
              _launch(16.5, 3), _kernel("ncclDevKernel_AllGather_RING_LL", 17.0, 2.0, 3),
              _launch(23.0, 4), _kernel("signer", 24.0, 3.0, 4),
              _launch(27.5, 5), _kernel("lattice", 28.0, 5.0, 5),
              _launch(33.5, 6), _kernel("ncclDevKernel_AllGather_RING_LL", 34.0, 3.0, 6),
              _launch(33.8, 7), _kernel("copy", 37.0, 1.0, 7)]
    if spans:
        events += [_range("fct.pack", 2.0, 4.0), _range("fct.pack", 11.0, 3.0),
                   _range("fct.pack", 21.0, 4.0),
                   _range("fct.shard.gather", 16.0, 3.5), _range("fct.shard.gather", 33.0, 5.0)]
    trace = tracing.Trace(events, 2, "cuda", list)
    overlap = _reader("pack_overlap_share.dp4").read(trace)
    gather = _reader("gather_device_ms.dp4").read(trace)
    assert _reader("collective_ms.dp4").read(trace) == pytest.approx(5.0 / 1e3 / 2)
    if not spans:
        assert overlap is None and gather is None
        return
    assert overlap == pytest.approx(100.0 * (2.0 + 2.0 + 1.0) / 11.0)
    assert gather == pytest.approx((2.0 + 3.0 + 1.0) / 1e3 / 2)


def test_readers_on_a_cpu_trace_read_none():
    events = [_range("call", 0.0, 10.0), _range("fct.pack", 1.0, 2.0),
              _range("fct.shard.gather", 5.0, 1.0)]
    trace = tracing.Trace(events, 1, "cpu", list)
    for name in ("pack_overlap_share.dp4", "gather_device_ms.dp4", "collective_ms.dp4"):
        assert _reader(name).read(trace) is None, name
