"""The readers of the program's own spans and counters (``fct.*``,
``pack.*``) on a CPU trace of each cell at a tiny size: each
``program_span`` and ``program_counter`` reader returns a number, each
``device_trace`` reader None, and no span the program opens has the name of
a range the benchmark opens."""
import pytest
import torch

from portbench import core, tracing

from harness_util import tiny_cell

NEW = {
    "verify.s256n4.short": ("pack_encode_ms.verify", "pack_scatter_ms.verify",
                            "pack_upload_ms.verify", "pack_pad_share.verify", "launches.verify"),
    "sign.s128.b1024": ("keygen_host_ms.sign", "sign_host_ms.sign", "product_device_ms.sign",
                        "host_syncs.sign", "launches.sign"),
}
PROGRAM = {
    "verify.s256n4.short": {"fct.verify", "fct.pack", "fct.pack.encode", "fct.pack.scatter",
                            "fct.pack.upload", "fct.prehash", "fct.signer", "fct.group",
                            "fct.lattice"},
    "sign.s128.b1024": {"fct.keygen", "fct.sample", "fct.sign", "fct.pack", "fct.pack.encode",
                        "fct.pack.scatter", "fct.pack.upload", "fct.prehash", "fct.signer",
                        "fct.sign.product"},
}


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_on_a_cpu_trace(name):
    from fusion_cryptography_tpu_torch.utils import profiling

    cell = tiny_cell(name)
    driver = cell.driver_module().Driver(cell.config, cell.traffic, 2**35 + 7,
                                         torch.device("cpu"), None)
    driver.setup()
    profiling.reset_counters()
    trace = tracing.capture(driver, 0, 0.0, 1, "cpu", lambda mine: mine)
    assert trace.calls == 1
    metrics = {m["name"]: m for m in cell.per_layer}
    assert set(NEW[name]) <= set(metrics)
    for metric in NEW[name]:
        value = cell.reader("metrics", metric).read(trace)
        if metrics[metric]["source"] == "device_trace":
            assert value is None, metric
        else:
            assert isinstance(value, float) and value >= 0, metric
    if name.startswith("verify"):
        # 59-B messages: 62-B preimages in 16 words
        assert cell.reader("metrics", "pack_pad_share.verify").read(trace) == 3.125

    ranges = {e["name"] for e in trace.ranges}
    benchmark = {"call", "readback"} | {n for _, _, n in driver.wraps()}
    assert ranges - benchmark == PROGRAM[name]
    assert not any(n.startswith("fct.") for n in benchmark)


def test_readers_leave_out_a_program_without_spans():
    """A card's trace of a program that opens no range of its own (an older
    one): every new reader returns None."""
    events = [{"cat": "user_annotation", "name": "call", "ts": 0.0, "dur": 10.0},
              {"cat": "user_annotation", "name": "host.pack", "ts": 1.0, "dur": 5.0},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6.5, "dur": 0.5,
               "args": {"correlation": 1}},
              {"cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 7.5, "dur": 1.0,
               "args": {"correlation": 2}},
              {"cat": "kernel", "name": "k", "ts": 7.0, "dur": 1.0, "args": {"correlation": 1}}]
    trace = tracing.Trace(events, 1, "cuda", list)
    assert trace.on_device
    for name, metrics in NEW.items():
        cell = core.Cell(core.manifest(core.HERE.parent), name)
        for metric in metrics:
            if metric != "pack_pad_share.verify":
                assert cell.reader("metrics", metric).read(trace) is None, metric


def test_sign_readers_count_by_hand():
    """A card's trace of two calls, built by hand: launches and syncs are
    counted inside ``fct.keygen`` and ``fct.sign`` only, keygen's host time
    leaves out its ``fct.sample``, and the product's device time is that of
    what was launched inside ``fct.sign.product``."""
    def rng(name, ts, dur):
        return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def rt(name, ts, corr):
        return {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 0.2,
                "args": {"correlation": corr}}

    events = [rng("call", 0.0, 25.0), rng("call", 30.0, 10.0),
              rng("fct.keygen", 0.0, 10.0), rng("fct.sample", 1.0, 3.0),
              rng("fct.sign", 12.0, 8.0), rng("fct.sign.product", 15.0, 3.0),
              rng("fct.sample", 31.0, 2.0),  # outside every fct.keygen
              rt("cudaLaunchKernel", 5.0, 1), rt("cudaLaunchKernel", 16.0, 2),
              rt("cudaLaunchKernel", 11.0, 3), rt("cuLaunchKernel", 19.0, 4),
              rt("cudaStreamSynchronize", 6.0, 5), rt("cudaDeviceSynchronize", 21.0, 6),
              {"cat": "kernel", "name": "a", "ts": 17.0, "dur": 3.0, "args": {"correlation": 2}},
              {"cat": "kernel", "name": "b", "ts": 20.0, "dur": 1.0, "args": {"correlation": 4}}]
    trace = tracing.Trace(events, 2, "cuda", list)
    cell = core.Cell(core.manifest(core.HERE.parent), "sign.s128.b1024")
    got = {m: cell.reader("metrics", m).read(trace) for m in NEW["sign.s128.b1024"]}
    assert got == {"keygen_host_ms.sign": 7.0 / 1e3 / 2, "sign_host_ms.sign": 8.0 / 1e3 / 2,
                   "product_device_ms.sign": 3.0 / 1e3 / 2, "host_syncs.sign": 0.5,
                   "launches.sign": 1.5}
