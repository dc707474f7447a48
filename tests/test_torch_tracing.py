"""The port's spans and counters (``utils/profiling.py``): nothing opens or
counts while no profiler records; under a profiler the entry points give
the documented ``fct.*`` spans, nested as documented, one per chunk or
window, and the packing counters count exact bytes; the answers are the
same bits with tracing on and off.

The one test marked ``cuda`` needs a card and skips without one; it imports
no JAX, so on the GPU machine it runs with ``python -m pytest --noconftest
-m cuda tests/test_torch_tracing.py``."""
import contextlib
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fusion_cryptography_tpu_torch import fusion_setup
from fusion_cryptography_tpu_torch.scheme import device_pipeline as dp
from fusion_cryptography_tpu_torch.scheme import lifecycle as lc
from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet
from fusion_cryptography_tpu_torch.utils import profiling

CPU = torch.device("cpu")
GROUP_SPANS = {"fct.group.fold", "fct.group.sponge", "fct.group.decode"}
VERIFY_SPANS = {"fct.verify", "fct.pack", "fct.pack.encode", "fct.pack.scatter",
                "fct.pack.upload", "fct.prehash", "fct.signer", "fct.group", "fct.lattice",
                "fct.lattice.target", *GROUP_SPANS}
MESSAGES = ["", "a", "é" * 40, "x" * 31, "message ünïcode", "y" * 64]


@pytest.fixture(scope="module")
def params():
    return fusion_setup(128, 5)


@pytest.fixture(scope="module")
def fleet(params):
    """Five groups of two on the CPU, the last one's aggregate tampered."""
    vks, msgs, aggs = build_fleet(params, 5, 2, seed0=3, messages=MESSAGES + ["z"] * 4,
                                  device=CPU)
    aggs = aggs.clone()
    aggs[4, 0, 0] += 1
    return vks, msgs, aggs


def _windowed(params, fleet):
    """Signer chunks of 2 groups (3 chunks), group windows of 4 (2 windows)."""
    return dp.verify_batch_device(params, *fleet, group_chunk=2, group_hash_chunk=4)


def _lifecycle(params):
    keys = lc.keygen(params, [11, 13, 15], device=CPU)
    return keys, lc.sign(params, keys, MESSAGES[:3])


def _spans(fn):
    """``fn()`` under a CPU profiler -> (its result, [(name, start, end)] of
    the ranges the program opened, in order of start).  The ranges are
    taken as ``utils.profiling`` opens them: the CPU profile of the plain
    stages holds too many operations to read back quickly."""
    opened = []
    real = profiling.record_function

    @contextlib.contextmanager
    def recorded(name):
        start = time.perf_counter_ns()
        with real(name):
            yield
        opened.append((start, time.perf_counter_ns(), name))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profiling, "record_function", recorded)
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
    return out, [(n, a, b) for a, b, n in sorted(opened)]


@pytest.fixture(scope="module")
def traced_verify(params, fleet):
    return _spans(lambda: _windowed(params, fleet))


@pytest.fixture(scope="module")
def traced_lifecycle(params):
    return _spans(lambda: _lifecycle(params))


def _inside(inner, outers) -> bool:
    return any(a <= inner[1] and inner[2] <= b for _, a, b in outers)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


@pytest.mark.parametrize("entry", ["verify_batch_device", "keygen", "sign"])
def test_no_span_or_count_without_a_profiler(params, fleet, entry, monkeypatch):
    keys = lc.keygen(params, [21, 23], device=CPU) if entry == "sign" else None

    def refuse(name):
        raise AssertionError(f"span {name!r} opened with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    profiling.reset_counters()
    if entry == "verify_batch_device":
        assert _windowed(params, fleet)[0].tolist() == [True] * 4 + [False]
    elif entry == "keygen":
        assert len(lc.keygen(params, [21, 23], device=CPU)) == 2
    else:
        assert len(lc.sign(params, keys, ["p", "q"])) == 2
    assert profiling.counters() == {}


def test_verify_spans_one_per_chunk_and_window(traced_verify):
    out, spans = traced_verify
    assert out[0].tolist() == [True] * 4 + [False]
    assert {n for n, _, _ in spans} == VERIFY_SPANS
    (call,) = _named(spans, "fct.verify")
    assert all(_inside(s, [call]) for s in spans)
    packs = _named(spans, "fct.pack")
    for part in ("encode", "scatter", "upload"):
        each = _named(spans, f"fct.pack.{part}")
        assert len(each) == 3 and all(_inside(s, packs) for s in each)
    for name, n in (("fct.pack", 3), ("fct.prehash", 3), ("fct.signer", 3),
                    ("fct.lattice", 3), ("fct.group", 2), ("fct.lattice.target", 3),
                    *((g, 2) for g in GROUP_SPANS)):
        assert len(_named(spans, name)) == n, name
    for inner, outer in [(g, "fct.group") for g in GROUP_SPANS] + [
            ("fct.lattice.target", "fct.lattice")]:
        assert all(_inside(s, _named(spans, outer)) for s in _named(spans, inner)), inner


def test_group_counters_count_signers_and_preimage_words(params, fleet):
    """``group.signers`` adds N and ``group.agg_words`` the padded
    aggregation preimage's words once a group stage: two windows of the
    windowed call."""
    from fusion_cryptography_tpu_torch.interop import device_serial as ds

    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        _windowed(params, fleet)
    c = profiling.counters()
    profiling.reset_counters()
    assert c["group.signers"] == 2 * 2
    assert c["group.agg_words"] == 2 * ds.agg_fold_table(params, 2).widths[0]


def test_keygen_and_sign_spans(traced_lifecycle):
    _, spans = traced_lifecycle
    assert {n for n, _, _ in spans} == {
        "fct.keygen", "fct.sample", "fct.sign", "fct.pack", "fct.pack.encode",
        "fct.pack.scatter", "fct.pack.upload", "fct.prehash", "fct.signer", "fct.sign.product"}
    keygen, sign = _named(spans, "fct.keygen"), _named(spans, "fct.sign")
    assert len(keygen) == len(sign) == 1
    assert _inside(_named(spans, "fct.sample")[0], keygen)
    assert not _inside(sign[0], keygen) and not _inside(keygen[0], sign)
    for name in ("fct.pack", "fct.prehash", "fct.signer", "fct.sign.product"):
        (s,) = _named(spans, name)
        assert _inside(s, sign), name


def test_sampler_counts_host_seeds_under_a_profiler(params):
    """A keygen on the CPU counts ``sample.seeds_host``, two seeds a key,
    only while a profiler records."""
    profiling.reset_counters()
    lc.keygen(params, [11, 13, 15], device=CPU)
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        lc.keygen(params, [11, 13, 15], device=CPU)
    c = profiling.counters()
    profiling.reset_counters()
    assert c == {"sample.seeds_host": 6}


@pytest.mark.parametrize("messages", [MESSAGES, ["m" * 59] * 7], ids=["mixed", "59B"])
def test_pack_counters_count_exact_bytes(params, messages):
    prefix = bytes(params.sign_pre_hash_dst) + b","
    payload = sum(len(m.encode("utf-8")) for m in messages)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        mw, _, ml = dp._message_tensors(params, messages, CPU)
    rows, B = mw.shape
    assert B == len(messages) and rows % 34 == 0
    fallback = 0 if all(m.isascii() for m in messages) else B
    assert profiling.counters() == {"pack.payload_bytes": payload,
                                    "pack.shipped_bytes": 4 * (payload // 4 + 1),
                                    "pack.rows_direct": B - fallback,
                                    "pack.rows_fallback": fallback}
    assert int(ml.sum()) == payload + B * len(prefix)
    profiling.reset_counters()
    assert profiling.counters() == {}


@pytest.mark.parametrize("entry", ["verify", "lifecycle"])
def test_same_bits_with_tracing_on_and_off(params, fleet, entry, request):
    on, spans = request.getfixturevalue(f"traced_{entry}")
    if entry == "verify":
        off = _windowed(params, fleet)
    else:
        keys, sigs = _lifecycle(params)
        off, on = [keys.vk, keys.sk_hat, sigs.sig], [on[0].vk, on[0].sk_hat, on[1].sig]
    assert spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_profile_verify_reads_the_pack_spans(params):
    """``profile_verify.span_times`` reads each ``fct.pack`` span's host time
    from a trace, and no device time where nothing ran on a device."""
    from fusion_cryptography_tpu_torch import profile_verify as pv

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dp._message_tensors(params, MESSAGES, CPU)
        dp._message_tensors(params, MESSAGES[:2], CPU)
    stages, packing = pv.span_times(prof)
    assert stages == {k: 0.0 for k in pv.STAGES}
    assert len(packing) == 2 and all(t > 0 for t in packing)


def test_profile_verify_keeps_the_trace(params, tmp_path):
    """``span_times(prof, keep)`` reads the same spans from the Chrome export
    it leaves at ``keep`` (a profile exports once: ``profile_verify --out``
    keeps this one)."""
    from fusion_cryptography_tpu_torch import profile_verify as pv

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dp._message_tensors(params, MESSAGES, CPU)
    _, packing = pv.span_times(prof, tmp_path / "trace.json")
    assert len(packing) == 1 and packing[0] > 0
    assert "fct.pack.scatter" in (tmp_path / "trace.json").read_text()


@pytest.mark.cuda
def test_profiled_windowed_verify_makes_no_host_sync():
    """The windowed verify of ``test_torch_cuda_kernels`` waits for the device
    nowhere while a profiler records (spans on), and gives the same verdicts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from fusion_cryptography_tpu_torch import kernels

    kernels.library()
    dev = torch.device("cuda", 0)
    params = fusion_setup(128, 5)
    vks, msgs, aggs = build_fleet(params, 7, 2, seed0=21, device=dev)
    aggs[6, 0, 0] += 1
    want = dp.verify_batch_device(params, vks, msgs, aggs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = dp.verify_batch_device(params, vks, msgs, aggs, group_chunk=2,
                                         group_hash_chunk=4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].tolist() == [True] * 6 + [False]
    names = {e.name for e in prof.events()}
    assert VERIFY_SPANS <= names
    # profile_verify's rows of device time hold kernels and copies, not spans
    from fusion_cryptography_tpu_torch import profile_verify as pv

    _, rows, _ = pv.trace(lambda: dp.verify_batch_device(params, vks, msgs, aggs))
    assert rows and not any(name.startswith("fct.") for name, _, _ in rows)


@pytest.mark.cuda
def test_traced_wide_group_call_has_the_group_spans_and_counters():
    """A traced verify of 2 groups of 64 signers on the card (the split
    lattice check, agg_fold's prefix launch) opens ``fct.group.fold``,
    ``.sponge``, ``.decode`` inside ``fct.group`` and ``fct.lattice.target``
    inside ``fct.lattice``, each with device work launched in it, counts
    ``group.signers`` and ``group.agg_words`` without a host sync, counts
    its group sponge under a warp a sponge (``keccak.team.32``), and gives
    the untraced verdicts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from fusion_cryptography_tpu_torch import kernels
    from fusion_cryptography_tpu_torch.interop import device_serial as ds

    kernels.library()
    dev = torch.device("cuda", 0)
    params = fusion_setup(256, 5)
    vks, msgs, aggs = build_fleet(params, 2, 64, seed0=41, device=dev)
    aggs[1, 0, 0] += 1
    want = dp.verify_batch_device(params, vks, msgs, aggs)
    torch.cuda.synchronize()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = dp.verify_batch_device(params, vks, msgs, aggs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    c = profiling.counters()
    profiling.reset_counters()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].tolist() == [True, False]
    assert c["group.signers"] == 64
    assert c["group.agg_words"] == ds.agg_fold_table(params, 64).widths[0]
    # three absorbs and three squeezes; the group stage's two sponges take
    # a warp each
    assert sum(v for k, v in c.items() if k.startswith("keccak.team.")) == 6
    assert c["keccak.team.32"] >= 2
    names = {e.name for e in prof.events()}
    assert GROUP_SPANS | {"fct.lattice.target"} <= names
    from fusion_cryptography_tpu_torch import profile_verify as pv

    _, rows, _ = pv.trace(lambda: dp.verify_batch_device(params, vks, msgs, aggs))
    kernels_run = {pv.port_kernel(name) for name, _, _ in rows}
    assert {"agg_fold", "lattice_target", "keccak_absorb", "keccak_squeeze"} <= kernels_run


@pytest.mark.cuda
def test_traced_verify_of_8192_groups_counts_the_pair_team():
    """A traced verify of 8,192 groups of 4 on the card: its group sponge
    (8,192 sponges) counts under two threads a sponge, its prehash and
    challenge (32,768 sponges, and the 8-word digest) under one, and no
    launch under a warp a sponge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from fusion_cryptography_tpu_torch import kernels

    kernels.library()
    dev = torch.device("cuda", 0)
    params = fusion_setup(256, 5)
    fleet = build_fleet(params, 8192, 4, seed0=43, device=dev)
    dp.verify_batch_device(params, *fleet)
    torch.cuda.synchronize()
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        eq, _, _ = dp.verify_batch_device(params, *fleet)
        torch.cuda.synchronize()
    c = profiling.counters()
    profiling.reset_counters()
    assert bool(eq.all())
    assert {k: v for k, v in c.items() if k.startswith("keccak.team.")} == {
        "keccak.team.1": 4, "keccak.team.2": 2}


@pytest.mark.cuda
def test_card_keygen_counts_device_seeds():
    """A keygen on the card counts ``sample.seeds_device`` under a profiler
    (kernel ``sample_short``), and the host's count only for seeds the
    kernel cannot take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    params = fusion_setup(128, 5)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        lc.keygen(params, [11, 13, 15, 17], device=dev)
        lc.keygen(params, [2**64 - 1], device=dev)
        torch.cuda.synchronize()
    c = profiling.counters()
    profiling.reset_counters()
    assert c == {"sample.seeds_device": 8, "sample.seeds_host": 2}
