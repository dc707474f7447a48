"""The port's two walkthroughs on the CPU: ``demo`` (the JAX package's
examples/demo.py) with ``--device cpu``, and ``pod_scale`` (its
examples/pod_scale.py, configs 4 and 5) in a gloo world of 2 at a few keys
and groups, and its rank-local fleet against the global one."""
from pathlib import Path

import numpy as np

from fusion_cryptography_tpu_torch import demo, pod_scale
from fusion_cryptography_tpu_torch.params import fusion_setup
from fusion_cryptography_tpu_torch.parallel import _launch
from fusion_cryptography_tpu_torch.scheme import device_pipeline as tdp
from fusion_cryptography_tpu_torch.scheme.device_setup import build_fleet

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))


def test_demo_on_cpu(capsys):
    assert demo.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("verifies: True ''") == 2, out


def test_pod_scale_in_a_gloo_world_of_two():
    argv = ["--device", "cpu", "--secpar", "128", "--keys", "8", "--groups", "4",
            "--efficiency"]
    ranks = _launch.launch(2, "fusion_cryptography_tpu_torch.pod_scale:run", argv,
                           device="cpu", timeout_s=240)
    for m in ranks:
        assert m["ranks"] == 2 and m["mesh"] == {"dp": 1, "tp": 2}
        assert m["lifecycle"]["keys"] == 8 and m["lifecycle"]["verified"]
        assert m["verify"]["groups"] == 4 and m["verify"]["signers"] == pod_scale.SIGNERS
        assert m["verify"]["verified"]
        assert "not a card's scaling" in m["efficiency"]["note"]
        assert "not a card's scaling" in m["efficiency_verify"]["note"]
    # the timings are the slowest rank's, so every rank reports the same
    assert ranks[0]["lifecycle"]["seconds"] == ranks[1]["lifecycle"]["seconds"]
    assert ranks[0]["verify"]["seconds"] == ranks[1]["verify"]["seconds"]
    assert ranks[0]["efficiency"]["value"] > 0 and ranks[0]["efficiency_verify"]["value"] > 0


def test_local_fleets_are_the_global_fleet_in_a_gloo_world_of_two():
    """Each rank builds only its own groups (in chunks of 2 and 1 groups, so
    a rank's share takes two build_fleet calls), and together they are
    build_fleet's global fleet; sharded_verify_local on them gives the
    one-device verdicts, the tampered group rejected alone."""
    G, bad = 6, 4
    params = fusion_setup(128, 42)
    vks, msgs, aggs = build_fleet(params, G, pod_scale.SIGNERS, seed0=1, device="cpu")
    fleet_aggs = aggs.numpy().copy()
    aggs[bad, 0, 0] = (aggs[bad, 0, 0] + 1) % params.modulus
    want = [x.numpy() for x in tdp.verify_batch_device(params, vks, msgs, aggs)]
    ranks = _launch.launch(2, RANKS + ":local_fleet_case", 128, 42, G, bad, 2, device="cpu",
                           timeout_s=240)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in ranks]), vks.numpy())
    assert sum((r[1] for r in ranks), []) == msgs
    np.testing.assert_array_equal(np.concatenate([r[2] for r in ranks]), fleet_aggs)
    for r in ranks:
        for got, one in zip(r[3], want):
            np.testing.assert_array_equal(got, one)
    assert not want[0][bad] and want[0][np.arange(G) != bad].all()


def test_initialize_needs_a_world_and_never_falls_back(monkeypatch):
    """With nothing set, initialize() is a no-op; a torchrun world of two
    on a machine without a card raises before joining (no silent switch
    to the CPU or gloo); the backend follows the device."""
    import pytest
    import torch
    import torch.distributed as dist

    from fusion_cryptography_tpu_torch.parallel import distributed

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is None and not dist.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is None and not dist.is_initialized()
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    assert distributed.backend_for(torch.device("cuda", 0)) == "nccl"
    if not torch.cuda.is_available():
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "0")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize()
        assert not dist.is_initialized()
