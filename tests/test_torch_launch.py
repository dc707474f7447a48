"""The local-world launcher (fusion_cryptography_tpu_torch/parallel/_launch.py)
on the CPU: a world returns each rank's result in rank order, a failing rank
fails the call with its log instead of hanging it, and a world that outruns
its timeout is killed whole."""
import time
from pathlib import Path

import pytest

from fusion_cryptography_tpu_torch.parallel import _launch

RANKS = str(Path(__file__).with_name("torch_parallel_ranks.py"))


def test_results_in_rank_order():
    assert _launch.launch(3, "torch.distributed:get_rank", device="cpu", timeout_s=120) == [0, 1, 2]


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match=r"--- rank 1 \(exit 1\)(.|\n)*fails on purpose"):
        _launch.launch(2, RANKS + ":fail_on", 1, device="cpu", timeout_s=120)


def test_a_hanging_world_is_killed_at_its_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="world of 2 did not finish within 10"):
        _launch.launch(2, RANKS + ":hang_on", 1, device="cpu", timeout_s=10)
    assert time.monotonic() - t0 < 60
