"""The port's utilities vs the JAX package's: sample_short_matrix_coeffs
(integer seed and seed=None), get_logger's level from FUSION_TPU_LOG, and
trace writing a Chrome trace on the CPU."""
import json
import logging
import random

import numpy as np
import pytest
import torch

from fusion_cryptography_tpu.hashing import sampler as jsampler
from fusion_cryptography_tpu_torch.hashing import sampler as tsampler
from fusion_cryptography_tpu_torch.utils import get_logger, trace


@pytest.mark.parametrize("seed", [7, None])
@pytest.mark.parametrize("args", [(2147465729, 64, 52, 64, 3, 2), (2147465729, 256, 1, 60, 2, 1)])
def test_sample_short_matrix_coeffs_matches_jax(seed, args):
    random.seed(1234)
    want = jsampler.sample_short_matrix_coeffs(*args, seed)
    after_jax = random.random()
    random.seed(1234)
    got = tsampler.sample_short_matrix_coeffs(*args, seed)
    assert random.random() == after_jax  # the same draws from the global stream
    assert got.dtype == np.int32 and got.shape == args[4:6] + (args[1],)
    np.testing.assert_array_equal(got, want)
    if seed is not None:
        assert (got == got[0, 0]).all()  # the per-entry reseed quirk


def test_get_logger_level_from_env(monkeypatch):
    monkeypatch.setenv("FUSION_TPU_LOG", "debug")
    name = "fusion_tpu_torch_test_logger"
    logger = get_logger(name)
    try:
        assert logger.level == logging.DEBUG and len(logger.handlers) == 1
        assert get_logger(name) is logger and len(logger.handlers) == 1
    finally:
        logger.handlers.clear()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "tr")):
        (torch.arange(64) * 3).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
