"""Without a card the benchmark measures nothing: it exits non-zero and
prints no result, also in a checkout that holds only BENCHMARK.json and
portbench/ (no program to measure)."""
import os
import subprocess
import sys

import pytest

from harness_util import ROOT, copy_bench


def run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = run(ROOT, "--workload", "verify.s256n4.short", "--seed", str(2**40 + 1),
            "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "nothing is measured on the CPU" in p.stderr


def test_bare_checkout_has_nothing_to_run(tmp_path):
    copy_bench(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = run(tmp_path, "--workload", "sign.s128.b1024", "--seed", "7", "--seconds", "1",
            "--trace", "0", env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # past the look for a card, the program itself is missing
    code = ("import sys, time, torch; sys.path.insert(0, '.'); from portbench import core; "
            "cell = core.Cell(core.manifest('.'), 'sign.s128.b1024'); "
            "core.run_body(cell, 7, 0.1, False, torch.device('cpu'), time.time())")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0 and "fusion_cryptography_tpu_torch" in p.stderr


@pytest.mark.cuda
def test_sign_cell_on_the_card(card):
    """On a card: one short run of the sign cell is correct and names the card."""
    import json

    p = run(ROOT, "--workload", "sign.s128.b1024", "--seed", str(2**41 + 9), "--seconds", "2",
            "--trace", "0")
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
