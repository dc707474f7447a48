"""The port's CLI (python -m fusion_cryptography_tpu_torch) on the CPU, against
the JAX package's: the lifecycle with its exit codes and printed lines,
files that each CLI reads from the other, and byte-identical files from the
same seeds and messages."""
import filecmp

import pytest

from fusion_cryptography_tpu.__main__ import main as jax_main
from fusion_cryptography_tpu_torch.__main__ import main as port_main

REASON_TARGET = "Target doesn't match image of aggregate signature."
FILES = ("params.fp", "sk1.fp", "vk1.fp", "sk2.fp", "vk2.fp", "s1.fp", "s2.fp", "agg.fp")


def port(argv):
    """The port's CLI on the CPU (the flag goes after the subcommand)."""
    return port_main([argv[0], "--device", "cpu", *argv[1:]])


def _lifecycle(run, d, secpar=128):
    p = lambda name: str(d / name)
    assert run(["setup", "--secpar", str(secpar), "--seed", "42", "--out", p("params.fp")]) == 0
    for k, seed in ((1, 7), (2, 8)):
        assert run(["keygen", "--params", p("params.fp"), "--seed", str(seed),
                    "--out-sk", p(f"sk{k}.fp"), "--out-vk", p(f"vk{k}.fp")]) == 0
    for k, msg in ((1, "hello"), (2, "wörld")):
        assert run(["sign", "--params", p("params.fp"), "--sk", p(f"sk{k}.fp"),
                    "--message", msg, "--out", p(f"s{k}.fp")]) == 0
    assert run(["aggregate", "--params", p("params.fp"),
                "--vk", p("vk1.fp"), "--message", "hello", "--sig", p("s1.fp"),
                "--vk", p("vk2.fp"), "--message", "wörld", "--sig", p("s2.fp"),
                "--out", p("agg.fp")]) == 0


def _verify(run, d, first="hello"):
    p = lambda name: str(d / name)
    return run(["verify", "--params", p("params.fp"), "--vk", p("vk1.fp"), "--message", first,
                "--vk", p("vk2.fp"), "--message", "wörld", "--agg", p("agg.fp")])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The same lifecycle written by each CLI."""
    jd, td = tmp_path_factory.mktemp("jax_cli"), tmp_path_factory.mktemp("port_cli")
    _lifecycle(jax_main, jd)
    _lifecycle(port, td)
    return jd, td


def test_port_cli_lifecycle(dirs, capsys):
    _, td = dirs
    capsys.readouterr()
    assert _verify(port, td) == 0
    assert capsys.readouterr().out.strip() == "OK"
    # a tampered message: exit 1 with the reference's reason
    assert _verify(port, td, first="HELLO") == 1
    assert capsys.readouterr().out.strip() == f"FAIL: {REASON_TARGET}"


def test_cli_files_byte_identical(dirs):
    jd, td = dirs
    for name in FILES:
        assert filecmp.cmp(jd / name, td / name, shallow=False), name


@pytest.mark.parametrize("reader", ["port reads jax", "jax reads port"])
def test_cli_reads_the_other_packages_files(dirs, reader, capsys):
    jd, td = dirs
    run, d = (port, jd) if reader == "port reads jax" else (jax_main, td)
    assert _verify(run, d) == 0
    assert _verify(run, d, first="HELLO") == 1
    assert capsys.readouterr().out.splitlines()[-1] == f"FAIL: {REASON_TARGET}"


def test_port_cli_exit_2(tmp_path):
    p = lambda name: str(tmp_path / name)
    assert port(["setup", "--secpar", "128", "--seed", "1", "--out", p("params.fp")]) == 0
    assert port(["setup", "--secpar", "256", "--seed", "1", "--out", p("params256.fp")]) == 0
    assert port(["keygen", "--params", p("params.fp"), "--seed", "2",
                 "--out-sk", p("sk.fp"), "--out-vk", p("vk.fp")]) == 0
    assert port(["sign", "--params", p("params.fp"), "--sk", p("sk.fp"),
                 "--message", "m", "--out", p("s.fp")]) == 0
    # mismatched counts
    assert port(["aggregate", "--params", p("params.fp"),
                 "--vk", p("vk.fp"), "--message", "m", "--message", "m2",
                 "--sig", p("s.fp"), "--out", p("agg.fp")]) == 2
    assert port(["verify", "--params", p("params.fp"), "--vk", p("vk.fp"),
                 "--message", "m", "--message", "m2", "--agg", p("s.fp")]) == 2
    # a secpar=128 key with secpar=256 parameters
    assert port(["sign", "--params", p("params256.fp"), "--sk", p("sk.fp"),
                 "--message", "m", "--out", p("s2.fp")]) == 2
