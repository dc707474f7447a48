"""The harness finds a cell's configuration, traffic mix and metrics by the
names in BENCHMARK.json: a new configuration, mix and per-layer metric,
added as files of their own with entries in BENCHMARK.json, run without
any existing file of the benchmark being edited."""
import hashlib
import json

from portbench import core

from harness_util import copy_bench, run_cpu


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric(tmp_path):
    bench = copy_bench(tmp_path)
    before = digests(bench)
    config = json.loads((bench / "configs" / "fusion256-n4-g8192.json").read_text())
    config.update(name="fusion128-n2-g6", secpar=128, degree=64, rank=195, signers=2, groups=6)
    (bench / "configs" / "fusion128-n2-g6.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny.json").write_text(json.dumps({
        "message_length": {"fixed": 20}, "batches": 2, "tamper_share": 0.34,
        "check_groups": 6}))
    (bench / "metrics" / "calls_traced.tiny.py").write_text(
        "def read(trace):\n    return float(trace.calls)\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "fusion128-n2-g6", "source": "test",
                                "file": "portbench/configs/fusion128-n2-g6.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "verify.tiny", "config": "fusion128-n2-g6",
                                  "traffic": "tiny", "chips": 1, "why": "test"})
    manifest["end_to_end"][0]["workloads"].append("verify.tiny")
    manifest["per_layer"].append({"name": "calls_traced.tiny", "unit": "calls",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "test", "moves": "verifies_per_s",
                                  "workloads": ["verify.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = core.Cell(core.manifest(tmp_path), "verify.tiny", bench)
    assert cell.config["groups"] == 6 and cell.traffic["message_length"] == {"fixed": 20}
    plain = run_cpu(cell)
    assert plain["correct"] and set(plain["metrics"]) == {"verifies_per_s", "setup_s"}
    traced = run_cpu(core.Cell(core.manifest(tmp_path), "verify.tiny", bench), trace=True)
    assert traced["correct"] and traced["metrics"]["calls_traced.tiny"]["value"] >= 3
    # device metrics are left out of a CPU run; the host span is read
    assert "verify_roofline" not in traced["metrics"]
    assert "host_pack_ms.verify" not in traced["metrics"]  # not listed for this cell
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
