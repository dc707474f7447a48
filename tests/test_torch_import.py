"""The PyTorch port imports neither JAX nor the JAX package, and its
lower layers import nothing from ``scheme/``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "fusion_cryptography_tpu_torch"
# modules below the scheme layer: they read the device rule from ops/upload.py
BELOW_SCHEME = sorted(str(p.relative_to(PKG)) for p in (PKG / "algebra").glob("*.py")) + [
    "interop/objects.py", "interop/serial.py", "parallel/distributed.py", "parallel/mesh.py"]


def test_port_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import fusion_cryptography_tpu_torch\n"
        "import fusion_cryptography_tpu_torch.scheme.device_setup\n"
        "import fusion_cryptography_tpu_torch.profile_verify\n"
        "import fusion_cryptography_tpu_torch.ops.preimage_fold\n"
        "import fusion_cryptography_tpu_torch.ops.ntt\n"
        "import fusion_cryptography_tpu_torch.scheme.lifecycle\n"
        "import fusion_cryptography_tpu_torch.interop.serial\n"
        "import fusion_cryptography_tpu_torch.ops.assemble_spec\n"
        "import fusion_cryptography_tpu_torch.interop.api\n"
        "import fusion_cryptography_tpu_torch.interop.objects\n"
        "import fusion_cryptography_tpu_torch.interop.kat\n"
        "import fusion_cryptography_tpu_torch.hashing.decode\n"
        "import fusion_cryptography_tpu_torch.algebra.ntt\n"
        "import fusion_cryptography_tpu_torch.algebra.polynomials\n"
        "import fusion_cryptography_tpu_torch.algebra.matrices\n"
        "import fusion_cryptography_tpu_torch.fusion.fusion\n"
        "import fusion_cryptography_tpu_torch.__main__\n"
        "import fusion_cryptography_tpu_torch.scheme.serde\n"
        "import fusion_cryptography_tpu_torch.utils\n"
        "import fusion_cryptography_tpu_torch.utils.log\n"
        "import fusion_cryptography_tpu_torch.utils.profiling\n"
        "import fusion_cryptography_tpu_torch.ops.upload\n"
        "import fusion_cryptography_tpu_torch.hashing.sampler\n"
        "import fusion_cryptography_tpu_torch.parallel\n"
        "import fusion_cryptography_tpu_torch.parallel.distributed\n"
        "import fusion_cryptography_tpu_torch.parallel.mesh\n"
        "import fusion_cryptography_tpu_torch.parallel.sharded\n"
        "import fusion_cryptography_tpu_torch.parallel.distributed_ntt\n"
        "import fusion_cryptography_tpu_torch.parallel._launch\n"
        "import fusion_cryptography_tpu_torch.pod_scale\n"
        "import fusion_cryptography_tpu_torch.demo\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'fusion_cryptography_tpu' or m.startswith('fusion_cryptography_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout.strip()}"


def test_parallel_import_leaves_jax_out():
    """A fresh interpreter that imports the sharding package alone."""
    code = (
        "import sys\n"
        "import fusion_cryptography_tpu_torch.parallel\n"
        "print(','.join(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'fusion_cryptography_tpu')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"parallel pulled in: {out.stdout.strip()}"


def _imports(path: Path):
    """(level, dotted name) of each name a module's import statements bind;
    level > 0 for a relative import."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from ((0, a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield from ((node.level, f"{node.module or ''}.{a.name}".strip("."))
                        for a in node.names)


@pytest.mark.parametrize("module", BELOW_SCHEME)
def test_lower_layer_imports_no_scheme(module):
    """Read from the source: importing any submodule loads ``scheme`` through
    the package's ``__init__``, so ``sys.modules`` cannot tell."""
    names = [n for _, n in _imports(PKG / module) if "scheme" in n.split(".")]
    assert names == [], f"{module} imports {names}"


def test_device_rule_module_is_a_leaf():
    """``resolve_device`` and ``input_device`` live in a module that imports
    nothing from the package."""
    names = [n for level, n in _imports(PKG / "ops" / "upload.py")
             if level or n.split(".")[0] == PKG.name]
    assert names == []
