"""The PyTorch port imports neither JAX nor the JAX package."""
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


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
