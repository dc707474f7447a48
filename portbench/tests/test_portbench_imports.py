"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "fusion_cryptography_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(imported_tops(f)) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = set(imported_tops(f))
        assert "fusion_cryptography_tpu_torch" not in tops, f
        assert tops <= {"__future__", "random", "dataclasses", "functools", "hashlib", "math",
                        "typing", "numpy"}, (f, tops)


def test_the_port_name_is_not_the_jax_name():
    assert "fusion_cryptography_tpu_torch".split(".")[0] not in FORBIDDEN
