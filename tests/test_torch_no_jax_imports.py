"""The port stands alone: no module of ``mmdx_tpu_torch/``, nor
``chip_smoke.py`` or the port's scripts on the card (profiling, kernel
timing, ablation, ptxas report, profiler windows), imports jax, flax or any
module of the JAX package ``mmdx_tpu`` (it keeps its own copies of the
framework-free modules it needs). Checked on the source with ``ast``, so
imports inside functions count too."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "mmdx_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + [ROOT / "scripts" / f"{name}.py" for name in (
        "profile_torch_port", "bench_decode_kernels", "ablate_gemm", "ptxas_report",
        "profiler_windows")]
FORBIDDEN = ("jax", "flax", "mmdx_tpu")


def forbidden_imports(tree: ast.AST) -> list[str]:
    """Module names of every import of jax, flax or mmdx_tpu (not
    mmdx_tpu_torch) in ``tree``."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return [n for n in names if n.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    assert forbidden_imports(ast.parse(path.read_text(), str(path))) == []


def test_checker_sees_every_import_form():
    src = ("import jax\nimport flax.linen as nn\nfrom mmdx_tpu.config import X\n"
           "def f():\n    from mmdx_tpu import native\n    import mmdx_tpu.io.images\n"
           "import mmdx_tpu_torch.config\nfrom mmdx_tpu_torch import _build\n"
           "from . import x\n")
    assert forbidden_imports(ast.parse(src)) == [
        "jax", "flax.linen", "mmdx_tpu.config", "mmdx_tpu", "mmdx_tpu.io.images"]


def test_the_port_covers_its_native_sources():
    """The host cores the port builds are its own copies, in its package."""
    names = {p.name for p in (ROOT / "mmdx_tpu_torch" / "native").glob("*.cc")}
    assert names == {"resize_u8.cc", "wordpiece.cc", "unigram.cc"}
    assert ROOT / "mmdx_tpu_torch" / "native" / "__init__.py" in SOURCES
