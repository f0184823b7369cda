"""The PyTorch port stands alone: no module of production_stack_tpu_torch,
and not chip_smoke.py, imports jax or anything of the JAX package
production_stack_tpu (checked on the source, so a lazy import inside a
function counts too). Also: every module of the port imports on a
CPU-only machine without building a kernel."""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "production_stack_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu", "aiohttp",
             "prometheus_client", "xxhash")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    bad = [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_every_port_module_imports_without_a_card():
    names = [m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="production_stack_tpu_torch.")]
    assert "production_stack_tpu_torch.ops.paged_attention" in names
    for name in names:
        importlib.import_module(name)
    from production_stack_tpu_torch.ops import cuda_build

    assert cuda_build._LIBS == {}  # importing built nothing


def test_kernel_source_ships_with_the_package():
    from production_stack_tpu_torch.ops import cuda_build

    src = cuda_build.CSRC / "paged_attention.cu"
    text = src.read_text()
    for entry in ("pst_ragged_paged_attention", "pst_paged_prefill_attention",
                  "pst_paged_decode_attention"):
        assert f"int {entry}(" in text
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    # the build output lands in a directory git ignores
    assert "build/" in (REPO / ".gitignore").read_text().split()
