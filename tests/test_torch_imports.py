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
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "scripts/torch_kernel_ab.py"]
FORBIDDEN = ("jax", "jaxlib", "production_stack_tpu", "aiohttp",
             "prometheus_client", "xxhash", "safetensors")
# HF packages the card machine lacks: imported only inside the functions
# that serve a checkpoint's own tokenizer or write a debug one
LAZY_HF = {"transformers": {"engine/tokenizer.py"},
           "tokenizers": {"models/debug_checkpoint.py"}}


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


@pytest.mark.parametrize("package", sorted(LAZY_HF))
def test_hf_packages_only_behind_lazy_imports(package):
    """No module of the port (nor chip_smoke.py) imports `package` at
    top level, and only LAZY_HF's files import it at all."""
    users = set()
    for path in SOURCES:
        tree = ast.parse(path.read_text(), str(path))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] == package for n in names):
                assert node not in top, f"{path} imports {package} at top"
                users.add(str(path.relative_to(PORT)) if PORT in
                          path.parents else str(path))
    assert users <= LAZY_HF[package], users


def test_every_port_module_imports_without_a_card():
    names = [m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="production_stack_tpu_torch.")]
    assert "production_stack_tpu_torch.ops.paged_attention" in names
    for name in names:
        importlib.import_module(name)
    from production_stack_tpu_torch.ops import cuda_build

    assert cuda_build._LIB is None  # importing built nothing


def test_kernel_source_ships_with_the_package():
    from production_stack_tpu_torch.ops import cuda_build
    from production_stack_tpu_torch.ops import paged_attention as pa

    assert sorted(pa._ARGTYPES) == ["pst_paged_decode_attention",
                                    "pst_paged_prefill_attention",
                                    "pst_ragged_paged_attention"]
    text = "".join(s.read_text() for s in cuda_build.sources()
                   if s.suffix == ".cu")
    for entry in pa._ARGTYPES:
        assert text.count(f"int {entry}(") == 1
    assert "sm_90a" in " ".join(cuda_build.NVCC_FLAGS)
    # the build output lands in a directory git ignores
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_argtypes_match_the_c_signatures():
    """Each entry point's ctypes argtypes follow its C parameter list
    (pointers and the stream c_void_p, int64_t c_int64, float c_float,
    int c_int): a wrong one would pass a cut or shifted argument."""
    import ctypes
    import re

    from production_stack_tpu_torch.ops import cuda_build
    from production_stack_tpu_torch.ops import paged_attention as pa

    text = "".join(s.read_text() for s in cuda_build.sources()
                   if s.suffix == ".cu")
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int64: "int64_t",
             ctypes.c_float: "float", ctypes.c_int: "int"}
    for entry, argtypes in pa._ARGTYPES.items():
        params = re.search(rf"int {entry}\(([^)]*)\)", text).group(1)
        want = ["ptr" if "*" in p else p.split()[0]
                for p in params.split(",")]
        assert [kinds[a] for a in argtypes] == want, entry


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """The library's file name changes when any csrc source or header
    changes, so an edited header never loads a stale build."""
    from production_stack_tpu_torch.ops import cuda_build

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build.library_path()
    assert cuda_build.sources() == [tmp_path / "common.cuh",
                                    tmp_path / "k.cu"]
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build.library_path()
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edit\n')
    third = cuda_build.library_path()
    (tmp_path / "other.cu").write_text("// a new source\n")
    assert len({first, second, third, cuda_build.library_path()}) == 4
