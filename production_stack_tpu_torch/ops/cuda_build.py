"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Every ``csrc/*.cu`` goes into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds): one ``nvcc -c`` per source, all started at once, then one link.
The build runs at first use into ``build_dir()``: ``$PST_KERNEL_BUILD_DIR``
when it is set, else ``build/kernels/`` beside the package (in a
checkout, the repository's gitignored ``build/``), else, where that is
not writable (an installed package), a per-user cache directory. The
library's file name carries a hash of every file under ``csrc/`` and of
the compiler flags, so an edited source or header never loads a stale
build. Nothing here runs at import time: the CPU-only tests import every
module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


BUILD_DIR_ENV = "PST_KERNEL_BUILD_DIR"


def _writable(path: Path) -> bool:
    """Whether `path` could be created and written: its nearest existing
    ancestor is a writable directory."""
    for p in (path, *path.parents):
        if p.exists():
            return p.is_dir() and os.access(p, os.W_OK | os.X_OK)
    return False


def build_dir() -> Path:
    """Where the library is built: $PST_KERNEL_BUILD_DIR, else
    build/kernels beside the package, else (not writable there) the
    user's cache directory."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env).expanduser()
    beside = CSRC.parent.parent / "build" / "kernels"
    if _writable(beside):
        return beside
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "production_stack_tpu_torch" / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels build "
        "on a machine with the CUDA toolkit"
    )


def sources() -> list[Path]:
    """Every file under csrc/ (the .cu sources and the headers they
    include), in a fixed order."""
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"libpst_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a build of these exact sources exists.
    The compilers' -Xptxas -v reports (registers, shared memory, spills)
    land beside the library as <lib>.log."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"building the CUDA kernels into {out.parent} (set "
          f"{BUILD_DIR_ENV} to choose the directory)", file=sys.stderr,
          flush=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        cus = [s for s in sources() if s.suffix == ".cu"]
        objs = [Path(tmp) / f"{s.stem}.o" for s in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{s.name} ({p.returncode}):\n{log[-4000:]}"
                  for s, p, log in zip(cus, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-4000:]}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)  # atomic: concurrent builders never see a part
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = ctypes.CDLL(str(build()))
        return _LIB
