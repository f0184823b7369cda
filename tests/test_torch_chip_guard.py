"""The port's card-session guard (utils/chip_guard.py) held to each case
of tests/test_chip_guard.py, keyed on the process's CUDA device instead
of JAX_PLATFORMS: one card owner at a time (flock), SIGTERM-only
teardown, no lock for a CPU run. The two packages' locks exclude each
other on one path."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from production_stack_tpu_torch.utils import chip_guard
from production_stack_tpu_torch.utils.chip_guard import (
    ChipBusyError,
    ChipLock,
    acquire_chip_lock,
    chip_guard_needed,
    install_sigterm_handler,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def card(monkeypatch):
    """A process that sees one CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)


def test_second_acquire_fails_fast(tmp_path):
    path = str(tmp_path / "chip.lock")
    lock = ChipLock(path).acquire()
    try:
        with pytest.raises(ChipBusyError) as ei:
            ChipLock(path).acquire()
        assert "SIGKILL" in str(ei.value)  # teardown guidance in the error
        assert f"pid={os.getpid()}" in str(ei.value)  # names the holder
        assert "CUDA card" in str(ei.value)
    finally:
        lock.release()


def test_release_allows_reacquire(tmp_path):
    path = str(tmp_path / "chip.lock")
    lock = ChipLock(path).acquire()
    lock.release()
    with ChipLock(path):
        pass  # context-manager form


@pytest.mark.parametrize("module", [
    "production_stack_tpu_torch.utils.chip_guard",
    "production_stack_tpu.utils.chip_guard",
])
def test_cross_process_exclusion(tmp_path, module):
    """A second process (the port's guard, and the JAX package's on the
    same path) is refused while this one holds the lock."""
    path = str(tmp_path / "chip.lock")
    with ChipLock(path):
        rc = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[2]);"
             f"from {module} import *\n"
             "try:\n"
             "    ChipLock(sys.argv[1]).acquire()\n"
             "except ChipBusyError:\n"
             "    sys.exit(42)\n"
             "sys.exit(0)",
             path, str(REPO)],
            env={**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""},
        ).returncode
        assert rc == 42


def test_guard_skipped_on_cpu_device(monkeypatch):
    assert not chip_guard_needed("cpu")
    assert not chip_guard_needed(" CPU ")
    assert acquire_chip_lock(device="cpu") is None  # CPU runs never contend
    # a process that sees no card takes no lock
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not chip_guard_needed()
    assert acquire_chip_lock() is None
    # nor one whose CUDA_VISIBLE_DEVICES names no card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for vis in ("", "-1", " -1,0"):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", vis)
        assert not chip_guard_needed("cuda"), vis


def test_guard_needed_on_cuda_devices(card, monkeypatch):
    for device in (None, "cuda", "cuda:0", "cuda:1", " CUDA "):
        assert chip_guard_needed(device), device
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,0")
    assert chip_guard_needed()
    assert not chip_guard_needed("cpu")


def test_default_lock_names_the_card(card, monkeypatch, tmp_path):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(chip_guard.tempfile, "tempdir", None)
    assert chip_guard.default_lock_path() == str(tmp_path / "pst_cuda0.lock")
    assert chip_guard.default_lock_path("cuda:2").endswith("pst_cuda2.lock")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    assert chip_guard.default_lock_path("cuda:1").endswith("pst_cuda5.lock")
    monkeypatch.delenv("PST_CHIP_LOCK", raising=False)
    lock = acquire_chip_lock(device="cuda:1")
    try:
        assert lock.path == str(tmp_path / "pst_cuda5.lock")
    finally:
        lock.release()


def test_engage_ritual(tmp_path, monkeypatch, card):
    monkeypatch.setenv("PST_CHIP_LOCK", str(tmp_path / "chip.lock"))
    lock = chip_guard.engage()
    try:
        assert lock is not None
        with pytest.raises(ChipBusyError):
            chip_guard.engage()
        # a CPU run takes no lock and keeps its SIGTERM default
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        assert chip_guard.engage(device="cpu") is None
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    finally:
        lock.release()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_sigterm_becomes_systemexit():
    install_sigterm_handler()
    try:
        with pytest.raises(SystemExit) as ei:
            os.kill(os.getpid(), signal.SIGTERM)
            signal.sigtimedwait([], 0)  # force delivery point
        assert ei.value.code == 143
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_smoke_engages_it_and_the_engine_cli_does_not():
    """chip_smoke.py holds the card for its whole run; the engine CLI
    takes no lock (several engines share one card)."""
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "chip_guard.engage(" in smoke
    cli = (REPO / "production_stack_tpu_torch" / "engine"
           / "__main__.py").read_text()
    assert "chip_guard" not in cli
