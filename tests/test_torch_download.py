"""models/download.py on the port against the JAX downloader, with a stub
huggingface_hub in sys.modules (nothing is downloaded); and the port's
console scripts in pyproject.toml, each naming a callable entry point."""

from __future__ import annotations

import importlib
import sys
import tomllib
import types
from pathlib import Path

import pytest

from production_stack_tpu.models import download as jax_download
from production_stack_tpu_torch.models import download as port_download

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def hub(monkeypatch):
    calls = []

    def snapshot_download(repo_id, **kw):
        calls.append((repo_id, kw))
        return kw["local_dir"]

    monkeypatch.setitem(sys.modules, "huggingface_hub", types.SimpleNamespace(
        snapshot_download=snapshot_download))
    monkeypatch.setenv("HF_TOKEN", "tok")
    return calls


def test_download_calls_the_hub_as_jax(hub, tmp_path):
    for mod in (jax_download, port_download):
        dest = tmp_path / mod.__name__
        assert mod.download("org/model", str(dest)) == str(dest)
        assert dest.is_dir()
    (jrepo, jkw), (prepo, pkw) = hub
    assert prepo == jrepo == "org/model"
    assert {k: v for k, v in pkw.items() if k != "local_dir"} == {
        k: v for k, v in jkw.items() if k != "local_dir"}
    assert pkw["token"] == "tok"
    assert port_download.WEIGHT_PATTERNS == jax_download.WEIGHT_PATTERNS


def test_download_without_the_hub_gives_the_jax_message(monkeypatch,
                                                        tmp_path):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    msgs = []
    for mod in (jax_download, port_download):
        with pytest.raises(RuntimeError) as e:
            mod.download("org/model", str(tmp_path))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_download_cli_usage(capsys):
    assert port_download.main([]) == jax_download.main([]) == 2


def test_console_scripts_name_the_port_entry_points():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    port = {k: v for k, v in scripts.items() if k.startswith("pst-torch-")}
    assert sorted(port) == ["pst-torch-cache-server", "pst-torch-download",
                            "pst-torch-engine", "pst-torch-router"]
    for name, target in port.items():
        mod, _, fn = target.partition(":")
        assert mod.startswith("production_stack_tpu_torch.")
        assert callable(getattr(importlib.import_module(mod), fn))
        # beside the JAX package's role of the same name
        assert scripts[name.replace("pst-torch-", "pst-")].replace(
            "production_stack_tpu.", "production_stack_tpu_torch.") == target
