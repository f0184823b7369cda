"""Finds everything of a cell by the names in ``BENCHMARK.json``.

A cell ``<name>`` is ``workloads/<name>.json``; its configuration is the
file its ``configs`` entry names; its traffic mix is
``traffic/<traffic>.json``; a metric ``<name>`` is read by
``metrics/<name>.py``, else by ``metrics/<name before its first dot>.py``.
All of these lie under the benchmark's first path. Adding a cell, a
configuration, a mix or a metric is adding files and entries; no file of
the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "production_stack_tpu")


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: the port's own name begins with the
    JAX package's and is allowed."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


class Layout:
    def __init__(self, base: Path, bench_file: Path | None = None):
        self.base = Path(base)
        path = bench_file or self.base / "BENCHMARK.json"
        self.bench = json.loads(Path(path).read_text())
        self.pkg = self.base / self.bench["paths"][0]
        self._readers: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._json(self.pkg / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return self._json(self.base / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json(self.pkg / "traffic" / f"{name}.json")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The entries of `kind` ("end_to_end" or "per_layer") that the
        cell reports: those listing it, and those listing no cells."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The `read` function of metric `name`."""
        if name not in self._readers:
            d = self.pkg / "metrics"
            path = d / f"{name}.py"
            if not path.exists():
                path = d / f"{name.split('.')[0]}.py"
            mod_name = "portbench_metric_" + "".join(
                c if c.isalnum() else "_" for c in path.stem)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]

    @staticmethod
    def _json(path: Path) -> dict:
        return json.loads(Path(path).read_text())
