"""The port's router runs on the standard library alone.

A subprocess refuses aiohttp, prometheus_client, yaml, xxhash, torch and
jax with a meta-path finder, then imports every module of
production_stack_tpu_torch.router, builds the app from the JAX router's
flags, builds (and starts) every routing logic, renders /metrics and
loads a JSON dynamic config; a YAML one is refused with an error naming
the file. None of the refused packages may end up in sys.modules (a lazy
import on any of those paths would). Also: the router's files mirror
the JAX router's one for one, and its CLI takes the JAX router's flags.
"""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
REFUSED = ("aiohttp", "prometheus_client", "yaml", "xxhash", "torch", "jax")

CHILD = textwrap.dedent("""
    import asyncio, importlib, json, os, pkgutil, socket, sys

    REFUSED = set(sys.argv[1].split(","))

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in REFUSED:
                raise ImportError(f"refused: {name}")
            return None

    sys.meta_path.insert(0, Refuse())

    import production_stack_tpu_torch.router as router_pkg

    names = [m.name for m in pkgutil.walk_packages(
        router_pkg.__path__, prefix="production_stack_tpu_torch.router.")]
    for name in names:
        importlib.import_module(name)

    from production_stack_tpu_torch.router import parsers
    from production_stack_tpu_torch.router import routing_logic as rl
    from production_stack_tpu_torch.router.app import build_app
    from production_stack_tpu_torch.router.dynamic_config import (
        DynamicRouterConfig,
    )
    from production_stack_tpu_torch.router.services import metrics_service

    def port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    tmp = sys.argv[2]
    args = parsers.parse_args([
        "--service-discovery", "static",
        "--static-backends", "http://127.0.0.1:1,http://127.0.0.1:2",
        "--static-models", "m,m", "--routing-logic", "roundrobin",
        "--enable-batch-api", "--file-storage-path", tmp,
        "--feature-gates", "SemanticCache=true,PIIDetection=true",
    ])
    build_app(args)

    async def logics():
        built = []
        for logic in rl.RoutingLogic:
            r = rl.initialize_routing_logic(
                logic.value, session_key="x-user-id",
                kv_controller_url=f"127.0.0.1:{port()}",
                kv_cache_server_url="127.0.0.1:1")
            await r.start()
            await r.close()
            built.append(type(r).__name__)
        return built

    built = asyncio.run(logics())
    text = metrics_service.render_prometheus()
    cfg = os.path.join(tmp, "dyn.json")
    with open(cfg, "w") as f:
        json.dump({"routing_logic": "session", "admission": {}}, f)
    assert DynamicRouterConfig.from_file(cfg).routing_logic == "session"
    yml = os.path.join(tmp, "dyn.yaml")
    with open(yml, "w") as f:
        f.write("routing_logic: session\\n")
    try:
        DynamicRouterConfig.from_file(yml)
        refused = None
    except ValueError as e:
        refused = str(e)
    print(json.dumps({
        "modules": len(names), "built": built,
        "families": text.count("# TYPE "), "yaml": refused,
        "loaded": sorted(n for n in sys.modules
                         if n.split(".")[0] in REFUSED)}))
""")


def test_router_imports_only_the_stdlib(tmp_path):
    r = subprocess.run(
        [sys.executable, "-c", CHILD, ",".join(REFUSED), str(tmp_path)],
        cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["modules"] >= 32  # the router's modules and packages
    assert out["built"] == [
        "RoundRobinRouter", "SessionRouter", "KvawareRouter",
        "PrefixAwareRouter", "DisaggregatedPrefillRouter", "TtftRouter",
        "LeastLatencyRouter", "PDRouter"]
    assert out["families"] > 40
    assert "dyn.yaml" in out["yaml"] and "JSON" in out["yaml"]


def test_router_has_a_counterpart_of_every_jax_router_file():
    jax = REPO / "production_stack_tpu" / "router"
    port = REPO / "production_stack_tpu_torch" / "router"
    want = sorted(p.relative_to(jax) for p in jax.rglob("*.py"))
    got = sorted(p.relative_to(port) for p in port.rglob("*.py"))
    assert got == want


def test_router_cli_takes_the_jax_router_flags():
    """Every flag of the JAX router's parser, with its default, choices
    and action, in the port's."""
    from production_stack_tpu.router import parsers as jax_parsers
    from production_stack_tpu_torch.router import parsers as port_parsers

    def flags(mod):
        return [(a.option_strings, a.dest, a.default, a.choices,
                 type(a).__name__, a.nargs)
                for a in mod.build_parser()._actions]

    assert flags(port_parsers) == flags(jax_parsers)
