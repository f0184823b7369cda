"""The port's CLI and packaging against what deployments hand it.

- Every flag of the JAX package's engine CLI parses in the port's
  (a deployment's arguments never stop at argparse's exit code 2), and
  makes an EngineConfig (or the JAX package's own ValueError); the
  flags the port serves reach EngineConfig.
- Every flag the Helm chart's engine template can emit parses.
- Every file cuda_build.sources() builds from (the .cu sources and the
  .cuh headers they include and the library hash covers) ships in the
  package data.
- The kernels' build directory: $PST_KERNEL_BUILD_DIR, else build/kernels
  beside the package, else a per-user cache when that is not writable;
  a build (a stand-in nvcc here) says where it went.
"""

import fnmatch
import os
import re
import stat
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from production_stack_tpu.engine.__main__ import build_parser as j_parser
from production_stack_tpu_torch.engine.__main__ import (
    build_parser,
    config_from_args,
    main,
)
from production_stack_tpu_torch.ops import cuda_build

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# values for flags that take one (others: by the JAX action's type)
VALUES = {"--model": "pst-tiny-debug", "--tokenizer": "byte",
          "--kv-role": "prefill", "--attention-impl": "xla",
          "--coordinator-address": "10.0.0.1:1234"}


def _flags(parser) -> dict:
    return {o: a for a in parser._actions for o in a.option_strings
            if o.startswith("--")}


def _argv(flag, action) -> list[str]:
    """The flag with a value the JAX CLI takes (a choice the port's parser
    lists, where it lists them)."""
    if action.nargs == 0:
        return [flag]
    if flag in VALUES:
        return [flag, VALUES[flag]]
    choices = _flags(build_parser())[flag].choices or action.choices
    if choices:
        return [flag, str(list(choices)[-1])]
    return [flag, {int: "2", float: "0.5"}.get(action.type, "x")]


# argparse's own --help prints the usage and exits, in both CLIs
JAX_FLAGS = sorted(set(_flags(j_parser())) - {"--help"})


@pytest.mark.parametrize("flag", JAX_FLAGS)
def test_every_jax_cli_flag_parses_in_the_port(flag):
    argv = ["--device", "cpu"] + _argv(flag, _flags(j_parser())[flag])
    args = build_parser().parse_args(argv)
    try:
        config_from_args(args)
    except ValueError as e:
        # a value the JAX package's EngineConfig refuses too, with the
        # same message (--long-prefill-threshold without a ring)
        from production_stack_tpu.engine.__main__ import (
            config_from_args as j_config_from_args,
        )

        with pytest.raises(ValueError) as want:
            j_config_from_args(j_parser().parse_args(argv[2:]))
        assert str(e) == str(want.value)


@pytest.mark.parametrize("argv,field,want", [
    (["--attention-impl", "xla"], "attention_impl", "xla"),
    (["--attention-impl", "pallas"], "attention_impl", "pallas"),
    ([], "attention_impl", "auto"),
    (["--enable-sleep-mode"], "async_decode", False),
    (["--no-async-decode"], "async_decode", False),
    (["--async-decode"], "async_decode", True),
    (["--precompile-serving"], "precompile_serving", True),
    (["--long-prefill-chunk", "128"], "long_prefill_chunk", 128),
    (["--long-prefill-threshold", "4096", "--context-parallel-size", "2"],
     "long_prefill_threshold", 4096),
    (["--context-parallel-size", "2"], "context_parallel_size", 2),
    (["--tensor-parallel-size", "2"], "tensor_parallel_size", 2),
    (["--tensor-parallel-size", "4", "--no-ragged-kernel"],
     "tensor_parallel_size", 4),
    (["--pipeline-parallel-size", "2"], "pipeline_parallel_size", 2),
    (["--multihost", "--num-processes", "2", "--process-id", "1",
      "--coordinator-address", "127.0.0.1:1234"], "multihost", True),
])
def test_served_flags_reach_engine_config(argv, field, want):
    cfg = config_from_args(build_parser().parse_args(["--device", "cpu",
                                                      *argv]))
    assert getattr(cfg, field) == want


# served on a one-host rank set since their exports, imports and adapter
# loads became broadcast steps (the disk tier goes to a temporary
# directory, DISK_DIR)
DISK_DIR = "<tmp>"


@pytest.mark.parametrize("argv", [
    ["--enable-lora"],
    ["--cpu-offload-gb", "1"],
    ["--disk-offload-dir", DISK_DIR],
    ["--remote-cache-url", "http://127.0.0.1:1"],
    ["--kv-role", "kv_consumer"],
    ["--kv-transfer-listen", "127.0.0.1:1"],
    ["--model", "pst-tiny-moe-debug"],
], ids=["enable_lora", "cpu_offload_bytes", "disk_offload_dir",
        "remote_cache_url", "kv_role", "kv_transfer_config", "MoE"])
def test_cli_serves_rank_set_features(argv, monkeypatch, tmp_path):
    """LoRA, the KV tiers, the remote cache, PD roles and MoE at tp=2:
    main() starts the rank set, its config refuses nothing of it, and
    its engine is alive."""
    from production_stack_tpu_torch.engine import server

    started = []
    monkeypatch.setattr(server.EngineServer, "run",
                        lambda self, **kw: started.append(self))
    argv = [str(tmp_path) if a == DISK_DIR else a for a in argv]
    main(["--device", "cpu", "--tokenizer", "byte",
          "--tensor-parallel-size", "2", *argv])
    (srv,) = started
    try:
        assert srv.config.tensor_parallel_size == 2
        assert srv.engine.engine.tp_alive()
    finally:
        srv.engine.shutdown()


@pytest.mark.parametrize("argv,name", [
    (["--precompile-serving"], "precompile_serving"),
    # the ring under tensor parallelism (each tp rank rings its heads)
    (["--tensor-parallel-size", "2", "--context-parallel-size", "2"],
     "context_parallel_size>1"),
    # multi-host flags: an engine on one host, or the job's refusal
    (["--num-processes", "2"], "coordinator address"),
    (["--process-id", "1"], "multihost"),
    (["--coordinator-address", "10.0.0.1:1234"], "num_processes"),
    (["--multihost"], "multihost"),
    # what a rank set carries since its chained rounds, sweeps and ring
    # chunks became published steps
    (["--tensor-parallel-size", "2", "--async-decode",
      "--num-scheduler-steps", "4"], "async_decode"),
    (["--tensor-parallel-size", "2", "--precompile-serving"],
     "precompile_serving"),
])
def test_unported_flags_stop_with_engine_config_message(argv, name,
                                                       monkeypatch):
    """No flag stops in EngineConfig any more: each case was one that
    did (a NotImplementedError naming the feature). --precompile-serving
    is served: main() starts an engine on the CPU, whose server ran the
    warm-up sweep before it would listen (at tp=2 on every rank, eagerly:
    no program variant is built). At tp=2 --async-decode chains its
    rounds and --context-parallel-size 2 is taken (the lane needs a
    threshold too). So are the multi-host flags: each reaches
    EngineConfig as multihost, and main() joins the job first. With no
    job configured (--multihost, a lone --process-id) it serves on one
    host as the JAX CLI does; a job that cannot be joined (a process
    count without a coordinator, a coordinator without a count) stops
    with multihost.initialize's RuntimeError naming what it lacks,
    before anything connects."""
    if name in ("multihost", "coordinator address", "num_processes"):
        from production_stack_tpu_torch.engine import server
        from production_stack_tpu_torch.parallel import multihost

        assert config_from_args(build_parser().parse_args(argv)).multihost
        monkeypatch.setattr(multihost, "_JOB", None)
        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        started = []
        monkeypatch.setattr(server.EngineServer, "run",
                            lambda self, **kw: started.append(self))
        if name != "multihost":
            with pytest.raises(RuntimeError, match=name):
                main(["--device", "cpu", "--tokenizer", "byte", *argv])
            assert not started and multihost.job() is None
            return
        main(["--device", "cpu", "--tokenizer", "byte", *argv])
        (srv,) = started
        eng = srv.engine.engine
        assert srv.config.multihost and not multihost.is_multihost()
        assert not eng._ragged_dispatch and not eng._device_stop
        srv.engine.shutdown()
        return
    from production_stack_tpu_torch.engine import server

    started = []
    monkeypatch.setattr(server.EngineServer, "run",
                        lambda self, **kw: started.append(self))
    extra = (["--max-model-len", "64"]
             if argv[:2] == ["--tensor-parallel-size", "2"] else [])
    main(["--device", "cpu", "--tokenizer", "byte", *argv, *extra])
    (srv,) = started
    eng = srv.engine.engine
    try:
        tp = srv.config.tensor_parallel_size
        if name == "precompile_serving":
            assert srv.config.precompile_serving
            assert eng.precompile_grid is not None
            # a rank set is eager: its sweep builds no program variant
            assert (eng.runner.compile_events_total > 0) == (tp == 1)
        elif name == "async_decode":
            assert eng._async_decode and tp == 2
        else:
            assert srv.config.context_parallel_size == 2 and tp == 2
            assert eng.long_prefill is None  # no threshold, no lane
        assert tp == 1 or eng.tp_alive()
    finally:
        srv.engine.shutdown()


def test_long_prefill_threshold_alone_stops_with_the_jax_message():
    """--long-prefill-threshold without --context-parallel-size > 1
    stops in EngineConfig with the JAX package's ValueError."""
    from production_stack_tpu.engine.__main__ import (
        config_from_args as j_config_from_args,
    )

    argv = ["--long-prefill-threshold", "256"]
    with pytest.raises(ValueError, match="context_parallel_size") as want:
        j_config_from_args(j_parser().parse_args(argv))
    with pytest.raises(ValueError) as got:
        main(["--device", "cpu", *argv])
    assert str(got.value) == str(want.value)


def _serve_completion(argv, monkeypatch) -> tuple[dict, object]:
    """main(argv) on the CPU with its server started on a loopback port;
    one greedy completion -> (response, the server), stopped."""
    import asyncio
    import json
    import threading
    import urllib.request

    from production_stack_tpu_torch.engine import server

    started = []
    monkeypatch.setattr(server.EngineServer, "run",
                        lambda self, **kw: started.append(self))
    main(["--device", "cpu", "--tokenizer", "byte", "--dtype", "float32",
          "--kv-cache-dtype", "float32", "--block-size", "4",
          "--num-kv-blocks", "128", *argv])
    (srv,) = started
    loop = asyncio.new_event_loop()
    box, ready = [], threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box.append(loop.run_until_complete(srv.start("127.0.0.1", 0)))
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    try:
        assert ready.wait(60)
        body = {"model": "pst-tiny-debug", "prompt": "tensor parallel",
                "max_tokens": 8, "temperature": 0.0}
        req = urllib.request.Request(
            f"http://127.0.0.1:{box[0]}/v1/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{box[0]}/health",
                                    timeout=60) as r:
            assert r.status == 200
    finally:
        asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        th.join(30)
    return out, srv


def test_cli_serves_tp2_on_the_cpu_equal_to_tp1(monkeypatch):
    """--tensor-parallel-size 2 --device cpu: the CLI's server on rank 0
    (rank 1 spawned by the engine) answers a greedy completion equal to
    the tp=1 server's, and stopping the server stops the follower."""
    want, _ = _serve_completion([], monkeypatch)
    got, srv = _serve_completion(["--tensor-parallel-size", "2"],
                                 monkeypatch)
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["usage"] == want["usage"]
    (follower,) = srv.engine.engine.runner._group.followers
    assert follower.exitcode == 0


def test_cli_serves_pp2_and_pp2_tp2_on_the_cpu_equal_to_pp1(monkeypatch):
    """--pipeline-parallel-size 2 (and with --tensor-parallel-size 2)
    --device cpu: the CLI's server on rank 0 (stage 0) answers a greedy
    completion equal to the one-rank server's; stopping the server stops
    every follower."""
    want, _ = _serve_completion([], monkeypatch)
    for extra in ([], ["--tensor-parallel-size", "2"]):
        got, srv = _serve_completion(
            ["--pipeline-parallel-size", "2", *extra], monkeypatch)
        assert got["choices"][0]["text"] == want["choices"][0]["text"]
        assert got["usage"] == want["usage"]
        followers = srv.engine.engine.runner._group.followers
        assert [p.exitcode for p in followers] == [0] * len(followers)


def test_engine_template_covers_the_port_cli():
    """Twin of tests/test_helm.py::test_engine_template_covers_engine_cli
    for the port's parser."""
    flags = _flags(build_parser())
    text = (REPO / "helm/templates/deployment-engine.yaml").read_text()
    emitted = re.findall(r'"(--[a-z][a-z0-9-]*)"', text)
    assert "--attention-impl" in emitted and "--precompile-serving" in emitted
    for flag in emitted:
        assert flag in flags, f"chart emits unknown flag {flag}"


def test_package_data_ships_every_kernel_source():
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"][
        "production_stack_tpu_torch"]
    pkg = REPO / "production_stack_tpu_torch"
    srcs = cuda_build.sources()
    assert {p.suffix for p in srcs} == {".cu", ".cuh"}
    for src in srcs:
        rel = src.relative_to(pkg).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


def test_build_dir_override_and_fallback(monkeypatch, tmp_path):
    monkeypatch.setenv("PST_KERNEL_BUILD_DIR", str(tmp_path / "k"))
    assert cuda_build.build_dir() == tmp_path / "k"
    assert cuda_build.library_path().parent == tmp_path / "k"
    monkeypatch.delenv("PST_KERNEL_BUILD_DIR")
    # a checkout: beside the package, in the gitignored build/
    assert cuda_build.build_dir() == REPO / "build" / "kernels"
    # an installed package where build/ cannot be made: the user's cache
    blocker = tmp_path / "site"
    blocker.write_text("a file where build/ would go")
    monkeypatch.setattr(cuda_build, "CSRC", blocker / "pkg" / "csrc")
    assert not cuda_build._writable(blocker / "build" / "kernels")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert cuda_build.build_dir() == (
        tmp_path / "cache" / "production_stack_tpu_torch" / "kernels")
    # a directory that does not exist yet is writable where its nearest
    # existing ancestor is
    assert cuda_build._writable(tmp_path / "new" / "deeper")
    assert os.access(tmp_path, os.W_OK)


def test_build_writes_into_the_chosen_dir_and_says_so(monkeypatch, tmp_path,
                                                      capsys):
    """build() with a stand-in nvcc (it writes each -o file): one compile
    per .cu source, one link, the library and its log land in the build
    directory, and stderr names it."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "a = sys.argv\n"
        "open(a[a.index('-o') + 1], 'w').write('x')\n"
        "print('ptxas info : stand-in')\n")
    fake.chmod(stat.S_IRWXU)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setenv("PST_KERNEL_BUILD_DIR", str(tmp_path / "out"))
    lib = cuda_build.build()
    assert lib.parent == tmp_path / "out" and lib.exists()
    n_cu = sum(1 for s in cuda_build.sources() if s.suffix == ".cu")
    assert lib.with_suffix(".log").read_text().count("stand-in") == n_cu
    assert str(tmp_path / "out") in capsys.readouterr().err
    assert cuda_build.build() == lib  # built once
