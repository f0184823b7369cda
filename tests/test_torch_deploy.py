"""The port's deployment surface, on the CPU (no jax): the CUDA engine's
Helm template (helm/templates/deployment-engine-cuda.yaml) and its
example overlay (helm/values-h100.yaml), the two images
(docker/Dockerfile.cuda, docker/Dockerfile.torch-router), the kernel
build as an image step (`python -m production_stack_tpu_torch.ops.
cuda_build`), and what chip_smoke.py's deploy phase holds the engine to
on the card.

- Every flag the template emits parses in the port's CLI; it consumes
  every per-entry knob the TPU engine's templates consume, except the
  TPU-only ones; it requests nvidia.com/gpu, labels its pods as the
  router's discovery selects engines, outlasts the server's SIGTERM
  drain, and refuses multiHost and cpuOnly.
- The overlay's entry uses only knobs the template consumes, and the
  template's args for it (rendered here for that entry) are
  chip_smoke.DEPLOY_ARGV.
- Neither image installs jax or the project's declared dependencies;
  the modules they run resolve; the engine image builds the kernels into
  PST_KERNEL_BUILD_DIR.
- Where no nvcc is found, the build step fails naming the library it
  looked for and creates nothing; a library already present loads with
  no compiler and writes nothing.
- The engine names the dashboard and the alert rules query are on a CPU
  port engine's /metrics; the names chip_smoke excuses as the router's
  are on the port router's and not on the engine's.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import stat
import subprocess
import sys
import tomllib
import urllib.request
from pathlib import Path

import pytest
import torch
import yaml

import chip_smoke
from production_stack_tpu_torch.engine.__main__ import build_parser
from production_stack_tpu_torch.engine.server import SHUTDOWN_TIMEOUT_S
from production_stack_tpu_torch.ops import cuda_build
from tests.torch_engine_server import serving

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TEMPLATES = REPO / "helm" / "templates"
CUDA_T = (TEMPLATES / "deployment-engine-cuda.yaml").read_text()
TPU_T = (TEMPLATES / "deployment-engine.yaml").read_text()
# the per-entry objects a modelSpec entry gets besides its Deployment
TPU_ENTRY_T = TPU_T + (TEMPLATES / "extras.yaml").read_text() + (
    TEMPLATES / "services.yaml").read_text()
# modelSpec knobs with no meaning on an NVIDIA card
TPU_ONLY = {"tpuAccelerator", "tpuTopology", "requestTPU", "multiHost",
            "cpuOnly"}
H100 = yaml.safe_load((REPO / "helm" / "values-h100.yaml").read_text())
DOCKERFILES = ("Dockerfile.cuda", "Dockerfile.torch-router")


def _knobs(text: str) -> set[str]:
    return set(re.findall(r"\$ms\.(\w+)", text))


def _flags(text: str) -> list[str]:
    return re.findall(r'"(--[a-z][a-z0-9-]*)"', text)


def test_template_flags_parse_in_the_port_cli():
    emitted = _flags(CUDA_T)
    assert "--model" in emitted and "--kv-peer" in emitted
    parsed = {s for a in build_parser()._actions for s in a.option_strings}
    missing = sorted(set(emitted) - parsed)
    assert not missing, f"the CUDA template emits unknown flags {missing}"
    # the same args block as the TPU engine's
    assert emitted == _flags(TPU_T)


def test_template_consumes_every_non_tpu_knob():
    missing = sorted(_knobs(TPU_ENTRY_T) - TPU_ONLY - _knobs(CUDA_T))
    assert not missing, f"knobs the CUDA template drops: {missing}"
    assert {"requestGPU", "runtimeClassName", "securityContext"} <= _knobs(
        CUDA_T)
    # a TPU-only knob appears only in a fail guard
    used = _knobs(CUDA_T) & TPU_ONLY
    assert used == {"multiHost", "cpuOnly"}


def test_template_runs_the_port_on_nvidia_cards():
    assert 'command: ["python", "-m", "production_stack_tpu_torch.engine"]' \
        in CUDA_T
    assert importlib.util.find_spec("production_stack_tpu_torch.engine")
    for word in ("google.com/tpu", "gke-tpu", "production_stack_tpu.engine"):
        assert word not in CUDA_T, word
    resources = CUDA_T[CUDA_T.index("          resources:"):
                       CUDA_T.index("          startupProbe:")]
    requests, limits = resources.split("            limits:")
    assert "nvidia.com/gpu: {{ $gpus | quote }}" in requests
    assert "nvidia.com/gpu: {{ $gpus | quote }}" in limits
    assert "requestGPU | default (mul ($ms.tensorParallelSize | default 1)" \
        " ($ms.pipelineParallelSize | default 1))" in CUDA_T
    # the router's pod-ip discovery selects app=<fullname>-engine
    label = 'app: "{{ include "pst.fullname" $root }}-engine"'
    assert label in TPU_T
    assert CUDA_T.count(label) == 3  # selector, pod template, Service
    assert "medium: Memory" in CUDA_T and "mountPath: /dev/shm" in CUDA_T
    grace = int(re.search(r"terminationGracePeriodSeconds: (\d+)",
                          CUDA_T).group(1))
    assert grace >= SHUTDOWN_TIMEOUT_S
    assert grace == chip_smoke.DEPLOY_GRACE_S
    probe = {k: int(re.search(
        rf"\(\$ms\.startupProbe\)\.{k} \| default (\d+)", CUDA_T).group(1))
        for k in ("initialDelaySeconds", "periodSeconds", "failureThreshold")}
    assert chip_smoke.DEPLOY_STARTUP_WINDOW_S == (
        probe["initialDelaySeconds"]
        + probe["periodSeconds"] * probe["failureThreshold"])


def test_template_renders_each_entrys_objects():
    """Deployment, Service, PVC and hf-token Secret, named as the TPU
    templates name them."""
    for kind in ("Deployment", "Service", "PersistentVolumeClaim", "Secret"):
        assert f"kind: {kind}\n" in CUDA_T, kind
    for name in ("-{{ $ms.name }}-engine", "-{{ $ms.name }}-pvc",
                 "-{{ $ms.name }}-secrets"):
        assert name in CUDA_T and name in TPU_ENTRY_T, name
    assert "range $ms := (.Values.servingEngineSpec.cudaModelSpec | " \
           "default list)" in CUDA_T


@pytest.mark.parametrize("knob,reason", [
    ("multiHost", "NCCL is untried"),
    ("cpuOnly", "refuses to run without a card"),
])
def test_template_fails_on_tpu_only_modes(knob, reason):
    m = re.search(r"\{\{- if \$ms\." + knob + r" \}\}\n\{\{- fail \(printf "
                  r"\"([^\"]*)\"", CUDA_T)
    assert m, f"no fail guard on {knob}"
    assert knob in m.group(1) and reason in m.group(1)


def test_h100_overlay():
    serving = H100["servingEngineSpec"]
    assert serving["modelSpec"] == []
    (entry,) = serving["cudaModelSpec"]
    unconsumed = sorted(set(entry) - _knobs(CUDA_T))
    assert not unconsumed, f"values-h100.yaml knobs unconsumed: {unconsumed}"
    assert not set(entry) & TPU_ONLY
    assert "Llama-3.2-3B" in entry["modelURL"]
    assert entry["nodeSelector"] and entry["requestGPU"] == 1
    with open(REPO / "helm" / "values.yaml") as f:
        roots = set(yaml.safe_load(f))
    assert set(H100) <= roots
    for spec in ("routerSpec", "cacheserverSpec"):
        assert H100[spec]["image"]["repository"] == (
            "ghcr.io/example/production-stack-tpu")


def _render_args(entry: dict, container_port: int) -> list[str]:
    """The CUDA template's args for one entry: its literal items, its
    `$ms.<knob> | quote` items and its `if` blocks; a construct that a
    taken branch reaches and this does not know fails the test."""
    block = CUDA_T[CUDA_T.index("          args:\n"):
                   CUDA_T.index("          ports:\n")].splitlines()[1:]
    out: list[str] = []
    taken: list[bool] = []
    for line in (s.strip() for s in block):
        if line == "{{- end }}":
            taken.pop()
            continue
        if m := re.fullmatch(r"\{\{- if \$ms\.(\w+) \}\}", line):
            taken.append(all(taken) and bool(entry.get(m.group(1))))
            continue
        if m := re.fullmatch(r"\{\{- range \$arg := \$ms\.(\w+) \}\}", line):
            # each item quoted as is: its body line is the item
            if all(taken):
                out += [str(a) for a in entry.get(m.group(1)) or ()]
            taken.append(False)
            continue
        if line.startswith("{{- if"):
            assert not all(taken), f"unrendered construct: {line}"
            taken.append(False)
            continue
        if not all(taken) or line.startswith("{{- /*"):
            continue
        if m := re.fullmatch(r'- "([^"{]*)"', line):
            out.append(m.group(1))
        elif m := re.fullmatch(r"- \{\{ \$ms\.(\w+) \| quote \}\}", line):
            out.append(str(entry[m.group(1)]))
        elif "servingEngineSpec.containerPort" in line:
            out.append(str(container_port))
        else:
            raise AssertionError(f"unrendered line: {line}")
    return out


def test_chip_smoke_deploy_argv_is_the_overlays_render():
    (entry,) = H100["servingEngineSpec"]["cudaModelSpec"]
    with open(REPO / "helm" / "values.yaml") as f:
        port = yaml.safe_load(f)["servingEngineSpec"]["containerPort"]
    assert list(chip_smoke.DEPLOY_ARGV) == _render_args(entry, port)
    emitted = set(_flags(CUDA_T))
    used = [a for a in chip_smoke.DEPLOY_ARGV if a.startswith("--")]
    assert set(used) <= emitted
    # the card's overrides: the checkpoint directory and loopback swapped
    # in, the byte tokenizer added (no transformers on the card's machine)
    argv = chip_smoke.deploy_argv("/ckpt", 1234)
    assert argv[argv.index("--model") + 1] == "/ckpt"
    assert argv[argv.index("--port") + 1] == "1234"
    assert argv[argv.index("--host") + 1] == "127.0.0.1"
    assert argv[len(chip_smoke.DEPLOY_ARGV):] == list(
        chip_smoke.DEPLOY_CARD_FLAGS) == ["--tokenizer", "byte"]
    args = build_parser().parse_args(argv)
    assert (args.max_model_len, args.max_num_seqs, args.num_scheduler_steps,
            args.hbm_utilization) == (8192, 16, 8, 0.9)


def _instructions(name: str) -> list[str]:
    """The Dockerfile's instructions, continuation lines joined and
    comments dropped."""
    text = (REPO / "docker" / name).read_text()
    lines = [ln for ln in text.splitlines()
             if not ln.lstrip().startswith("#")]
    return [i.strip() for i in "\n".join(lines).replace(
        "\\\n", " ").splitlines() if i.strip()]


def _modules(instr: list[str]) -> list[str]:
    """Modules the image runs: `python -m <module>` in RUN lines and in
    exec-form ENTRYPOINT / CMD, console scripts mapped to theirs."""
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    mods = []
    for line in instr:
        mods += re.findall(r'python3? -m ([\w.]+)', line)
        mods += re.findall(r'"python3?", "-m", "([\w.]+)"', line)
        if line.startswith(("CMD", "ENTRYPOINT")):
            mods += [scripts[s].split(":")[0]
                     for s in re.findall(r'"([\w-]+)"', line)
                     if s in scripts]
    return mods


@pytest.mark.parametrize("name", DOCKERFILES)
def test_images_hold_the_port_alone(name):
    instr = _instructions(name)
    pips = [ln for ln in instr if "pip install" in ln]
    assert not any("jax" in ln for ln in pips), pips
    for ln in instr:
        if ln.startswith("COPY"):
            assert "--chown" not in ln and "--chmod" not in ln, ln
            assert "production_stack_tpu/" not in ln.split(), ln
    for ln in pips:
        # the project installs without its declared (the JAX package's)
        # dependencies
        if re.search(r"pip install[^&]* \.( |$)", ln):
            assert "--no-deps" in ln, ln
    mods = [m for m in _modules(instr) if m.startswith("production_stack")]
    assert mods
    for mod in mods:
        assert mod.split(".")[0] == "production_stack_tpu_torch", mod
        assert importlib.util.find_spec(mod) is not None, mod


def test_engine_image_builds_the_kernels_into_its_build_dir():
    instr = _instructions("Dockerfile.cuda")
    froms = [i for i, ln in enumerate(instr) if ln.startswith("FROM")]
    assert len(froms) == 2  # a devel build stage, a runtime stage
    assert "-devel-" in instr[froms[0]] and "-runtime-" in instr[froms[1]]
    build, runtime = instr[:froms[1]], instr[froms[1]:]
    env = next(i for i, ln in enumerate(build)
               if "PST_KERNEL_BUILD_DIR=/opt/pst/kernels" in ln)
    step = next(i for i, ln in enumerate(build)
                if "python -m production_stack_tpu_torch.ops.cuda_build"
                in ln)
    assert env < step
    assert any(ln.startswith("ENV") and "PST_KERNEL_BUILD_DIR=/opt/pst/"
               "kernels" in ln for ln in runtime)
    assert "COPY --from=build /opt/pst/kernels /opt/pst/kernels" in runtime
    assert any(re.search(r"pip install --no-cache-dir --no-deps \.", ln)
               for ln in build)
    assert any("torch" in ln and "--index-url" in ln for ln in build)
    hf = tomllib.loads((REPO / "pyproject.toml").read_text())["project"][
        "optional-dependencies"]["hf"]
    pips = " ".join(ln for ln in build if "pip install" in ln)
    assert all(pkg in pips for pkg in hf + ["numpy"])
    assert runtime[-1] == 'CMD ["pst-torch-engine"]'


def test_router_image_installs_nothing():
    instr = _instructions("Dockerfile.torch-router")
    assert instr[0] == "FROM python:3.12-slim"
    assert not any("pip" in ln or "apt-get" in ln for ln in instr)
    assert 'ENTRYPOINT ["python", "-m", "production_stack_tpu_torch.router"]' \
        in instr


def test_image_user_can_write_the_model_volume():
    """The engine image runs as a fixed non-root uid and gid; the
    template's pod fsGroup defaults to that gid (an entry's
    securityContext replaces it), so the init container's download can
    write the freshly provisioned PVC."""
    runtime = _instructions("Dockerfile.cuda")
    runtime = runtime[max(i for i, ln in enumerate(runtime)
                          if ln.startswith("FROM")):]
    users = [ln for ln in runtime if ln.startswith("USER")]
    assert users == ["USER 10001:10001"]
    useradd = next(ln for ln in runtime if "useradd" in ln)
    assert "groupadd --gid 10001 pst" in useradd
    assert "useradd --uid 10001 --gid 10001" in useradd
    line = next(ln for ln in CUDA_T.splitlines()
                if ln.strip().startswith("securityContext:"))
    assert line == ('      securityContext: {{ toYaml ($ms.securityContext | '
                    'default (dict "fsGroup" 10001)) | nindent 8 }}')
    # a pod-level field, beside terminationGracePeriodSeconds
    spec = CUDA_T[CUDA_T.index("    spec:\n"):CUDA_T.index("      containers:")]
    assert line in spec and "terminationGracePeriodSeconds" in spec
    assert "securityContext" not in H100["servingEngineSpec"][
        "cudaModelSpec"][0]


def _no_nvcc_env(tmp_path: Path) -> dict:
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not (Path(d) / "nvcc").exists())
    (tmp_path / "no-cuda").mkdir()
    return {**os.environ, "PATH": path, "CUDA_HOME": str(tmp_path / "no-cuda"),
            "PYTHONPATH": str(REPO),
            "PST_KERNEL_BUILD_DIR": str(tmp_path / "k")}


def test_build_step_fails_loudly_without_nvcc(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "production_stack_tpu_torch.ops.cuda_build"],
        cwd=tmp_path, env=_no_nvcc_env(tmp_path), capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    last = out.stderr.strip().splitlines()[-1]
    assert last.startswith("RuntimeError: no prebuilt kernel library at "
                           f"{tmp_path / 'k'}/libpst_kernels-"), last
    assert "PST_KERNEL_BUILD_DIR" in last and "nvcc not found" in last
    assert not (tmp_path / "k").exists()


def test_present_library_needs_no_compiler_and_writes_nothing(
        monkeypatch, tmp_path):
    kdir = tmp_path / "k"
    kdir.mkdir()
    monkeypatch.setenv("PST_KERNEL_BUILD_DIR", str(kdir))
    lib = cuda_build.library_path()
    lib.write_bytes(b"prebuilt")
    kdir.chmod(stat.S_IRUSR | stat.S_IXUSR)

    def no_nvcc():
        raise AssertionError("build() looked for a compiler")

    monkeypatch.setattr(cuda_build, "nvcc_path", no_nvcc)
    try:
        before = sorted(p.name for p in kdir.iterdir())
        assert cuda_build.build() == lib
        assert sorted(p.name for p in kdir.iterdir()) == before
    finally:
        kdir.chmod(stat.S_IRWXU)


@pytest.fixture(scope="module")
def engine_port():
    with serving() as port:
        yield port


def test_observability_names_on_a_port_engine(engine_port):
    req = urllib.request.Request(
        f"http://127.0.0.1:{engine_port}/v1/completions",
        data=json.dumps({"prompt": "deploy", "max_tokens": 4,
                         "temperature": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.status == 200
    with urllib.request.urlopen(
            f"http://127.0.0.1:{engine_port}/metrics", timeout=60) as r:
        engine = chip_smoke.metric_series(
            *chip_smoke.parse_metrics(r.read().decode()))
    names, router, made = chip_smoke.observability_names()
    assert len(names) >= 40 and "tpu:ragged_rounds_total" in names
    missing = [n for n in names if n not in engine]
    assert not missing, f"the engine's /metrics lacks {missing}"
    # the names excused as the router's are the port router's, not the
    # engine's
    from production_stack_tpu_torch.router.services import metrics_service

    served = chip_smoke.metric_series(*chip_smoke.parse_metrics(
        metrics_service.generate_latest(
            metrics_service.ROUTER_REGISTRY).decode()))
    assert not [n for n in router if n not in served]
    assert not chip_smoke.ROUTER_VLLM_NAMES & engine
    assert chip_smoke.ROUTER_VLLM_NAMES <= set(router)
    assert all(n.startswith(chip_smoke.OBS_MADE_PREFIXES) for n in made)
