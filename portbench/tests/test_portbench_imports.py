"""Nothing the command imports is JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's)."""

import os
import subprocess
import sys

from portbench.manifest import FORBIDDEN, forbidden_modules


def test_whole_top_level_names():
    assert forbidden_modules(["production_stack_tpu_torch",
                              "production_stack_tpu_torch.engine",
                              "jaxtyping", "flaxen", "portbench"]) == []
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client",
                              "flax.linen", "production_stack_tpu",
                              "production_stack_tpu.engine"]) == sorted([
        "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
        "production_stack_tpu", "production_stack_tpu.engine"])
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax",
                              "production_stack_tpu"}


def test_command_loads_no_jax(checkout):
    code = (
        "import sys; sys.argv = ['run.py']\n"
        "import runpy\n"
        "mod = runpy.run_path('portbench/run.py', run_name='portbench_run')\n"
        "mod['cache_env']()\n"
        f"sys.path.insert(0, {str(checkout)!r})\n"
        "import portbench.harness, portbench.sweep, portbench.check\n"
        "import production_stack_tpu_torch.engine.async_engine\n"
        "import production_stack_tpu_torch.utils.chip_guard\n"
        "from portbench.manifest import forbidden_modules\n"
        "print(forbidden_modules(list(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_torch_alone(checkout):
    for f in (checkout / "portbench" / "reference").glob("*.py"):
        text = f.read_text()
        assert "production_stack_tpu" not in text
        assert "import jax" not in text and "from jax" not in text


def test_without_the_port_it_prints_nothing(tmp_path, checkout):
    """In a directory holding only BENCHMARK.json and portbench/, the
    command fails and prints no result."""
    import shutil

    shutil.copy(checkout / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(checkout / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".build"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mistral-7b.chat-sessions", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
