"""One drive of the harness loop, called as a function, against the
port's engine on the CPU, from a fixture benchmark that adds a
configuration, a mix, a cell and a metric as files alone."""

import hashlib
import time

import pytest
import torch

from portbench import check
from portbench.harness import run_cell
from portbench.manifest import Layout
from portbench.tests import fixtures

pytestmark = pytest.mark.usefixtures("quick_warmup")


def digest(root):
    h = hashlib.sha256()
    for p in sorted((root / "portbench").rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts \
                and ".build" not in p.parts:
            h.update(p.as_posix().encode() + p.read_bytes())
    h.update((root / "BENCHMARK.json").read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("family,trace", [("pst-tiny-debug", False),
                                          ("pst-tiny-debug", True),
                                          ("qwen2", False)])
def test_drive_fixture_cell(tmp_path, checkout, family, trace):
    torch.set_num_threads(2)
    before = digest(checkout)
    cell = fixtures.make(tmp_path, checkout, family)
    logs = []
    result = run_cell(Layout(tmp_path), cell, 2**31 + 12345, 3.0, trace,
                      "cpu", time.time(), logs.append)
    assert digest(checkout) == before  # nothing of the harness edited
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 5
    assert list(result)[-1] == "checks"
    m = result["metrics"]
    if trace:
        assert m["fixture_first_tokens"]["value"] > 0
        assert 0 < m["prefix_hit_share"]["value"] < 100
        assert m["queue_wait_p95_ms"]["value"] >= 0
        assert 0 < m["kv_use_share"]["value"] < 100
        assert m["mfu.ttft"]["unit"] == "%"
        assert result["device"]["window_s"] > 0
        assert "breakdown" in result
        assert "ttft_p95_ms" not in m
    else:
        assert set(m) == {"ttft_p95_ms", "tpot_p95_ms", "setup_s"}
        assert m["ttft_p95_ms"]["value"] > 0
        assert m["setup_s"]["value"] > 1.0  # warm-up and ramp are set-up
    assert result["checks"]["checked_requests"] == {
        "value": check.REQUESTS, "limit": check.REQUESTS, "at_least": True}
    assert result["checks"]["max_logit_gap"]["value"] <= 1e-3
    assert any("warm-up" in line for line in logs)


def test_same_seed_same_requests(tmp_path, checkout):
    """The plan's requests do not depend on the run's timing."""
    from portbench.generator import Plan

    cell = fixtures.make(tmp_path, checkout)
    lay = Layout(tmp_path)
    mix = lay.traffic(lay.workload(cell)["traffic"])
    a = [Plan(mix, 7, 384).next_session() for _ in range(5)]
    b = [Plan(mix, 7, 384).next_session() for _ in range(5)]
    assert [t.user_ids for s in a for t in s.turns] == [
        t.user_ids for s in b for t in s.turns]
