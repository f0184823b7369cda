"""A run with its timed path broken underneath comes out not correct.
The harness's look for a card is skipped (``run_cell`` on the CPU); the
rest of a run is driven as the command drives it, on a fixture cell.

Faults a served cell can have: a token altered where it is produced, and
a step that leaves its state unchanged (the KV cache never written). A
mean over half a batch and the exchange between chips belong to training
and to several chips; a one-card serving cell has neither.
"""

import time

import pytest
import torch

from portbench.harness import run_cell
from portbench.manifest import Layout
from portbench.tests import fixtures

pytestmark = pytest.mark.usefixtures("quick_warmup")


def drive(tmp_path, checkout, **kw):
    torch.set_num_threads(2)
    cell = fixtures.make(tmp_path, checkout)
    return run_cell(Layout(tmp_path), cell, 424242, 2.0, False, "cpu",
                    time.time(), lambda m: None, **kw)


def test_sound_run_is_correct(tmp_path, checkout):
    r = drive(tmp_path, checkout)
    assert r["correct"] is True


def test_token_altered_where_produced(tmp_path, checkout, monkeypatch):
    from production_stack_tpu_torch.engine import llm_engine

    orig = llm_engine.LLMEngine._append_token
    calls = {"n": 0}

    def altered(self, seq, token, entry=None):
        calls["n"] += 1
        if calls["n"] % 7 == 0:
            token = (int(token) + 1) % self.runner.model_config.vocab_size
        return orig(self, seq, token, entry)

    monkeypatch.setattr(llm_engine.LLMEngine, "_append_token", altered)
    r = drive(tmp_path, checkout)
    assert r["correct"] is False
    gap = r["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]


def test_state_left_unchanged(tmp_path, checkout, monkeypatch):
    from production_stack_tpu_torch.models import llama

    orig = llama.decoder_layer

    def unchanged(cfg, h, kc, vc, lp, l, **kw):
        # the new rows' K/V land in a copy: the cache stays as it was
        h, _, _ = orig(cfg, h, kc.clone(), vc.clone(), lp, l, **kw)
        return h, kc, vc

    monkeypatch.setattr(llama, "decoder_layer", unchanged)
    r = drive(tmp_path, checkout)
    assert r["correct"] is False
    gap = r["checks"]["max_logit_gap"]
    assert gap["value"] > 10 * gap["limit"]


def test_control_fails_the_limit(tmp_path, checkout):
    """The float8 control, judged by the run's own checks beside a
    sound run at the fixture's size, comes out not correct."""
    r = drive(tmp_path, checkout, control=True)
    limit = r["checks"]["max_logit_gap"]["limit"]
    assert r["correct"] is True
    assert r["control"]["correct"] is False
    assert r["control"]["checks"]["max_logit_gap"]["value"] > 10 * limit


# the fault above at the cell's own size on the card: each layer writes
# its new rows' K/V to row 0, in the pool's null block, so the rows a
# step reads stay as they were (a clone of the cache, as above, does
# not fit there)
UNWRITTEN = """
import sys
sys.path.insert(0, ".")
from portbench.run import cache_env, main
cache_env()
import torch
from production_stack_tpu_torch.models import llama
orig = llama.decoder_layer

def unwritten(cfg, h, kc, vc, lp, l, *, write_slots, **kw):
    return orig(cfg, h, kc, vc, lp, l,
                write_slots=torch.zeros_like(write_slots), **kw)

llama.decoder_layer = unwritten
sys.exit(main(sys.argv[1:]))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7301, 7302, 7303])
def test_state_left_unchanged_at_cell_size(card, checkout, seed):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-c", UNWRITTEN, "--workload",
         "mistral-7b.chat-sessions", "--seed", str(seed), "--seconds", "15",
         "--trace", "0"],
        cwd=checkout, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    gap = result["checks"]["max_logit_gap"]
    print(f"seed {seed}: unwritten KV, max_logit_gap {gap['value']}")
    assert result["correct"] is False
    assert gap["value"] > gap["limit"]
