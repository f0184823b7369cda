"""The control on the card, at the cell's own size: a short run of the
cell judges the program and, by the same checks at the same served
positions, the float8 reference in its place; the first comes out
correct and the second not. Run on the card with

    python -m pytest portbench/tests/test_portbench_control.py -m cuda
"""

import json
import subprocess
import sys

import pytest

CELLS = ["mistral-7b.chat-sessions"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, checkout, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "20251018", "--seconds", "15", "--trace", "0", "--control", "1"],
        cwd=checkout, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["control"]["correct"] is False
    gap = result["control"]["checks"]["max_logit_gap"]
    assert gap["value"] > gap["limit"]
