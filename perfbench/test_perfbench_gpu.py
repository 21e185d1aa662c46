"""One short run of a cell on the card, as the benchmark's command runs
it; skips where there is no card (decided inside the test)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.gpu
def test_a_two_second_cell_runs_and_is_correct():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on one")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "gpt2m.ligo",
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, proc.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["ligo_tok_s"]["value"] > 0
    assert result["metrics"]["setup_s"]["value"] > 0


def test_without_a_card_the_command_reports_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "gpt2m.ligo",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
