"""On the card: one short run of each cell comes out correct, and its
result line carries what the contract asks for. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from perfbench import registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in registry.load_benchmark()["workloads"]])
def test_short_run_is_correct(card, cell):
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", cell, "--seed", str(2**31 + 11),
                        "--seconds", "2", "--trace", "0"], cwd=registry.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and "setup_s" in r["metrics"]
