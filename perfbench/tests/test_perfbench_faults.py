"""A whole run on the CPU at a tiny size (the look for a card skipped) with
the timed path broken underneath: `correct` has to come out false for each
fault a cell can have — a step that returns its state unchanged, half of a
batch's lanes left out, and an answer (a pose) altered where it is
produced. The same run unbroken comes out correct."""

from __future__ import annotations

import pytest
import torch

from conftest import tiny_config, tiny_traffic
from infinitam_tpu_torch.engine import captured
from perfbench import registry, run
from perfbench.system import System

SEED = 2**33 + 5


def run_tiny(kind, lanes):
    bench = registry.load_benchmark()
    e2e = bench["end_to_end"]
    readers = {m["name"]: registry.reader(m["name"]) for m in e2e}
    cell = {"name": "tiny", "chips": 1}
    return run.run_cell(cell, tiny_config(kind), tiny_traffic(lanes, frames=5), SEED, 0.1, False, "cpu", e2e, [],
                        readers)


@pytest.mark.parametrize("kind,lanes", [("hash", 1), ("dense", 1), ("hash", 2), ("dense", 2)])
def test_sound_run_is_correct(kind, lanes):
    r = run_tiny(kind, lanes)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert list(r["checks"])[-1] and list(r)[-1] == "checks"


@pytest.mark.parametrize("kind,lanes", [("hash", 1), ("dense", 1), ("hash", 2), ("dense", 2)])
def test_state_returned_unchanged(monkeypatch, kind, lanes):
    real = captured.run

    def unchanged(name, static, body, state, frame):
        kept = captured.tree_map(torch.clone, captured.unalias(state))
        state, out = real(name, static, body, state, frame)
        captured.refill(state, kept)
        return state, out

    monkeypatch.setattr(captured, "run", unchanged)
    assert not run_tiny(kind, lanes)["correct"]


@pytest.mark.parametrize("kind", ["hash", "dense"])
def test_half_the_batch_left_out(monkeypatch, kind):
    real = System.step

    def half(self, depth):
        kept = captured.tree_map(lambda t: t[self.lanes // 2:].clone(), self.state)
        out = real(self, depth)
        for a, b in zip(captured.leaves(self.state), captured.leaves(kept)):
            a[self.lanes // 2:].copy_(b)
        return out

    monkeypatch.setattr(System, "step", half)
    r = run_tiny(kind, 2)
    assert not r["correct"]


@pytest.mark.parametrize("kind", ["hash", "dense"])
def test_pose_altered_where_produced(monkeypatch, kind):
    real = System.step
    calls = {"n": 0}

    def altered(self, depth):
        out = real(self, depth)
        calls["n"] += 1
        if calls["n"] % 5 == 3:  # the fourth frame of every pass, 2 mm along x
            self.state[-1].pose[..., 0, 3] += 0.002
        return out

    monkeypatch.setattr(System, "step", altered)
    r = run_tiny(kind, 1)
    assert not r["correct"]
    assert r["failed"] > 0
