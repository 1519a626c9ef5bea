"""The harness finds each piece by name, and a new configuration, traffic
mix, metric and configuration kind added as files only (in a temporary
copy) are taken without an edit to any file there. Without a card a run prints no result and exits
non-zero, and so do a checkout that holds only the benchmark and a card
that never leaves its slow launch latency."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import tiny_config, tiny_traffic
from perfbench import registry, run


def test_every_cell_finds_its_pieces():
    bench = registry.load_benchmark()
    for cell in bench["workloads"]:
        cfg = registry.config(bench, cell["config"])
        assert registry.kind_file(cfg["kind"]).parent == registry.BENCH_DIR / "kinds"
        assert "limits" in cfg and "gates" in cfg
        assert registry.traffic(cell["traffic"])["frames"] > 0
        for group in ("end_to_end", "per_layer"):
            for m in registry.metrics_for(bench, cell["name"], group):
                assert callable(registry.reader(m["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert registry.reader_file(m["name"]).parent == registry.BENCH_DIR / "metrics"


@pytest.mark.parametrize("name,stem", [("fps", "fps"), ("fps_dense", "fps"), ("fps_fleet", "fps"),
                                       ("setup_s", "setup_s"), ("icp_roofline.dense", "icp_roofline"),
                                       ("itpu_launches_per_frame.fleet", "itpu_launches_per_frame"),
                                       ("own_name.dense", "own_name.dense")])
def test_variant_is_read_by_its_quantity_unless_it_has_a_file(tmp_path, name, stem):
    shutil.copytree(registry.BENCH_DIR / "metrics", tmp_path / "metrics", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "metrics" / "own_name.dense.py").write_text("def read(ctx):\n    return 1.0\n")
    assert registry.reader_file(name, tmp_path) == tmp_path / "metrics" / f"{stem}.py"
    with pytest.raises(FileNotFoundError):
        registry.reader_file("no_such.metric", tmp_path)


def test_new_pieces_added_as_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH_DIR, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    (root / "perfbench" / "configs" / "tiny_hash.json").write_text(json.dumps(tiny_config("hash")))
    (root / "perfbench" / "traffic" / "tiny_desk.json").write_text(json.dumps(tiny_traffic(2, frames=4)))
    (root / "perfbench" / "metrics" / "frames_done.py").write_text("def read(ctx):\n    return ctx.frames\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_hash", "source": "a test", "file": "perfbench/configs/tiny_hash.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.fleet", "config": "tiny_hash", "traffic": "tiny_desk", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher", "bound": 0.01,
                                "source": "host_clock", "workloads": ["tiny.fleet"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = registry.load_benchmark(root)
    cell = registry.cell(bench, "tiny.fleet")
    cfg = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root / "perfbench")
    e2e = registry.metrics_for(bench, "tiny.fleet", "end_to_end")
    readers = {m["name"]: registry.reader(m["name"], root / "perfbench") for m in e2e}
    assert {m["name"] for m in e2e} == {"frames_done", "peak_mem_gib", "setup_s"}
    r = run.run_cell(cell, cfg, traffic, 7, 0.1, False, "cpu", e2e, [], readers)
    assert r["correct"], r["checks"]
    assert r["metrics"]["frames_done"]["value"] == r["attempted"] > 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_kind_exports_what_the_harness_reads():
    for path in sorted((registry.BENCH_DIR / "kinds").glob("*.py")):
        mod = registry.kind(path.stem)
        assert set(mod.KERNELS) <= {"icp", "integrate", "raycast"} and isinstance(mod.COUNTERS, tuple)
        assert all(callable(getattr(mod, f)) for f in ("frames", "System", "judge"))
    with pytest.raises(FileNotFoundError):
        registry.kind_file("no_such_kind")


# A kind added as a file: the hash step fed a second input a frame (a gain
# drawn from the seed), whose host tally between steps is reset every pass
# and judged with the map.
TOY_KIND = '''
from pathlib import Path

import torch

from perfbench import registry

_hash = registry.kind("hash", Path(__file__).resolve().parents[1])
KERNELS = _hash.KERNELS
COUNTERS = _hash.COUNTERS


def frames(traffic, seed, dev):
    gt, depths = _hash.frames(traffic, seed, dev)
    gains = 0.5 + torch.rand(traffic["frames"], generator=torch.Generator().manual_seed(seed % 2**63))
    return gt, (depths, gains)


class System(_hash.System):
    def run_pass(self, inputs, record=None):
        depths, gains = inputs
        self.reset()
        self.tally = []
        issue = []
        for i in range(self.n_frames):
            issue.append(self.frame(depths, i, record))
            self.tally.append(float(gains[i]))
        return issue

    def outputs(self):
        return super().outputs(), list(self.tally)


def judge(cfg, inputs, gt, pass_poses, outputs, counters, img, proj, dev, counts=None):
    (depths, gains), (maps, tally) = inputs, outputs
    nums, failed = _hash.judge(cfg, depths, gt, pass_poses, maps, counters, img, proj, dev, counts=counts)
    nums["tally_gap"] = abs(sum(tally) - float(gains.sum()))
    return nums, failed
'''


def test_new_kind_added_as_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(registry.BENCH_DIR, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    cfg = tiny_config("hash")
    cfg["kind"] = "toy"
    cfg["limits"]["tally_gap"] = 1e-4
    (root / "perfbench" / "configs" / "tiny_toy.json").write_text(json.dumps(cfg))
    (root / "perfbench" / "kinds" / "toy.py").write_text(TOY_KIND)
    (root / "perfbench" / "traffic" / "tiny_desk.json").write_text(json.dumps(tiny_traffic(1, frames=4)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_toy", "source": "a test", "file": "perfbench/configs/tiny_toy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.toy", "config": "tiny_toy", "traffic": "tiny_desk", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = registry.load_benchmark(root)
    cell = registry.cell(bench, "tiny.toy")
    cfg = registry.config(bench, cell["config"], root)
    traffic = registry.traffic(cell["traffic"], root / "perfbench")
    kind = registry.kind(cfg["kind"], root / "perfbench")
    e2e = registry.metrics_for(bench, "tiny.toy", "end_to_end")
    readers = {m["name"]: registry.reader(m["name"], root / "perfbench") for m in e2e}
    r = run.run_cell(cell, cfg, traffic, 2**33 + 21, 0.1, False, "cpu", e2e, [], readers, kind)
    assert r["correct"], r["checks"]
    assert r["checks"]["tally_gap"]["value"] < 1e-4 and r["checks"]["cap_counters"]["value"] == 0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "hash5mm.replay", "--seed",
                        str(2**32 + 1), "--seconds", "1", "--trace", "0"], cwd=registry.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_checkout_of_only_the_benchmark_gives_no_result(tmp_path):
    shutil.copytree(registry.BENCH_DIR, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "hash5mm.replay", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""



def test_card_that_never_settles_gives_no_result(monkeypatch, capsys):
    def never_settles(*a, **k):
        raise run.CardNotSettled("the card kept its slow launch latency")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "point_caches", lambda: None)
    monkeypatch.setattr(run, "run_cell", never_settles)
    rc = run.main(["--workload", "hash5mm.replay", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out.strip() == ""
    assert "no result" in out.err and "slow launch latency" in out.err
