"""Finding a cell's pieces by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration and
traffic mix and lists the metrics. A configuration is the file its entry
names; its `kind` is run by `perfbench/kinds/<kind>.py`; a traffic mix is
`perfbench/traffic/<traffic>.json`; a metric is read by
`perfbench/metrics/<metric name>.py`, whose `read(ctx)` returns the
metric's value, or None where the cell has nothing for it to read. A metric
named as a variant of a quantity, `<quantity>.<variant>` or
`<quantity>_<variant>` (`icp_roofline.fleet`, `fps_fleet`), and with no file
of its own, is read by the quantity's file: the variants differ only in the
cells that report them, which BENCHMARK.json lists. A new cell,
configuration, kind, mix or metric is a new file or a new entry; no file
here names one.

A kind's module exports:

- `KERNELS`: for each phase (`icp`, `integrate`, `raycast`), the substring
  of that phase's hand-kernel names in the device trace (a roofline reads
  the kernels of its cell's kind);
- `COUNTERS`: the names of the per-frame counters the kind records (its
  records' "counters" columns), or none;
- `frames(traffic, seed, dev)` → (true poses [B, N, 4, 4], inputs): what
  each step is fed, made from the seed; the harness hands `inputs` on
  unread;
- `System(cfg, traffic, dev)`: the program. `run_pass(inputs, record)`
  runs a whole pass (host work between steps included) from a state reset
  in full, and returns each step's host issue seconds; `new_record(n)`,
  `graphs()`, `launches_per_replay()`, `build_seconds()`, `outputs()`
  (each lane's map and maps, as `judge` reads them), `close()`, and the
  attributes `lanes`, `n_frames` (frames a pass) and `dev`;
- `judge(cfg, inputs, gt, pass_poses, outputs, counters, img, proj, dev,
  counts)` → (the compared numbers, the frames that failed).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_for(bench: dict, cell_name: str, group: str) -> list:
    """The `end_to_end` or `per_layer` metrics that a cell reports."""
    return [m for m in bench[group] if cell_name in m.get("workloads", [cell_name])]


def reader_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """The file that reads metric `name`: its own, or its quantity's."""
    for stem in (name, name.rsplit(".", 1)[0], name.rsplit("_", 1)[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} under {bench_dir / 'metrics'}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read(ctx)` function of metric `name`."""
    return _load(reader_file(name, bench_dir), f"perfbench_metric_{name.replace('.', '_')}").read


def kind_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    path = bench_dir / "kinds" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no module for configuration kind {name!r} under {bench_dir / 'kinds'}")
    return path


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """The module of configuration kind `name` (`perfbench/kinds/<name>.py`)."""
    return _load(kind_file(name, bench_dir), f"perfbench_kind_{name}")
