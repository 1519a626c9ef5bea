"""Finding a cell's pieces by name.

`BENCHMARK.json` at the checkout's root names each cell's configuration and
traffic mix and lists the metrics. A configuration is the file its entry
names; a traffic mix is `perfbench/traffic/<traffic>.json`; a metric is read
by `perfbench/metrics/<metric name>.py`, whose `read(ctx)` returns the
metric's value, or None where the cell has nothing for it to read. A metric
named as a variant of a quantity, `<quantity>.<variant>` or
`<quantity>_<variant>` (`icp_roofline.dense`, `fps_dense`), and with no file
of its own, is read by the quantity's file: the variants differ only in the
cells that report them, which BENCHMARK.json lists. A new cell,
configuration, mix or metric is a new file or a new entry; no file here
names one.
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


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The `read(ctx)` function of metric `name`."""
    path = reader_file(name, bench_dir)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
