"""The benchmark of the PyTorch and CUDA port (infinitam_tpu_torch).

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. A cell's
configuration names its kind, and the kind's module (perfbench/kinds/,
found by perfbench/registry.py) makes its inputs, runs its program and
judges its output; this file names no kind. One run:

1. Set-up (`setup_s`): the imports; the CUDA context; the cell's inputs
   made on the card from the seed (the kind's `frames`); the program's
   live state and a fresh copy; one whole pass of the traffic,
   which builds the kernel library on a checkout's first run and captures
   the frame step's graph, and two more passes. Every cache that a later
   run reuses lies at a fixed path inside the checkout (`build/kernels/`
   for the port's nvcc library, `.perfbench_cache/` for Python's bytecode
   and what the CUDA driver and torch compile at first use). Then, outside
   `setup_s`, passes until the card has left its first launch-latency
   state (NODE_US_FAST); a card that has not left it after SETTLE_S gives
   no result, since its window would time the slow state. The result's
   `device` keeps the settle's seconds and the latency before and after
   the window.
2. The window: passes of the sequence, each from a fresh map, until
   `--seconds` have gone; nothing may compile in it (a graph captured or a
   library built inside it fails the run). End-to-end metrics: frames/s
   over all frames and all the window's time, the peak device memory and
   the set-up seconds.
3. With `--trace 1`, one more pass under the profiler, read into the cell's
   per-layer metrics (perfbench/metrics/).
4. The check: the last pass's poses, map, maps and counters against the
   plain reference (the kind's `judge`), once the program's state is
   freed.

Earlier stderr lines give set-up step by step, the card's clocks, power and
temperature sampled beside the window, and each pass's device seconds. The
last stderr lines, and the result's last key, give each compared number
beside its limit. The last stdout line is the result as JSON.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "infinitam_tpu")
WARM_PASSES = 2
# The card's launch latency of a graph's kernel node has two steady states:
# ~1.2 µs at first and ~1.0 µs once the card switches, at a random moment
# (0 to 30 s into the load as measured so; the cause is unknown), and it
# stays there (a frame of ~6,200 nodes runs 15% faster, one of ~3,000
# 4%). Before the window, passes run until a graph of NODE_PROBE tiny
# kernels reads under NODE_US_FAST a node, at most SETTLE_S.
NODE_PROBE = 2000
NODE_US_FAST = 1.09
SETTLE_S = 150.0


class CardNotSettled(RuntimeError):
    """The card kept its slow launch latency for all of SETTLE_S."""


def point_caches() -> None:
    """Fixed cache directories inside the checkout, set before torch is
    imported: Python's bytecode of every module imported from here on, also
    where the environment asks for none (an installation without its own
    bytecode compiles each module again in every process), the driver's cache of kernels compiled from PTX, and
    torch's and Triton's build caches."""
    sys.pycache_prefix = str(CACHE / "pyc")
    sys.dont_write_bytecode = False
    for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    os.environ["CUDA_CACHE_MAXSIZE"] = str(4 * 2**30)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class ClockSampler:
    """nvidia-smi's clocks, power draw, temperature, performance state and
    clock-event reasons of one card, sampled every 250 ms while it runs."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu", "pstate", "clocks_throttle_reasons.active",
              "power.limit")

    def __init__(self, index: int):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}", "--format=csv,noheader,nounits", "-lms", "250",
                 "-i", str(index)], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def stop(self) -> dict:
        """Each field's series over the window, one value a sample."""
        if self.proc is None:
            return {}
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = [[x.strip() for x in line.split(",")] for line in out.splitlines()]
        rows = [r for r in rows if len(r) == len(self.FIELDS)]
        series = {}
        for name, col in zip(self.FIELDS, zip(*rows)) if rows else ():
            try:
                series[name] = [float(x) for x in col]
            except ValueError:
                series[name] = list(col)
        return series


class NodeLatency:
    """A captured graph of NODE_PROBE one-element adds: its replay time a
    node is the card's launch latency of a graph's kernel node."""

    def __init__(self, dev):
        import torch

        self.x = torch.zeros(1, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            self.x.add_(1)
        torch.cuda.synchronize(dev)
        with torch.cuda.graph(self.graph, stream=stream):
            for _ in range(NODE_PROBE):
                self.x.add_(1)

    def read_us(self) -> float:
        """The least of three replays' time a node, in µs."""
        import torch

        out = []
        for _ in range(3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            self.graph.replay()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) * 1e3 / NODE_PROBE)
        return min(out)


class Context:
    """What the metric readers read (perfbench/metrics/)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def roofline(self, kernel: str):
        """The share (%) of its least time that the cell's kind's `kernel`
        kernels took in the traced pass; None where there is nothing to read."""
        from perfbench import roofline

        if not self.counts or self.trace is None or kernel not in self.kernels:
            return None
        device_s = self.trace.seconds_of(self.kernels[kernel]) / self.traced_steps
        least = roofline.least_per_step(self.counts, kernel)
        if device_s <= 0 or least <= 0:
            return None
        return 100.0 * least / device_s


def run_cell(cell: dict, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
             e2e: list, per_layer: list, readers: dict, kind=None) -> dict:
    """One run of a cell (module docstring) by its configuration's kind's
    module (perfbench/kinds/; by default the one the registry finds);
    returns the result's dict."""
    import torch

    from perfbench import compare, registry
    from perfbench import trace as tracing

    if kind is None:
        kind = registry.kind(cfg["kind"])

    steps = {"imports_s": time.perf_counter() - T_START}
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.perf_counter()
    if cuda:
        torch.zeros(1, device=dev)
        sync()
    steps["context_s"] = time.perf_counter() - t

    t = time.perf_counter()
    lanes, n = traffic["lanes"], traffic["frames"]
    img, proj = tuple(traffic["image"]), traffic["intrinsics"]
    gt, inputs = kind.frames(traffic, seed, dev)
    sync()
    steps["frames_s"] = time.perf_counter() - t

    t = time.perf_counter()
    system = kind.System(cfg, traffic, dev)
    sync()
    steps["state_s"] = time.perf_counter() - t

    t = time.perf_counter()
    system.run_pass(inputs)
    sync()
    steps["first_pass_s"] = time.perf_counter() - t
    steps["of_which_kernel_build_s"] = system.build_seconds()
    steps["of_which_capture_s"] = sum(c for _n, c in system.graphs())
    # two more passes, recorded as the window records them
    t = time.perf_counter()
    for _ in range(WARM_PASSES):
        system.run_pass(inputs, system.new_record(n))
    sync()
    steps["warm_passes_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    log("setup " + json.dumps(steps | {"setup_s": setup_s}))

    # the card's state (NODE_US_FAST): passes until it has switched, which
    # took a random 0-30 s in every run measured, so it is kept out of
    # setup_s, logged on a line of its own and kept in the result's device
    node = NodeLatency(dev) if cuda else None
    settle = {}
    if cuda:
        t = time.perf_counter()
        reads = [node.read_us()]
        while reads[-1] >= NODE_US_FAST and time.perf_counter() - t < SETTLE_S:
            system.run_pass(inputs, system.new_record(n))
            sync()
            reads.append(node.read_us())
        settle = {"settle_s": time.perf_counter() - t, "settle_passes": len(reads) - 1, "node_us": reads[-1]}
        log("card_settle " + json.dumps(settle | {"node_us_reads": reads}))
        if reads[-1] >= NODE_US_FAST:
            raise CardNotSettled(f"the card's graph-node latency read {reads[-1]:.3f} µs (switched: under "
                                 f"{NODE_US_FAST}) after {SETTLE_S} s of passes")

    # ----- the window -------------------------------------------------------
    graphs0, build0 = system.graphs(), system.build_seconds()
    sampler = ClockSampler(dev.index or 0) if cuda else None
    records, issue, ends = [], [], []
    sync()
    start = torch.cuda.Event(enable_timing=True) if cuda else None
    if cuda:
        start.record()
    t0 = time.perf_counter()
    try:
        while True:
            rec = system.new_record(n)
            issue += system.run_pass(inputs, rec)
            records.append(rec)
            if cuda:
                ends.append(torch.cuda.Event(enable_timing=True))
                ends[-1].record()
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - t0
    finally:
        clocks = sampler.stop() if sampler else {}
    node_after = node.read_us() if cuda else None
    if system.graphs() != graphs0 or system.build_seconds() != build0:
        raise RuntimeError("a graph was captured or the kernel library built inside the window")
    frames = len(records) * n * lanes
    if cuda:
        marks = [start] + ends
        pass_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        log("window " + json.dumps({"passes": len(records), "window_s": window_s, "pass_s": pass_s,
                                    "node_us_after": node_after, "card_every_250ms": clocks}))
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    dtrace = None
    if trace:
        rec = system.new_record(n)
        dtrace = tracing.profile(lambda: system.run_pass(inputs, rec), os.environ.get("TMPDIR", str(ROOT)))
        records.append(rec)
    launches = system.launches_per_replay()

    # ----- the check --------------------------------------------------------
    outputs = system.outputs()
    poses = torch.stack([r["poses"] for r in records]).cpu().numpy()
    counters = torch.stack([r["counters"] for r in records]).cpu().numpy() if kind.COUNTERS else None
    system.close()
    del system
    t = time.perf_counter()
    counts = [] if trace else None
    nums, failed = kind.judge(cfg, inputs, gt, poses, outputs, counters, img, proj, dev, counts=counts)
    log(f"reference_s {time.perf_counter() - t}")
    limits = compare.limits_of(cfg)
    ok = compare.verdict(nums, limits)

    ctx = Context(lanes=lanes, frames=frames, window_s=window_s, peak_bytes=peak, setup_s=setup_s,
                  issue_ms=1e3 * sum(issue) / len(issue), trace=dtrace, traced_steps=n,
                  traced_frames=n * lanes, launches_per_replay=launches, counts=counts, kernels=kind.KERNELS)
    metrics = {}
    for m in (per_layer if trace else e2e):
        v = readers[m["name"]](ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": ok, "attempted": frames, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": cell["chips"], "memory_peak_bytes": peak}}
    result["device"].update(settle)
    if node_after is not None:
        result["device"]["node_us_after"] = node_after
    if dtrace is not None:
        busy, _gaps = dtrace.busy_and_gaps()
        result["device"].update(busy_s=busy, window_s=dtrace.span_s)
        result["breakdown"] = {"device_ops": dtrace.top_ops(), "idle_gaps": dtrace.top_gaps()}
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]} for k in nums}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m perfbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    point_caches()

    from perfbench import registry

    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    e2e = registry.metrics_for(bench, cell["name"], "end_to_end")
    per_layer = registry.metrics_for(bench, cell["name"], "per_layer")
    readers = {m["name"]: registry.reader(m["name"]) for m in e2e + per_layer}

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no result: the cell needs {cell['chips']} CUDA device(s), "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = registry.kind(cfg["kind"])
    try:
        result = run_cell(cell, cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda:0", e2e, per_layer,
                          readers, kind)
    except CardNotSettled as e:
        log(f"no result: {e}")
        return 4
    found = forbidden_modules()
    if found:
        log(f"no result: modules of JAX or the JAX package are loaded: {found}")
        return 3
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
