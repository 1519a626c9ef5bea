"""python -m infinitam_tpu_torch.probes [--cpu] [NAME ...]

Runs the named probes (probe2, probe6 … probe13; all nine without names)
on the card, each printing its measurements through the port's kernels
P1-P6 and its library yardsticks. Without a card it raises: `--cpu` runs
the plain versions at a reduced size instead (host times only).
"""

from __future__ import annotations

import argparse
import importlib

import torch

from infinitam_tpu_torch.probes import NAMES


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m infinitam_tpu_torch.probes", description=__doc__.split("\n\n")[1])
    ap.add_argument("names", nargs="*", metavar="NAME", help=f"probes to run, of {', '.join(NAMES)} (default all)")
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU at a reduced size")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in NAMES]
    if unknown:
        ap.error(f"unknown probes {unknown}; known: {', '.join(NAMES)}")
    if args.cpu:
        device = torch.device("cpu")
        print("device: cpu (plain versions at a reduced size; host times)", flush=True)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the probes run on a CUDA device and none is available (--cpu runs the plain "
                               "versions on the CPU)")
        device = torch.device("cuda", torch.cuda.current_device())
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    results = {}
    for name in args.names or NAMES:
        print(f"--- {name}", flush=True)
        results[name] = importlib.import_module(f"infinitam_tpu_torch.probes.{name}").run(device, small=args.cpu)
    return results


if __name__ == "__main__":
    main()
