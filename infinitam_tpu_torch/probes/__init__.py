"""The TPU primitive probes of tools/ on the card: probe2 and probe6-13, each
a module of the same name here that runs the script's measurements through
the port's kernels P1-P6 (ops/kernels/probes.py, csrc/probes.cu) and the
torch ops that stand for the script's XLA baselines.

    python -m infinitam_tpu_torch.probes [probe2 ...]

runs them on the card (all nine without names); `--cpu` runs the plain
versions at a reduced size instead. Inputs are made from a seed with numpy.
"""

NAMES = ("probe2", "probe6", "probe7", "probe8", "probe9", "probe10", "probe11", "probe12", "probe13")
