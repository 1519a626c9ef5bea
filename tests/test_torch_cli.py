"""The port's headless runner (`python -m infinitam_tpu_torch.apps.cli`),
in-process on the CPU at 80×60: the synthetic run with its raycast dumps,
the PGM fixture through the file reader, record and replay, the Ren
tracker with the mesh written after the loop, and the setting that still
raises before the first frame.
"""

import os

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.apps import cli
from infinitam_tpu_torch.utils.image_io import read_image

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "replay")
SMALL = ["--width", "80", "--height", "60", "--voxel-size", "0.025", "--mu", "0.1", "--cpu"]

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)


def test_cli_synthetic_run_writes_renders(tmp_path, capsys):
    mask = str(tmp_path / "r_%04i.png")
    assert cli.main(["--synthetic", "--frames", "3", "--out-render", mask, *SMALL]) == 0
    out = capsys.readouterr().out
    assert "processed 3 frames" in out and "frame    3:" in out
    shots = [read_image(mask.replace("%04i", f"{i:04d}")) for i in (1, 2, 3)]
    assert all(s.shape == (60, 80, 3) and s.dtype == np.uint8 for s in shots)
    assert (shots[-1] > 0).mean() > 0.3
    assert not os.path.exists(mask.replace("%04i", "0004"))


def test_cli_replays_the_pgm_fixture(capsys):
    """Raw mm depth through the calibration's affine model; the statistics
    line comes every 10 frames."""
    args = [os.path.join(FIX, "calib.txt"), "", os.path.join(FIX, "depth_%04i.pgm"), "--frames", "20", *SMALL]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "processed 10 frames" in out and "frame   10:" in out
    inliers = int(out.split("inliers=")[1].split()[0])
    assert inliers > 500


def test_cli_records_and_replays(tmp_path, capsys):
    """--tracker wicp runs (unweighted without the sensor-noise model, as in
    the JAX package); its recorded input replays frame for frame."""
    rec = str(tmp_path / "rec")
    assert cli.main(["--synthetic", "--frames", "2", "--tracker", "wicp", "--record", rec, *SMALL]) == 0
    assert sorted(os.listdir(rec)) == ["depth_0000.pgm", "depth_0001.pgm"]
    assert cli.main(["--replay", rec, *SMALL]) == 0
    out = capsys.readouterr().out
    assert out.count("processed 2 frames") == 2


@pytest.mark.parametrize("flags", [["--out-mesh", "scene.stl"], ["--tracker", "ren"], []],
                         ids=["out-mesh", "ren", "swapping"])
def test_cli_refuses_unported_settings_before_any_frame(tmp_path, capsys, flags):
    """--swapping (ROADMAP Queue 1 item 13) raises before the first frame,
    alone or with the other flags: no frame, no render and no mesh."""
    mask = str(tmp_path / "r_%04i.png")
    flags = [tmp_path / f if f.endswith(".stl") else f for f in flags]
    with pytest.raises(NotImplementedError, match="item 13"):
        cli.main(["--synthetic", "--frames", "2", "--out-render", mask, "--swapping", *map(str, flags), *SMALL])
    assert "frame" not in capsys.readouterr().out
    assert not os.listdir(tmp_path)


def test_cli_runs_ren_and_writes_the_mesh(tmp_path, capsys):
    """--tracker ren with --out-mesh: the mesh is written after the loop, an
    OBJ for a .obj path."""
    out_mesh = str(tmp_path / "scene.obj")
    assert cli.main(["--synthetic", "--frames", "3", "--tracker", "ren", "--out-mesh", out_mesh, *SMALL]) == 0
    out = capsys.readouterr().out
    assert "processed 3 frames" in out and f"mesh saved to {out_mesh}" in out
    # Ren reports ICP's inliers, counted at level 1 (40×30 pixels)
    inliers = int(out.split("inliers=")[1].split()[0])
    assert inliers > 500
    lines = open(out_mesh).read().split("\n")
    n_v, n_f = sum(ln.startswith("v ") for ln in lines), sum(ln.startswith("f ") for ln in lines)
    assert n_f > 1000 and n_v == 3 * n_f
