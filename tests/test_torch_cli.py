"""The port's headless runner (`python -m infinitam_tpu_torch.apps.cli`)
and orbit viewer (`python -m infinitam_tpu_torch.apps.viewer`), in-process
on the CPU at 80×60: the synthetic run with its raycast dumps, the PGM
fixture through the file reader, record and replay, the Ren tracker with the
mesh written after the loop, --swapping with each of those, and the viewer's
orbit from a synthetic replay and from a snapshot.
"""

import os

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.apps import cli, viewer
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
    """--swapping, which the port refused until it ported swapping, runs, alone
    or with the other flags: every frame is processed and rendered, and the
    mesh (of the resident blocks) is written after the loop."""
    mask = str(tmp_path / "r_%04i.png")
    flags = [tmp_path / f if f.endswith(".stl") else f for f in flags]
    assert cli.main(["--synthetic", "--frames", "2", "--out-render", mask, "--swapping", *map(str, flags), *SMALL]) == 0
    out = capsys.readouterr().out
    assert "processed 2 frames" in out and "frame    2:" in out
    assert int(out.split("inliers=")[1].split()[0]) > 500
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(["r_0001.png", "r_0002.png"] + (["scene.stl"] if flags and str(flags[0]) == "--out-mesh"
                                                           else []))
    assert (read_image(mask.replace("%04i", "0002")) > 0).mean() > 0.3


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


@pytest.mark.parametrize("source", ["synthetic", "snapshot"])
def test_viewer_writes_an_orbit(tmp_path, capsys, source):
    """Two freeview renders on an orbit around the scene and the HTML strip,
    from a 3-frame synthetic replay or from a swapping engine's snapshot
    (written by save_engine after 3 frames; the viewer renders its resident
    blocks)."""
    from infinitam_tpu_torch.calib import default_calib
    from infinitam_tpu_torch.config import SceneParams, Settings, SwappingMode
    from infinitam_tpu_torch.engine.main_engine import MainEngine
    from infinitam_tpu_torch.io import synth
    from infinitam_tpu_torch.utils import checkpoint

    flags = ["--synthetic", "--frames", "3"]
    if source == "snapshot":
        settings = Settings(scene=SceneParams(voxel_size=0.025, mu=0.1), swapping_mode=SwappingMode.ENABLED)
        calib = default_calib(80, 60)
        eng = MainEngine(settings, calib, (60, 80), device="cpu")
        src = synth.SyntheticSource(calib, n_frames=3, img_size=(60, 80), device="cpu")
        for _ in range(3):
            eng.process_frame(metric_depth=src.get_images()[0])
        checkpoint.save_engine(str(tmp_path / "snap.npz"), eng)
        flags = ["--snapshot", str(tmp_path / "snap.npz")]
    out_dir = tmp_path / "orbit"
    assert viewer.main([*flags, "--orbit", "2", "--out", str(out_dir), *SMALL]) == 0
    out = capsys.readouterr().out
    assert ("restored snapshot at frame 3" in out) == (source == "snapshot")
    assert sorted(os.listdir(out_dir)) == ["index.html", "orbit_0000.png", "orbit_0001.png"]
    shots = [read_image(str(out_dir / f"orbit_{k:04d}.png")) for k in range(2)]
    assert all(s.shape == (60, 80, 3) for s in shots) and max((s > 0).mean() for s in shots) > 0.1
    assert open(out_dir / "index.html").read().count("<img") == 2
