"""The port's bench (infinitam_tpu_torch/bench.py) held to the JAX package's
bench.py on the CPU.

1. Both settings functions equal bench.py's, field for field.
2. run_config at 60×80, 5 frames, the tiny settings at allocation stride 1
   (the tiny settings' own stride 2 fails assert_alloc_stride_safe at the
   66 px focal length of default_calib(80, 60)), depth and colour, against
   bench.run_config with its IMG and N_FRAMES set to the same: ATE within
   1e-5 m and rotation RMSE within 0.01° (the ICP pose bar of ROADMAP's
   Documented differences), equal diag strings. The timed replay, from a
   fresh map written into the first replay's tensors, gives the first
   replay's poses bit for bit (run_config raises otherwise), and a graph
   captured inside it or poses that differ make run_config raise.
3. The `replay` mode (the PGM fixture) against bench.main's: the same keys,
   the same frames, t_err_mm within 0.1 mm.
4. Every other mode and the default, with both packages' run_config and
   run_swap_ratio returning the same fixed numbers: byte-equal JSON lines
   and diag lines, a diverged 5 mm run (ATE 2 cm) among them.
5. run_swap_ratio's windows on the CPU at a tiny size, and main's refusal to
   fall back to the CPU without a card.
6. The cold start of the replay mode (cold_start.py) on the CPU.

Importing bench.py sets JAX's default matmul precision for the process; the
fixture restores it, and the JAX side runs under bench.py's precision in a
context of its own, so the other JAX tests of the worker are unaffected.
"""

import dataclasses
import enum
import json

import jax
import numpy as np
import pytest
import torch

from infinitam_tpu_torch import bench as t_bench
from infinitam_tpu_torch.config import tiny_test_settings

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)

IMG = (60, 80)
N_FRAMES = 5


@pytest.fixture(scope="module")
def j_bench():
    prior = jax.config.jax_default_matmul_precision
    import bench

    jax.config.update("jax_default_matmul_precision", prior)
    return bench


def plain(obj):
    """A dataclass as nested dicts, enums by value (comparable across packages)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


def tiny():
    return tiny_test_settings().replace(alloc_subsample=1)


@pytest.mark.parametrize("name", ["reference_settings", "teddy_1cm_settings"])
def test_settings_match_bench(j_bench, name):
    assert plain(getattr(t_bench, name)()) == plain(getattr(j_bench, name)())


def test_constants_match_bench(j_bench):
    assert (t_bench.IMG, t_bench.N_FRAMES, t_bench.N_WARM) == (j_bench.IMG, j_bench.N_FRAMES, j_bench.N_WARM)


@pytest.mark.parametrize("with_color", [False, True], ids=["depth", "color"])
def test_run_config_matches_bench(j_bench, monkeypatch, with_color):
    from infinitam_tpu import config as j_cfg

    monkeypatch.setattr(j_bench, "IMG", IMG)
    monkeypatch.setattr(j_bench, "N_FRAMES", N_FRAMES)
    j_settings = j_cfg.tiny_test_settings().replace(alloc_subsample=1, use_color=with_color)
    with jax.default_matmul_precision("highest"):
        _fps, j_ate, j_rot, j_diag = j_bench.run_config(j_settings, with_color=with_color)
    fps, ate, rot, diag = t_bench.run_config(tiny().replace(use_color=with_color), with_color, img=IMG,
                                             n_frames=N_FRAMES, device="cpu")
    assert fps > 0 and ate < 0.01 and rot < 1.0
    assert abs(ate - j_ate) < 1e-5
    assert abs(rot - j_rot) < 0.01
    assert diag == j_diag


@pytest.mark.parametrize("fault", ["capture", "poses"])
def test_run_config_raises_on_a_timed_replay_unlike_the_first(monkeypatch, fault):
    """A graph captured inside the timed replay (a live graph that was not
    there when its clock started), or timed poses that differ from the
    correctness replay's, make run_config raise instead of printing a
    number."""
    calls = []
    if fault == "capture":
        def graphs():
            calls.append(None)
            return [("hash", 0.5)] * (len(calls) > 1)

        monkeypatch.setattr(t_bench, "_graphs", graphs)
        match = "captured inside the timed replay"
    else:
        sequence = t_bench.hp.process_sequence_hash

        def process_sequence_hash(*args, **kw):
            *out, poses, diags = sequence(*args, **kw)
            calls.append(None)
            return (*out, poses + 1e-3 * (len(calls) > 1), diags)

        monkeypatch.setattr(t_bench.hp, "process_sequence_hash", process_sequence_hash)
        match = "poses differ"
    with pytest.raises(RuntimeError, match=match):
        t_bench.run_config(tiny(), img=IMG, n_frames=3, device="cpu")


def test_replay_mode_matches_bench(j_bench, monkeypatch, capsys):
    monkeypatch.setenv("ITPU_BENCH_CONFIG", "replay")
    with jax.default_matmul_precision("highest"):
        j_bench.main()
    j_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    t_bench.main(["--device", "cpu"])
    out = capsys.readouterr()
    t_line = json.loads(out.out.strip().splitlines()[-1])
    assert list(t_line) == list(j_line)
    assert t_line["frames"] == j_line["frames"] == 10
    assert abs(t_line["t_err_mm"] - j_line["t_err_mm"]) <= 0.1
    assert t_line["value"] > 0 and t_line["unit"] == "frames/s"
    assert out.err.splitlines() == ["card: none (--device cpu: the plain versions on the CPU, host times)"]


@pytest.mark.parametrize("case", ["5mm", "1cm", "color", "swap", "default", "default_diverged"])
def test_main_prints_bench_lines(j_bench, monkeypatch, capsys, case):
    """Both mains, fed the same numbers, print byte-equal JSON lines and
    diag lines; a 5 mm ATE of 2 cm prints value 0.0 and the FAILED suffix."""
    ate_5mm = 0.02 if case == "default_diverged" else 0.00412345678
    results = {0.005: (72.66123, ate_5mm, 0.0456789, "n_visible(last)=8000 max_n_alloc_overflow=0"),
               0.01: (91.8567, 0.0088776655, 0.123456, "n_visible(last)=2000 max_n_window_clipped=0")}

    def fake_run_config(settings, with_color=False, **_kw):
        fps, ate, rot, diag = results[settings.scene.voxel_size]
        return (fps * (0.8353 if with_color else 1.0), ate, rot, diag + (" rgb" if with_color else ""))

    def fake_swap_ratio(**_kw):
        return 0.93456, 91.2345, 85.26789

    for module in (j_bench, t_bench):
        monkeypatch.setattr(module, "run_config", fake_run_config)
        monkeypatch.setattr(module, "run_swap_ratio", fake_swap_ratio)
    monkeypatch.setenv("ITPU_BENCH_CONFIG", "" if case.startswith("default") else case)
    j_bench.main()
    j_out = capsys.readouterr()
    t_bench.main(["--device", "cpu"])
    t_out = capsys.readouterr()
    assert t_out.out == j_out.out and len(t_out.out.splitlines()) == 1
    assert t_out.err.splitlines()[1:] == j_out.err.splitlines()
    line = json.loads(t_out.out)
    if case == "default_diverged":
        assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
        assert line["metric"].endswith(" (ATE>1cm or rot>1deg: FAILED)")
    else:
        assert line["value"] > 0 and "FAILED" not in line["metric"]


def test_run_swap_ratio_on_the_cpu(monkeypatch, capsys):
    """The swap ratio's two engines and windows, at the tiny settings: each
    mode's line counts its windows, and no graph exists on the CPU."""
    monkeypatch.setattr(t_bench, "teddy_1cm_settings", tiny)
    ratio, fps_noswap, fps_swap = t_bench.run_swap_ratio(img=IMG, n_frames=6, n_warm=2, window=2, device="cpu")
    assert np.isfinite(ratio) and ratio > 0 and fps_noswap > 0 and fps_swap > 0
    assert ratio == pytest.approx(fps_swap / fps_noswap)
    err = capsys.readouterr().err.splitlines()
    assert [e.split(":")[0] for e in err] == ["swap(noswap)", "swap(swap)"]
    assert all(e.endswith("graphs captured inside each window: [0, 0]") for e in err)


def test_main_without_a_card_raises(monkeypatch):
    """The bench runs on the card unless --device cpu is passed: without a
    card the default raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    monkeypatch.setenv("ITPU_BENCH_CONFIG", "replay")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_bench.main([])


def test_cold_start_on_the_cpu(capsys):
    """The cold start of the replay mode (infinitam_tpu_torch/cold_start.py)
    on the CPU: a line a step and the JSON object of the seconds, frame 0's
    phases summing to frame 0; no context, library or graph here."""
    from infinitam_tpu_torch import cold_start

    cold_start.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    steps = json.loads(out[-1])
    phases = [k for k in steps if k.startswith("frame0_")]
    assert out[0].startswith("card: none") and len(out) == len(steps) + 2
    assert [k for k in steps if not k.startswith("frame0_")] == ["engine", "frame0", "frame1", "frame2_captured",
                                                                 "frame2_capture", "frame3"]
    assert phases == ["frame0_view", "frame0_track", "frame0_alloc", "frame0_integrate", "frame0_raycast",
                      "frame0_rest"]
    assert steps["frame0"] == pytest.approx(sum(steps[k] for k in phases), abs=1e-5)
    assert all(s >= 0 for s in steps.values()) and steps["frame2_capture"] == 0.0
