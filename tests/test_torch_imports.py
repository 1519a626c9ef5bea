"""Import hygiene of the PyTorch port (infinitam_tpu_torch).

The port must run where no JAX is installed: every module imports torch and
never jax, nor any module of the JAX package (config and calib are the port's
own copies). On the CPU every kernel wrapper
takes its plain PyTorch version, so a CPU frame, with colour or without,
through the frame step or the MainEngine façade, must leave every launch
counter at 0 and never build the CUDA library, with swapping and a
checkpoint round trip too. The entry points that place state on a device
default to the card, the swap tier, the viewer and the dense volume among
them.
"""

import ast
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.calib import default_calib
from infinitam_tpu_torch.config import SwappingMode, TrackerType, TrackingParams, tiny_test_settings
from infinitam_tpu_torch.engine import hash_pipeline as hp
from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine.view_builder import build_view_from_metric_depth
from infinitam_tpu_torch.io import synth
from infinitam_tpu_torch.ops.kernels import build

REPO = Path(__file__).resolve().parents[1]

# the tensors here are tiny: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)

IMPORT_ALL = r"""
import importlib, pkgutil, sys
import infinitam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(infinitam_tpu_torch.__path__, "infinitam_tpu_torch.")]
for name in names:
    importlib.import_module(name)
jax_mods = sorted(k for k in sys.modules if k == "jax" or k.startswith(("jax.", "jaxlib")))
assert not jax_mods, jax_mods
ref_mods = sorted(k for k in sys.modules if k == "infinitam_tpu" or k.startswith("infinitam_tpu."))
assert not ref_mods, ref_mods
print(" ".join(names))
"""


def test_every_port_module_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    names = res.stdout.split()
    # the ported modules (the façade, the CLI, the I/O copies, the mesher,
    # the Ren tracker, the swap tier, the checkpoint and the viewer among
    # them) plus packages, kernels and helpers
    assert len(names) >= 35
    # the rank worker: spawned ranks import it, and nothing of JAX, first
    assert "infinitam_tpu_torch.parallel.ranks" in names


def test_native_io_builds_the_ports_own_source():
    """utils/native.py compiles the port's copy of the IO source, never the
    JAX package's native/."""
    from infinitam_tpu_torch.utils import native

    assert native.SOURCE.resolve().is_relative_to(REPO / "infinitam_tpu_torch")
    assert native.SOURCE.exists() and native.SOURCE != REPO / "native" / "itpu_io.cpp"


def test_cpu_frame_uses_only_plain_versions():
    img = (60, 80)
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50))
    calib = default_calib(img[1], img[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(calib, n_frames=2, img_size=img, device="cpu")
    vol, rs, st = hp.create_engine_state(settings, img, device="cpu")
    build.reset_launch_counts()
    for _ in range(2):
        depth, _rgb, _gt = src.get_images()
        view = build_view_from_metric_depth(depth, settings, calib)
        vol, rs, st, diag = hp.process_frame_hash(vol, rs, st, view, proj, settings)
    # the second frame tracked against the first one's maps: real work ran
    assert int(diag.num_valid) > 1000
    assert np.isfinite(st.pose.numpy()).all()
    assert build.launch_counts() == {"icp": 0, "icp_weighted": 0, "integrate": 0, "integrate_color": 0,
                                     "raycast": 0, "raycast_hash": 0, "raycast_dense": 0, "probe_gather": 0,
                                     "probe_rows": 0, "probe_page_sum": 0, "probe_scale": 0, "probe_gemm": 0,
                                     "probe_window_sums": 0}
    assert build.library.cache_info().currsize == 0  # no CUDA library was built or loaded


def test_cpu_color_frames_use_only_plain_versions():
    """Colour fusion under the ICP tracker, then the colour tracker."""
    img = (60, 80)
    calib = default_calib(img[1], img[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(calib, n_frames=2, img_size=img, with_rgb=True, device="cpu")
    frames = [src.get_images() for _ in range(2)]
    build.reset_launch_counts()
    for tracker in (TrackerType.ICP, TrackerType.COLOR):
        settings = tiny_test_settings().replace(
            tracking=TrackingParams(n_levels=3, min_valid_points=50, color_n_levels=3), use_color=True,
            tracker_type=tracker,
        )
        vol, rs, st = hp.create_engine_state(settings, img, device="cpu")
        for depth, rgb, _gt in frames:
            view = build_view_from_metric_depth(depth, settings, calib, rgb=rgb)
            vol, rs, st, diag = hp.process_frame_hash(vol, rs, st, view, proj, settings, proj_rgb=proj)
        assert int(diag.num_valid) > 500
        assert int((hv.rgb_wc(vol.vox_rgb) > 0).sum()) > 1000
        assert np.isfinite(st.pose.numpy()).all()
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert build.library.cache_info().currsize == 0


def test_cpu_engine_frames_launch_no_kernel():
    """MainEngine with the weighted ICP tracker, the bilateral filter and the
    sensor-noise model, on the CPU: the second frame tracks with per-pixel
    weights, and no kernel is launched or built."""
    from infinitam_tpu_torch.engine.main_engine import MainEngine

    img = (60, 80)
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50),
                                            tracker_type=TrackerType.WICP, model_sensor_noise=True,
                                            use_bilateral_filter=True)
    calib = default_calib(img[1], img[0])
    src = synth.SyntheticSource(calib, n_frames=2, img_size=img, device="cpu")
    eng = MainEngine(settings, calib, img, device="cpu")
    build.reset_launch_counts()
    for _ in range(2):
        diag = eng.process_frame(metric_depth=src.get_images()[0])
    assert diag["num_valid"] > 1000 and eng.get_image("raycast").max() > 0
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert build.library.cache_info().currsize == 0


@pytest.mark.parametrize("case", ["ren", "approximate_raycast"])
def test_cpu_ren_and_approximate_frames_and_the_mesh_launch_no_kernel(case):
    """The Ren tracker and the approximate raycast on the CPU, then the map's
    mesh: every kernel wrapper takes its plain version."""
    from infinitam_tpu_torch.engine.meshing_engine import mesh_scene_hash

    img = (60, 80)
    extra = dict(tracker_type=TrackerType.REN) if case == "ren" else dict(use_approximate_raycast=True)
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50), **extra)
    calib = default_calib(img[1], img[0])
    proj = torch.as_tensor(calib.intrinsics_d.vector)
    src = synth.SyntheticSource(calib, n_frames=3, img_size=img, device="cpu")
    vol, rs, st = hp.create_engine_state(settings, img, device="cpu")
    build.reset_launch_counts()
    for _ in range(3):
        view = build_view_from_metric_depth(src.get_images()[0], settings, calib)
        vol, rs, st, diag = hp.process_frame_hash(vol, rs, st, view, proj, settings)
    assert int(diag.num_valid) > 500 and np.isfinite(st.pose.numpy()).all()
    assert mesh_scene_hash(vol, settings).n_triangles > 1000
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert build.library.cache_info().currsize == 0


def test_cpu_swap_frames_and_checkpoint_launch_no_kernel(tmp_path):
    """A swapping MainEngine on the CPU (the frame step, the exchange, the
    flush) and a checkpoint round trip take only plain versions: no kernel
    is launched or built, and the restored state lies on the engine's
    device."""
    from infinitam_tpu_torch.engine.main_engine import MainEngine
    from infinitam_tpu_torch.utils import checkpoint

    img = (60, 80)
    settings = tiny_test_settings().replace(tracking=TrackingParams(n_levels=3, min_valid_points=50),
                                            swapping_mode=SwappingMode.ENABLED)
    calib = default_calib(img[1], img[0])
    src = synth.SyntheticSource(calib, n_frames=3, img_size=img, device="cpu")
    eng = MainEngine(settings, calib, img, device="cpu")
    build.reset_launch_counts()
    for _ in range(3):
        diag = eng.process_frame(metric_depth=src.get_images()[0])
    path = str(tmp_path / "snap.npz")
    checkpoint.save_engine(path, eng)  # drains the exchange: flush_swap
    eng2 = MainEngine(settings, calib, img, device="cpu")
    checkpoint.load_engine(path, eng2)
    assert diag["num_valid"] > 1000 and eng2.swap_exchange.n_listed == 0 < eng.swap_exchange.n_listed
    assert all(t.device.type == "cpu" for t in (*eng2.vol[:8], *eng2.tracking_state, eng2.swap_states))
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert build.library.cache_info().currsize == 0


def test_viewer_runs_on_the_card_by_default(tmp_path):
    """The viewer places its engine on the card unless --cpu is passed:
    without a card it raises instead of falling back to the CPU."""
    from infinitam_tpu_torch.apps import viewer

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        viewer.main(["--synthetic", "--frames", "1", "--orbit", "1", "--out", str(tmp_path), "--width", "8",
                     "--height", "6"])
    assert not os.listdir(tmp_path)


def _default_device_calls():
    """Each entry point of the port that places state or frames on a device,
    called without a device."""
    from infinitam_tpu_torch import convert
    from infinitam_tpu_torch.engine import dense_pipeline, swapping, tracking_state, volume
    from infinitam_tpu_torch.engine.main_engine import MainEngine
    from infinitam_tpu_torch.io import sources
    from infinitam_tpu_torch.parallel import batch

    settings = tiny_test_settings()
    cpu_state = tracking_state.create_tracking_state((6, 8), device="cpu")
    return {
        "create_engine_state": (hp.create_engine_state, lambda: hp.create_engine_state(settings, (6, 8))),
        "create_hash": (hv.create_hash, lambda: hv.create_hash(settings.hashing)),
        "create_render_state": (hv.create_render_state, lambda: hv.create_render_state(settings.hashing)),
        "create_tracking_state": (tracking_state.create_tracking_state,
                                  lambda: tracking_state.create_tracking_state((6, 8))),
        "SyntheticSource": (synth.SyntheticSource.__init__,
                            lambda: synth.SyntheticSource(default_calib(8, 6), n_frames=1, img_size=(6, 8))),
        "from_numpy": (convert.from_numpy,
                       lambda: convert.from_numpy(tracking_state.TrackingState, convert.to_numpy(cpu_state))),
        "MainEngine": (MainEngine.__init__, lambda: MainEngine(settings, default_calib(8, 6), (6, 8))),
        "swapping MainEngine": (MainEngine.__init__, lambda: MainEngine(
            settings.replace(swapping_mode=SwappingMode.ENABLED), default_calib(8, 6), (6, 8))),
        "create_swap_states": (swapping.create_swap_states, lambda: swapping.create_swap_states(settings)),
        "create_dense": (volume.create_dense, lambda: volume.create_dense(settings.plain)),
        "dense create_engine_state": (dense_pipeline.create_engine_state,
                                      lambda: dense_pipeline.create_engine_state(settings, (6, 8))),
        "SwapExchange": (swapping.SwapExchange.__init__, lambda: swapping.SwapExchange(settings, False)),
        "make_source": (sources.make_source, lambda: sources.make_source(img_size=(6, 8), n_frames=1)),
        "DeviceFrameFeed": (sources.DeviceFrameFeed.__init__,
                            lambda: sources.DeviceFrameFeed(synth.SyntheticSource(
                                default_calib(8, 6), n_frames=1, img_size=(6, 8), device="cpu")).get_images()),
        "batched_state_hash": (batch.batched_state_hash, lambda: batch.batched_state_hash(settings, (6, 8), 2)),
        "batched_state_dense": (batch.batched_state_dense, lambda: batch.batched_state_dense(settings, (6, 8), 2)),
    }


@pytest.mark.parametrize("entry", ["create_engine_state", "create_hash", "create_render_state",
                                   "create_tracking_state", "SyntheticSource", "from_numpy", "MainEngine",
                                   "make_source", "DeviceFrameFeed", "swapping MainEngine", "create_swap_states",
                                   "SwapExchange", "create_dense", "dense create_engine_state",
                                   "batched_state_hash", "batched_state_dense", "probes"])
def test_entry_points_default_to_the_card(entry):
    """The port runs on the card unless the caller passes device="cpu" (the
    probes' entry point: --cpu): the default is "cuda", and without a card a
    call that names no device raises instead of falling back to the CPU."""
    if entry == "probes":
        from infinitam_tpu_torch.probes import __main__ as probes_main

        call = lambda: probes_main.main(["probe2"])  # noqa: E731
    else:
        fn, call = _default_device_calls()[entry]
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()


def _pallas_call_sites() -> list:
    """file:line of every `pl.pallas_call(...)` call in infinitam_tpu/ and tools/."""
    sites = []
    for path in sorted([*(REPO / "infinitam_tpu").rglob("*.py"), *(REPO / "tools").rglob("*.py")]):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "pallas_call"):
                sites.append(f"{path.relative_to(REPO)}:{node.lineno}")
    return sites


def test_every_pallas_call_site_has_a_kernel_of_the_port():
    """Every TPU kernel of the repository has its hand-written counterpart:
    each `pallas_call` site of the JAX package and of tools/ has an entry in
    the port's kernel registry (ops/kernels/probes.py SITES: the kernel, its
    CUDA source, its wrapper), and the registry names no site that is gone."""
    from infinitam_tpu_torch.ops.kernels import probes

    sites = _pallas_call_sites()
    assert len(sites) == 19
    assert sorted(sites) == sorted(probes.SITES)
    for kernel, source, wrapper in probes.SITES.values():
        assert (REPO / source).exists(), source
        module, fn = wrapper.split(".")
        assert callable(getattr(importlib.import_module(f"infinitam_tpu_torch.ops.kernels.{module}"), fn)), wrapper
        assert kernel[0] == "K" or probes.COUNTERS[kernel] in build.KERNELS


# Top-level public names of the JAX package that the port leaves out on
# purpose, by module (the path below infinitam_tpu/), each with its reason.
NOT_PORTED = {
    "engine/hash_pipeline.py": {
        "integrate_into_scene_pallas": "the Pallas dispatch: the port's integrate_into_scene launches K2 itself",
        "raycast_hash_pallas": "the Pallas dispatch: the port's raycast_hash launches K3 (K3h) itself",
    },
    "ops/color_tracking.py": {
        "skip_points_mask": "the colour tracker takes every other point by slicing the cloud ([::2, ::2]), "
                            "which the mask only selected",
    },
    "ops/icp.py": {
        name: "a scalar-unrolled form of the tracker's 6×6 / 4×4 algebra for the TPU's vector units; the port "
              "runs solve_delta, apply_delta, se3.coerce and has_converged on the tensors themselves"
        for name in ("pose12_from_mat", "mat_from_pose12", "solve_delta_scalars", "apply_delta_scalars",
                     "coerce_scalars", "has_converged_scalars")
    },
    "ops/meshing.py": {
        "extract_mesh_chunk": "the capped chunk mesher, which drops triangles past its cap; the port's "
                              "extract_mesh counts first and drops nothing (ROADMAP Queue 3)",
    },
}


def _public_names(path: Path) -> list:
    """Top-level public functions, classes and assigned constants of a module."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _bound_names(path: Path) -> set:
    """Every name a module binds at its top level or in a block there (defs,
    classes, assignments, imports)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                out.update(e.id for e in ast.walk(t) if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


JAX_MODULES = sorted(str(p.relative_to(REPO / "infinitam_tpu"))
                     for p in (REPO / "infinitam_tpu").rglob("*.py")
                     if p.relative_to(REPO / "infinitam_tpu").parts[:2] != ("ops", "pallas"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_name_has_a_counterpart(module):
    """The port does all the JAX package does: each top-level public
    function, class and constant of every module of infinitam_tpu/ (but
    ops/pallas/, the TPU kernels, which csrc/ replaces) has a same-named
    counterpart in the port's module of the same path, or an entry with its
    reason in NOT_PORTED."""
    ported = REPO / "infinitam_tpu_torch" / module
    assert ported.exists(), f"infinitam_tpu_torch/{module} is missing"
    skipped = NOT_PORTED.get(module, {})
    assert all(reason.strip() for reason in skipped.values())
    have = _bound_names(ported)
    missing = [n for n in _public_names(REPO / "infinitam_tpu" / module) if n not in have and n not in skipped]
    assert not missing, f"infinitam_tpu_torch/{module} lacks {missing}"
    stale = [n for n in skipped if n in have]
    assert not stale, f"NOT_PORTED lists names the port has: {stale}"


def test_not_ported_names_exist_in_the_jax_package():
    for module, names in NOT_PORTED.items():
        public = _public_names(REPO / "infinitam_tpu" / module)
        assert set(names) <= set(public), (module, set(names) - set(public))
