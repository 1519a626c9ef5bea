"""Build and load the hand-written CUDA kernels (csrc/*.cu).

One `nvcc` per source, all started together, compiles the sources to
objects, and one more links them into a shared library with a plain C
interface, loaded with ctypes. The library lands in `build/kernels/` at the
repository root (listed in .gitignore), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the first kernel launch builds.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launches; `check` raises on nonzero.

Every kernel of the package's paths is lane-indexed (the probes' P1-P6 are
not: no batched path runs them): an entry point takes a lane count B and a host
array of lane strides, one a tensor argument (the elements from one lane's
tensor to the next; 0 for a tensor every lane shares), and one launch runs
all B lanes. B = 1 is the unbatched call. The wrappers bind each launch to a
`torch.library.custom_op` whose vmap rule makes that one launch for a
`torch.vmap` batch (`LaneArg`, `lane_major`, `vmap_lanes`).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
SOURCES = ("icp.cu", "integrate.cu", "raycast.cu", "probes.cu")
HEADERS = ("common.cuh",)

# -fmad=false: no multiply-add contraction, so each kernel rounds like its
# plain PyTorch version (separate elementwise ops); K2's packed int16 sdf is
# then bit-identical to the plain scatter. -Xptxas -v reports each kernel's
# registers, shared memory and spills (kept in `ptxas_report`).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# argtypes of every C entry point (all return int: cudaGetLastError()); each
# ends with n_lanes, the lane strides (int64, one a tensor argument, in the
# order the comment lists them) and the stream
SIGNATURES = {
    # depth, weights (or null), h, w, points, normals, hs, ws, view_proj, scene_proj, inv_pose, scene_pose,
    # dist_thresh, min_valid, n_ctas, partial, counter, out, count, n_lanes, strides (depth, weights,
    # points, normals, view_proj, scene_proj, inv_pose, scene_pose), stream
    "itpu_icp_gh": (P, P, I, I, P, P, I, I, P, P, P, P, F, I, I, P, P, P, P, I, P, P),
    # vox, ids, n_rows, entry_ptr, entry_pos, n_entries, block_size, depth, h, w, pose, proj, enable,
    # voxel_size, mu, max_w, stop_at_max_w, n_ctas, n_lanes, strides (INTEGRATE_LANES), stream
    "itpu_integrate_depth": (P, P, I, P, P, I, I, P, I, I, P, P, P, F, F, I, I, I, I, P, P),
    # vox, vox_rgb, ids, n_rows, entry_ptr, entry_pos, n_entries, block_size, depth, h, w, rgb, rh, rw, pose,
    # proj, M_rgb, proj_rgb, enable, voxel_size, mu, max_w, stop_at_max_w, n_ctas, n_lanes, strides, stream
    "itpu_integrate_rgbd": (P, P, P, I, P, P, I, I, P, I, I, P, I, I, P, P, P, P, P, F, F, I, I, I, I, P, P),
    # a, b, out, n, stream: K2's division steps on n pairs (a card test holds them to IEEE division)
    "itpu_div_step_check": (P, P, P, I, P),
    # vox, grid, gx, gy, gz, ox, oy, oz, block_shift, inv_M, proj, inv_voxel, zmin, zmax, h, w,
    # step_scale, enable (or null), out, n_lanes, strides (RAYCAST_LANES, then vox, grid), stream
    "itpu_raycast": (P, P, I, I, I, I, I, I, I, P, P, F, P, P, I, I, F, P, P, I, P, P),
    # vox, entry_pos, entry_ptr, entry_offset, n_buckets, hash_mask, block_shift, inv_M, proj, inv_voxel, zmin,
    # zmax, h, w, step_scale, enable (or null), out, n_lanes, strides (RAYCAST_LANES, then vox, entry_pos,
    # entry_ptr, entry_offset), stream
    "itpu_raycast_hash": (P, P, P, P, I, I, I, P, P, F, P, P, I, I, F, P, P, I, P, P),
    # sdf, sx, sy, sz, ox, oy, oz, block_shift, inv_M, proj, inv_voxel, zmin, zmax, h, w, step_scale,
    # enable (or null), out, n_lanes, strides (RAYCAST_LANES, then sdf), stream
    "itpu_raycast_dense": (P, I, I, I, I, I, I, I, P, P, F, P, P, I, I, F, P, P, I, P, P),
    # K3h and K3d in the lock-step design they replaced: the same arguments
    "itpu_raycast_hash_lockstep": (P, P, P, P, I, I, I, P, P, F, P, P, I, I, F, P, P, I, P, P),
    "itpu_raycast_dense_lockstep": (P, I, I, I, I, I, I, I, P, P, F, P, P, I, I, F, P, P, I, P, P),
    # kernel (0 K3, 1 K3h, 2 K3d, 3 K3h and 4 K3d lock-step), n_lanes, ctas_per_sm out, sms out
    "itpu_raycast_occupancy": (I, I, P, P),
    # P1-P6, the probes' kernels (ops/kernels/probes.py; not lane-indexed: no batched path runs them)
    # tab, idx, out, n, mode (0 take, 1 along axis 0, 2 along axis 1), elem_bytes, tab_cols, idx_cols, stream
    "itpu_probe_gather": (P, P, P, I, I, I, I, I, P),
    # in, out, row_len, elem_bytes, ptr, n_steps, src_ptr, dst_ptr, wv, wu, valid, img, img_w, tap, gate,
    # tap_scale, mul, stream; _simple: the design P2 replaced (uncounted)
    "itpu_probe_rows": (P, P, I, I, P, I, I, I, P, P, P, P, I, I, I, F, F, P),
    "itpu_probe_rows_simple": (P, P, I, I, P, I, I, I, P, P, P, P, I, I, I, F, F, P),
    # pages, row_len, elem_bytes, ids, ids_stride, k_pages, n_tiles, out, n_cols, hashed, scale, stream;
    # _simple: the design P3 replaced, for comparisons (uncounted)
    "itpu_probe_page_sum": (P, I, I, P, I, I, I, P, I, I, F, P),
    "itpu_probe_page_sum_simple": (P, I, I, P, I, I, I, P, I, I, F, P),
    # in, out, n_ctas, vec_per_cta, mul, stream; _simple: the design P4 replaced, for comparisons (uncounted)
    "itpu_probe_scale": (P, P, I, I, F, P),
    "itpu_probe_scale_simple": (P, P, I, I, F, P),
    # a, b, c, m, n, k, stream; _wmma: the design P5 replaced, for comparisons (uncounted)
    "itpu_probe_gemm": (P, P, P, I, I, I, P),
    "itpu_probe_gemm_wmma": (P, P, P, I, I, I, P),
    # img, img_w, starts, starts_stride, n_tiles, win_h, win_w, out, out_w, stream; _simple: the design P6
    # replaced, for comparisons (uncounted)
    "itpu_probe_window_sums": (P, I, P, I, I, I, I, P, I, P),
    "itpu_probe_window_sums_simple": (P, I, P, I, I, I, I, P, I, P),
    # buf, n_vec4, n_ctas, out, stream: a plain read of an L2-resident buffer, each CTA's sum in out (the
    # L2's read rate under P3 and P6, for the smoke's L2 floor; uncounted)
    "itpu_l2_read": (P, I, I, P, P),
}

KERNELS = ("icp", "icp_weighted", "integrate", "integrate_color", "raycast", "raycast_hash", "raycast_dense",
           "probe_gather", "probe_rows", "probe_page_sum", "probe_scale", "probe_gemm", "probe_window_sums")
_launches = dict.fromkeys(KERNELS, 0)

# seconds the last build took in this process (0 while none ran), and what
# ptxas reported per source in it
last_build_seconds = 0.0
ptxas_report: dict = {}


def count_launch(kernel: str) -> None:
    """Called by a wrapper right after it launched its kernel."""
    _launches[kernel] += 1


def launch_counts() -> dict:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


# the launch counter of each counted kernel, by the name of its __global__
# function (mangled, or demangled) as a CUDA graph's kernel node names it
# (engine/captured.py); the lock-step raycasts (K3h's serial walk, K3d at
# LA 1) and the designs P2-P6 replaced (`itpu_probe_*_simple_kernel`,
# `itpu_probe_gemm_wmma_kernel`) are not counted
_SYMBOLS = tuple((re.compile(p), k) for p, k in (
    (r"itpu_icp_kernel(ILb0E|<false>)", "icp"),
    (r"itpu_icp_kernel(ILb1E|<true>)", "icp_weighted"),
    (r"itpu_integrate_kernel(ILb0E|<false,)", "integrate"),
    (r"itpu_integrate_kernel(ILb1E|<true,)", "integrate_color"),
    (r"itpu_raycast_kernel\W*\w*ItpuBlockReader\W*\w*ItpuGridIndex(E|>)", "raycast"),
    (r"itpu_raycast_kernel\W*\w*ItpuBlockReader\W*\w*ItpuHashIndex(E|>)", "raycast_hash"),
    (r"itpu_raycast_kernel\W*\w*ItpuDenseReader(Lb[01]ELi2E|, (false|true), 2>)", "raycast_dense"),
    (r"itpu_probe_gather_kernel", "probe_gather"),
    (r"itpu_probe_rows_kernel", "probe_rows"),
    (r"itpu_probe_page_sum_kernel", "probe_page_sum"),
    (r"itpu_probe_scale_kernel", "probe_scale"),
    (r"itpu_probe_gemm_kernel", "probe_gemm"),
    (r"itpu_probe_window_sums_kernel", "probe_window_sums"),
))


def counter_of(symbol: str) -> Optional[str]:
    """The launch counter (one of KERNELS) of the kernel function named
    `symbol`, None for any other kernel."""
    for pattern, kernel in _SYMBOLS:
        if pattern.search(symbol):
            return kernel
    return None


def add_launches(counts: dict) -> None:
    """Count the launches a captured graph makes, at its replay
    (engine/captured.py)."""
    for k, n in counts.items():
        _launches[k] += n


@contextlib.contextmanager
def tally():
    """Yields a dict that holds, when the block ends, the launches counted
    inside it; the counts are then left as they were before the block (a
    capture records launches without running them)."""
    before = dict(_launches)
    counted: dict = {}
    try:
        yield counted
    finally:
        counted.update({k: n - before[k] for k, n in _launches.items() if n != before[k]})
        _launches.update(before)


def nvcc_path() -> str:
    cuda_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libitpu_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list) -> list:
    """Run the commands at once; (command, stdout + stderr) of each, in order.
    Raises when one fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    for cmd, out, rc in outs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    return [(cmd, out) for cmd, out, _rc in outs]


def build() -> Path:
    """Compile the sources unless a library of the same hash exists. The
    build holds an exclusive lock on a file beside the library (released
    when the process ends, whatever way), so ranks that start together run
    one build and the others wait for it and load its library."""
    lib = _library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(lib)
    return lib


def _compile(lib: Path) -> None:
    global last_build_seconds
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = nvcc_path()
    objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in SOURCES]
    t0 = time.perf_counter()
    compiled = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC_DIR / s)] for s, o in zip(SOURCES, objs)])
    _run([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]])
    for o in objs:
        o.unlink()
    os.replace(tmp, lib)
    last_build_seconds = time.perf_counter() - t0
    ptxas_report.update({s: out for s, (_cmd, out) in zip(SOURCES, compiled)})


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def require_cuda(name: str, *tensors: torch.Tensor, device: torch.device) -> None:
    """Every tensor of a launch on the same CUDA device, contiguous."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs CUDA tensors, got {device}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensor on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def require_dtype(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


class LaneArg(NamedTuple):
    """One tensor argument of a lane-indexed launch: with `batched`, `t`
    holds the lanes on dim 0, each lane's tensor contiguous, `stride`
    elements apart; else `t` is the one tensor every lane shares (stride 0)
    or None (an absent optional argument)."""

    t: Optional[torch.Tensor]
    stride: int = 0
    batched: bool = False

    def lane(self, b: int) -> Optional[torch.Tensor]:
        """The tensor lane b sees."""
        return self.t[b] if self.batched else self.t

    def ptr(self):
        """Lane 0's data pointer (None when absent)."""
        return None if self.t is None else self.t.data_ptr()


def lane_major(t: Optional[torch.Tensor], dim: Optional[int]):
    """(LaneArg, the view to write back into or None) of a vmap rule's
    argument `t` with its batch dim at `dim` (None: shared by the lanes).
    A layout whose lanes are not each contiguous is copied; a kernel that
    writes such an argument must copy the result back (`write_back`)."""
    if t is None or dim is None:
        return LaneArg(t), None
    src = t.movedim(dim, 0)
    x = src if src[0].is_contiguous() else src.contiguous()
    return LaneArg(x, x.stride(0), True), (None if x is src else src)


def vmap_lanes(in_dims, args):
    """LaneArgs of a vmap rule's arguments (tensors and None; any other
    value passes through as is) and the write-backs of their copies."""
    lanes, backs = [], []
    for a, d in zip(args, in_dims):
        if a is None or torch.is_tensor(a):
            la, back = lane_major(a, d)
            lanes.append(la)
            backs.append((la, back))
        else:
            lanes.append(a)
    return lanes, backs


def write_back(backs, mutated: tuple) -> None:
    """Copy the results of the mutated arguments (their positions among the
    tensor arguments) back where lane_major had to copy them."""
    for i in mutated:
        la, back = backs[i]
        if back is not None:
            back.copy_(la.t)


def lane_strides(args) -> ctypes.Array:
    """The host array of lane strides a lane-indexed entry point takes."""
    return (ctypes.c_longlong * len(args))(*(a.stride for a in args))


def single(*tensors):
    """LaneArgs of one lane's tensors (the unbatched call, B = 1)."""
    return [LaneArg(t) for t in tensors]
