"""P1-P6: the kernels of the TPU primitive probes (tools/probe2.py, probe6-13.py).

Replaces the 16 `pl.pallas_call` sites of those scripts (`SITES` maps every
`pallas_call` site of the repository to its kernel). The CUDA kernels
(csrc/probes.cu) compute what the probes' Pallas bodies compute; their
plain twins are `infinitam_tpu_torch/probes/plain.py`:

- P1 `gather`: take / take_along_axis (probe2 kA, kB; probe6 kern);
- P2 `row_update`: a CTA takes a chunk of steps, a warp a step, each warp
  loading its next step before it stores the current one (probe7, probe8
  k1-k5, probe9 kernel, probe10, probe12 kern, probe13 sk);
- P3 `page_sum`: a tile's pages gathered and summed (probe9 kacc, probe13
  rk), a thread a column (int8, summed exactly) or a float4 of columns
  (float32, in k order) with its pages' loads in flight: the L2 bounds it,
  each tile requesting every sector of its rows (29.5 MB at rk, 19.7 MB at
  kacc);
- P4 `scaled_copy`: x · 1.000001 in CTAs of a set number of rows (probe11
  ck, probe12 ck), each CTA's block streamed through a ring of bulk
  asynchronous copies;
- P5 `gemm_bf16`: bf16 product with float32 accumulation (probe11 mk),
  wgmma on operands a TMA ring brings into shared memory;
- P6 `window_sums`: the column sums of a window at a tile's start (probe13
  wk), a warp 32 columns of a tile, 16 rows in flight a lane: the L2 bounds
  it (a window row spans 8-9 sectors, 21.8 MB of requests at wk).

Each wrapper takes the plain twin for tensors on the CPU and launches its
kernel for CUDA tensors (built at first launch into build/kernels/, counted
in `build.launch_counts()`); it raises where the kernel does not take its
arguments and never falls back from one to the other. No batched path runs
these kernels, so they are not lane-indexed. The designs P2-P6 replaced
stay as comparison entry points, on no path and not counted
(`row_update_simple`, `page_sum_simple`, `scaled_copy_simple`,
`gemm_bf16_wmma`, `window_sums_simple`). `l2_read`, on no path and not
counted either, reads an L2-resident buffer at the L2's rate: the smoke's L2
floor under P3 and P6.
"""

from __future__ import annotations

import ctypes

import torch

from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.probes import plain

PROBES_CU = "infinitam_tpu_torch/csrc/probes.cu"

# every pl.pallas_call site of the repository (file:line of the call) → (the
# port's kernel, its source, the wrapper that launches it)
SITES = {
    "infinitam_tpu/ops/pallas/icp_kernel.py:309": ("K1", "infinitam_tpu_torch/csrc/icp.cu", "icp.icp_gh"),
    "infinitam_tpu/ops/pallas/integrate_kernel.py:326": ("K2", "infinitam_tpu_torch/csrc/integrate.cu",
                                                         "integrate.integrate_depth"),
    "infinitam_tpu/ops/pallas/raycast_kernel.py:567": ("K3", "infinitam_tpu_torch/csrc/raycast.cu",
                                                       "raycast.raycast_grid"),
    "tools/probe2.py:27": ("P1", PROBES_CU, "probes.gather"),
    "tools/probe2.py:47": ("P1", PROBES_CU, "probes.gather"),
    "tools/probe6.py:42": ("P1", PROBES_CU, "probes.gather"),
    "tools/probe7.py:77": ("P2", PROBES_CU, "probes.row_update"),
    "tools/probe8.py:28": ("P2", PROBES_CU, "probes.row_update"),
    "tools/probe9.py:53": ("P2", PROBES_CU, "probes.row_update"),
    "tools/probe9.py:115": ("P3", PROBES_CU, "probes.page_sum"),
    "tools/probe10.py:69": ("P2", PROBES_CU, "probes.row_update"),
    "tools/probe11.py:31": ("P5", PROBES_CU, "probes.gemm_bf16"),
    "tools/probe11.py:58": ("P4", PROBES_CU, "probes.scaled_copy"),
    "tools/probe11.py:73": ("P4", PROBES_CU, "probes.scaled_copy"),
    "tools/probe12.py:59": ("P4", PROBES_CU, "probes.scaled_copy"),
    "tools/probe12.py:105": ("P2", PROBES_CU, "probes.row_update"),
    "tools/probe13.py:51": ("P3", PROBES_CU, "probes.page_sum"),
    "tools/probe13.py:85": ("P6", PROBES_CU, "probes.window_sums"),
    "tools/probe13.py:113": ("P2", PROBES_CU, "probes.row_update"),
}

# each probe kernel's launch counter (build.KERNELS)
COUNTERS = {"P1": "probe_gather", "P2": "probe_rows", "P3": "probe_page_sum", "P4": "probe_scale",
            "P5": "probe_gemm", "P6": "probe_window_sums"}

_TAP = {name: i for i, name in enumerate(plain.TAPS)}
_GATE = {name: i for i, name in enumerate(plain.GATES)}
MAX_PAGES = 256  # csrc/probes.cu PROBE_MAX_PAGES
L2_READ_THREADS = 256  # csrc/probes.cu L2_READ_THREADS


def _require(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on the first one's CUDA device, contiguous."""
    build.require_cuda(name, *tensors, device=tensors[0].device)


def gather(tab: torch.Tensor, idx: torch.Tensor, axis=None) -> torch.Tensor:
    """P1: `take` (axis None) or `take_along_axis` on axis 0 or 1 of a 2-D
    table, for tables of 1-, 2- or 4-byte elements and int32 indices in
    range."""
    if tab.device.type == "cpu":
        return plain.gather(tab, idx, axis)
    _require("gather", tab, idx)
    build.require_dtype("gather", idx, torch.int32)
    if tab.element_size() not in (1, 2, 4):
        raise ValueError(f"gather: {tab.dtype} is not a 1-, 2- or 4-byte type")
    tab_cols = idx_cols = 0
    if axis is not None:
        if tab.dim() != 2 or idx.dim() != 2 or axis not in (0, 1):
            raise ValueError("gather: take_along_axis takes a 2-D table and indices on axis 0 or 1")
        if idx.shape[1 - axis] != tab.shape[1 - axis]:
            raise ValueError(f"gather: indices {tuple(idx.shape)} do not match the table {tuple(tab.shape)}")
        tab_cols, idx_cols = tab.shape[1], idx.shape[1]
    out = torch.empty(idx.shape, dtype=tab.dtype, device=tab.device)
    err = build.library().itpu_probe_gather(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                                            0 if axis is None else 1 + axis, tab.element_size(), tab_cols,
                                            idx_cols, build.stream_ptr())
    build.check("itpu_probe_gather", err)
    build.count_launch("probe_gather")
    return out


_ROW_DEFAULTS = dict(in_place=True, src_ptr=True, dst_ptr=True, tap="none", img=None, wv=None, wu=None, gate="none",
                     valid=None, tap_scale=0.0, mul=1.0)


def _rows(name: str, vba: torch.Tensor, ptr: torch.Tensor, *, in_place: bool, src_ptr: bool, dst_ptr: bool,
          tap: str, img, wv, wu, gate: str, valid, tap_scale: float, mul: float) -> torch.Tensor:
    """A row update launched through the C entry point `name`, its
    arguments checked."""
    if tap not in _TAP or gate not in _GATE:
        raise ValueError(f"{name}: tap {tap!r} or gate {gate!r} unknown")
    if in_place and src_ptr != dst_ptr:
        raise ValueError(f"{name}: an update in place reads and writes through the same map")
    if vba.dim() != 2:
        raise ValueError(f"{name}: rows must be [rows, row_len]")
    if vba.dtype == torch.int8:
        if tap != "none" or gate != "first":
            raise ValueError(f"{name}: int8 rows take no tap and the gate 'first'")
    elif vba.dtype != torch.float32:
        raise ValueError(f"{name}: rows must be float32 or int8, got {vba.dtype}")
    elif gate == "first":
        raise ValueError(f"{name}: the gate 'first' is for int8 rows")
    named = {"img": img, "wv": wv, "wu": wu} if tap != "none" else {}
    if gate == "valid":
        named["valid"] = valid
    missing = [k for k, t in named.items() if t is None]
    if missing:
        raise ValueError(f"{name}: tap {tap!r} and gate {gate!r} need {missing}")
    _require(name, vba, ptr, *named.values())
    build.require_dtype(name, ptr, torch.int32)
    for k in ("wv", "wu", "valid"):
        if k in named:
            build.require_dtype(name, named[k], torch.int32)
    if tap != "none":
        build.require_dtype(name, img, torch.float32)
    out = vba if in_place else torch.empty_like(vba)

    def ptr_of(t):
        return None if t is None else t.data_ptr()

    err = getattr(build.library(), name)(
        vba.data_ptr(), out.data_ptr(), vba.shape[1], vba.element_size(), ptr.data_ptr(), ptr.numel(),
        int(src_ptr), int(dst_ptr), ptr_of(named.get("wv")), ptr_of(named.get("wu")), ptr_of(named.get("valid")),
        ptr_of(named.get("img")), 0 if img is None else img.shape[1], _TAP[tap], _GATE[gate],
        ctypes.c_float(tap_scale), ctypes.c_float(mul), build.stream_ptr())
    build.check(name, err)
    return out


def row_update(vba: torch.Tensor, ptr: torch.Tensor, *, in_place: bool = True, src_ptr: bool = True,
               dst_ptr: bool = True, tap: str = "none", img=None, wv=None, wu=None, gate: str = "none",
               valid=None, tap_scale: float = 0.0, mul: float = 1.0) -> torch.Tensor:
    """P2 (see plain.row_update): in place, or into a fresh output of which
    only the written rows are defined; a CTA takes a chunk of steps, a warp
    a step. The written rows must be distinct unless the gate is "first";
    an update in place reads and writes through the same map."""
    kwargs = dict(in_place=in_place, src_ptr=src_ptr, dst_ptr=dst_ptr, tap=tap, img=img, wv=wv, wu=wu, gate=gate,
                  valid=valid, tap_scale=tap_scale, mul=mul)
    if vba.device.type == "cpu":
        return plain.row_update(vba, ptr, **kwargs)
    out = _rows("itpu_probe_rows", vba, ptr, **kwargs)
    build.count_launch("probe_rows")
    return out


def row_update_simple(vba: torch.Tensor, ptr: torch.Tensor, **kwargs) -> torch.Tensor:
    """P2 in the design it replaced (one CTA a step), for comparisons: not
    counted; the arguments of `row_update`."""
    if vba.device.type == "cpu":
        return plain.row_update(vba, ptr, **kwargs)
    return _rows("itpu_probe_rows_simple", vba, ptr, **_ROW_DEFAULTS | kwargs)


def _page_sum(name: str, pages: torch.Tensor, ids: torch.Tensor, k_pages: int, n_cols: int, scale: float,
              hashed: bool) -> torch.Tensor:
    """A page sum launched through the C entry point `name`, its arguments
    checked."""
    _require(name, pages, ids)
    build.require_dtype(name, ids, torch.int32)
    if pages.dtype not in (torch.float32, torch.int8) or pages.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"{name}: float32 or int8 pages [rows, row_len] and ids [tiles, pages]")
    if not 0 <= k_pages <= min(ids.shape[1], MAX_PAGES):
        raise ValueError(f"{name}: {k_pages} pages a tile, at most {min(ids.shape[1], MAX_PAGES)}")
    if not hashed and n_cols > pages.shape[1]:
        raise ValueError(f"{name}: {n_cols} columns of rows of {pages.shape[1]}")
    out = torch.empty((ids.shape[0], n_cols), dtype=torch.float32, device=pages.device)
    err = getattr(build.library(), name)(pages.data_ptr(), pages.shape[1], pages.element_size(), ids.data_ptr(),
                                         ids.shape[1], k_pages, ids.shape[0], out.data_ptr(), n_cols, int(hashed),
                                         ctypes.c_float(scale), build.stream_ptr())
    build.check(name, err)
    return out


def page_sum(pages: torch.Tensor, ids: torch.Tensor, k_pages: int, n_cols: int, scale: float = 1.0,
             hashed: bool = False) -> torch.Tensor:
    """P3: out [tiles, n_cols] = scale · Σ_{k<k_pages} f32(pages[ids[t, k],
    sel(t, c)]) for float32 or int8 pages [rows, row_len] and int32 ids
    [tiles, ≥ k_pages] (see plain.page_sum), a CTA a tile and 128 columns:
    int8 a thread a column, 16 pages loaded before any is added, summed
    exactly in an int; float32 a thread a float4 of columns, in k order."""
    if pages.device.type == "cpu":
        return plain.page_sum(pages, ids, k_pages, n_cols, scale, hashed)
    out = _page_sum("itpu_probe_page_sum", pages, ids, k_pages, n_cols, scale, hashed)
    build.count_launch("probe_page_sum")
    return out


def page_sum_simple(pages: torch.Tensor, ids: torch.Tensor, k_pages: int, n_cols: int, scale: float = 1.0,
                    hashed: bool = False) -> torch.Tensor:
    """P3 in the design it replaced (a thread a column, one element at a
    time), for comparisons: not counted; the arguments of `page_sum`."""
    if pages.device.type == "cpu":
        return plain.page_sum(pages, ids, k_pages, n_cols, scale, hashed)
    return _page_sum("itpu_probe_page_sum_simple", pages, ids, k_pages, n_cols, scale, hashed)


def _scale_args(name: str, x: torch.Tensor, rows_per_cta: int) -> tuple:
    """(CTAs, float4 a CTA) of a scaled copy of x, checked."""
    _require(name, x)
    build.require_dtype(name, x, torch.float32)
    if x.dim() != 2 or x.shape[0] % rows_per_cta or x.shape[1] % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name}: {tuple(x.shape)} in blocks of {rows_per_cta} rows, rows of 4k floats")
    return x.shape[0] // rows_per_cta, rows_per_cta * x.shape[1] // 4


def scaled_copy(x: torch.Tensor, rows_per_cta: int, mul: float = 1.000001) -> torch.Tensor:
    """P4: x · mul for float32 x [rows, row_len], one CTA a block of
    `rows_per_cta` rows (rows a multiple of it, row_len of 4): the block goes
    through a ring of bulk asynchronous copies, 16 KB chunks in 4 stages."""
    if x.device.type == "cpu":
        return plain.scaled_copy(x, rows_per_cta, mul)
    n_ctas, vec = _scale_args("scaled_copy", x, rows_per_cta)
    out = torch.empty_like(x)
    err = build.library().itpu_probe_scale(x.data_ptr(), out.data_ptr(), n_ctas, vec, ctypes.c_float(mul),
                                           build.stream_ptr())
    build.check("itpu_probe_scale", err)
    build.count_launch("probe_scale")
    return out


def scaled_copy_simple(x: torch.Tensor, rows_per_cta: int, mul: float = 1.000001) -> torch.Tensor:
    """P4 in the design it replaced (256 threads, one float4 load and its
    store at a time), for comparisons: not counted."""
    if x.device.type == "cpu":
        return plain.scaled_copy(x, rows_per_cta, mul)
    n_ctas, vec = _scale_args("scaled_copy_simple", x, rows_per_cta)
    out = torch.empty_like(x)
    build.check("itpu_probe_scale_simple", build.library().itpu_probe_scale_simple(
        x.data_ptr(), out.data_ptr(), n_ctas, vec, ctypes.c_float(mul), build.stream_ptr()))
    return out


GEMM_TILE = (128, 256, 64)  # csrc/probes.cu GEMM_BM, GEMM_BN, GEMM_BK
WMMA_TILE = (128, 128, 32)  # csrc/probes.cu WMMA_BM, WMMA_BN, WMMA_BK: the design P5 replaced


def _gemm_args(name: str, a: torch.Tensor, b: torch.Tensor) -> tuple:
    _require(name, a, b)
    build.require_dtype(name, a, torch.bfloat16)
    build.require_dtype(name, b, torch.bfloat16)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name}: [{tuple(a.shape)}] · [{tuple(b.shape)}] is not a matrix product")
    (m, k), n = a.shape, b.shape[1]
    return m, n, k


def gemm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P5: bf16(a · b), float32 accumulation, for bf16 a [M, K] and b [K, N]
    with N and K multiples of 8 (the tensor maps' rows of 16-byte
    multiples), any M: wgmma on 128×256 tiles, fed k-slices 64 deep by a
    4-stage TMA ring."""
    if a.device.type == "cpu":
        return plain.gemm_bf16(a, b)
    m, n, k = _gemm_args("gemm_bf16", a, b)
    if n % 8 or k % 8:
        raise ValueError(f"gemm_bf16: [{m}, {k}] · [{k}, {n}] needs N and K multiples of 8")
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    err = build.library().itpu_probe_gemm(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, build.stream_ptr())
    build.check("itpu_probe_gemm", err)
    build.count_launch("probe_gemm")
    return c


def gemm_bf16_wmma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P5 in the design it replaced (WMMA fragments, 128×128 tiles staged
    through shared memory by the threads' loads), for comparisons: not
    counted. M and N multiples of 128, K of 32."""
    if a.device.type == "cpu":
        return plain.gemm_bf16(a, b)
    m, n, k = _gemm_args("gemm_bf16_wmma", a, b)
    bm, bn, bk = WMMA_TILE
    if m % bm or n % bn or k % bk:
        raise ValueError(f"gemm_bf16_wmma: [{m}, {k}] · [{k}, {n}] must be multiples of {WMMA_TILE}")
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    build.check("itpu_probe_gemm_wmma", build.library().itpu_probe_gemm_wmma(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, build.stream_ptr()))
    return c


def _window_sums(name: str, img: torch.Tensor, starts: torch.Tensor, win_h: int, win_w: int,
                 out_w: int) -> torch.Tensor:
    """Window sums launched through the C entry point `name`, the arguments
    checked."""
    _require(name, img, starts)
    build.require_dtype(name, img, torch.float32)
    build.require_dtype(name, starts, torch.int32)
    if img.dim() != 2 or starts.dim() != 2 or starts.shape[1] < 2 or not 0 <= win_w <= out_w:
        raise ValueError(f"{name}: a 2-D image, starts [tiles, ≥ 2] and 0 ≤ win_w ≤ out_w")
    out = torch.empty((starts.shape[0], out_w), dtype=torch.float32, device=img.device)
    err = getattr(build.library(), name)(img.data_ptr(), img.shape[1], starts.data_ptr(), starts.shape[1],
                                         starts.shape[0], win_h, win_w, out.data_ptr(), out_w, build.stream_ptr())
    build.check(name, err)
    return out


def window_sums(img: torch.Tensor, starts: torch.Tensor, win_h: int = 64, win_w: int = 64,
                out_w: int = 128) -> torch.Tensor:
    """P6: out [tiles, out_w], the column sums of each tile's win_h × win_w
    window of float32 img at (starts[t, 0], starts[t, 1]), zero past win_w;
    starts int32 [tiles, ≥ 2], windows inside the image. A warp takes 32
    columns of a tile, 16 rows in flight a lane, summed in r order."""
    if img.device.type == "cpu":
        return plain.window_sums(img, starts, win_h, win_w, out_w)
    out = _window_sums("itpu_probe_window_sums", img, starts, win_h, win_w, out_w)
    build.count_launch("probe_window_sums")
    return out


def window_sums_simple(img: torch.Tensor, starts: torch.Tensor, win_h: int = 64, win_w: int = 64,
                       out_w: int = 128) -> torch.Tensor:
    """P6 in the design it replaced (one CTA a tile, a thread a column),
    for comparisons: not counted; the arguments of `window_sums`."""
    if img.device.type == "cpu":
        return plain.window_sums(img, starts, win_h, win_w, out_w)
    return _window_sums("itpu_probe_window_sums_simple", img, starts, win_h, win_w, out_w)


def l2_read(buf: torch.Tensor, n_ctas: int) -> torch.Tensor:
    """A plain read of float32 `buf` (on no path, not counted; the L2's
    read rate under P3 and P6): out [n_ctas], the sum of the float4 pieces
    i of buf with i // L2_READ_THREADS ≡ cta (mod n_ctas)."""
    if buf.dim() != 1 or buf.numel() % 4 or buf.numel() // 4 >= 2**31 or n_ctas <= 0:
        raise ValueError("l2_read: a 1-D buffer of whole float4 pieces and at least one CTA")
    if buf.device.type == "cpu":
        pieces = buf.reshape(-1, 4).sum(1)
        cta = torch.arange(pieces.numel()) // L2_READ_THREADS % n_ctas
        return torch.zeros(n_ctas, dtype=torch.float32).index_add_(0, cta, pieces)
    _require("l2_read", buf)
    build.require_dtype("l2_read", buf, torch.float32)
    out = torch.empty(n_ctas, dtype=torch.float32, device=buf.device)
    build.check("itpu_l2_read", build.library().itpu_l2_read(buf.data_ptr(), buf.numel() // 4, n_ctas,
                                                             out.data_ptr(), build.stream_ptr()))
    return out
