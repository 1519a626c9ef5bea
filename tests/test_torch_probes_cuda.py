"""Card-only tests of the probes' kernels P1-P6 (csrc/probes.cu,
ops/kernels/probes.py): each kernel against its plain PyTorch twin
(infinitam_tpu_torch/probes/plain.py) at a small size, over the variants the
probes run, with one launch counted a call; and `python -m
infinitam_tpu_torch.probes` run on the card, all nine probes.

Bars: P1, P4 and P2's copies and int8 row stores bit for bit; P2's taps
within 1e-6, and on zero rows (where the scaled tap is the output) bit for
bit, the window sum within 1e-5 of its largest
value; P3 and P6 bit for bit (their sums run in plain's order, or are
exact integers); P5
within the float32 summation bound of the exact product, rounded to bf16
(plain.bf16_product_bound: two correct summation orders can differ by many
bf16 ulps of an element near a zero of its sum), and bit for bit on integer
inputs whose sums are exact in float32.

They carry the `cuda` marker and skip where no card is present. On a machine
with a card (JAX need not be installed there), run them with:

    python -m pytest --noconftest tests/test_torch_probes_cuda.py

chip_smoke.py repeats these comparisons at the probes' full sizes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from infinitam_tpu_torch.ops.kernels import build, probes
from infinitam_tpu_torch.probes import plain, probe6, probe8, probe9, probe10, probe13

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
S3 = 512


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def on(device, *arrays):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def launched(counter, fn):
    """fn()'s result, checked to launch `counter`'s kernel once."""
    build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0) | {counter: 1}
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_gather_equals_plain(device, dtype, axis):
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.integers(-100, 100, (96, 160)).astype(np.float32)).to(dtype).to(device)
    n = tab.numel() if axis is None else tab.shape[axis]
    shape = (3000,) if axis is None else ((40, 160) if axis == 0 else (96, 24))
    (idx,) = on(device, rng.integers(0, n, shape, dtype=np.int32))
    got = launched("probe_gather", lambda: probes.gather(tab, idx, axis))
    assert torch.equal(got, plain.gather(tab, idx, axis))


def test_gather_chain_equals_plain(device):
    """probe6's chain of 32 gathers with feedback, bf16, axis 0."""
    tab, idx = probe6.make_dg(32, 128, "bfloat16", 0)
    tab_t, (idx_t,) = probe6.to_table(tab, "bfloat16", device), on(device, idx)
    got = probe6.call(tab_t, idx_t, 0)
    want = idx_t
    for k in range(probe6.K):
        want = (want + plain.gather(tab_t, want, 0).to(torch.int32) + k) % 32
    assert torch.equal(got, want)


def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous view of a copy of t that starts `offset` elements into
    its buffer (1 and 3 put a 4-byte element off every 16-byte boundary)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int8, torch.bfloat16])
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("small", [False, True])
def test_gather_ragged_views_equal_plain(device, dtype, axis, offset, small):
    """P1 at ragged sizes: n and idx_cols not multiples of 8 (4,099 takes;
    [29, 61] along axis 0; [37, 13] along axis 1), and the smallest (3
    takes; a one-row and a one-column index), with the index and the table
    views at `offset` elements into their buffers; bit for bit, one launch."""
    rng = np.random.default_rng(20 + offset)
    tab = torch.from_numpy(rng.integers(-100, 100, (37, 61)).astype(np.float32)).to(dtype).to(device)
    n = tab.numel() if axis is None else tab.shape[axis]
    shape = {None: (3,) if small else (4099,), 0: (1, 61) if small else (29, 61),
             1: (37, 1) if small else (37, 13)}[axis]
    (idx,) = on(device, rng.integers(0, n, shape, dtype=np.int32))
    tab_v, idx_v = at_offset(tab, offset), at_offset(idx, offset)
    got = launched("probe_gather", lambda: probes.gather(tab_v, idx_v, axis))
    assert torch.equal(got, plain.gather(tab, idx, axis))


def rows_inputs(device, nv: int, n_rows: int = 8192, seed: int = 0):
    """(vba [n_rows, 512], img [512, 768], img_t [768, 512] for the
    transposed tap, ptr (nv distinct rows), the same with every ninth -1
    for the ptr gate to drop, wv < 4, wu < 6, valid 0 on every seventh step
    from the fourth)."""
    rng = np.random.default_rng(seed)
    ptr = rng.permutation(n_rows)[:nv].astype(np.int32)
    return on(device, rng.standard_normal((n_rows, S3)).astype(np.float32),
              rng.standard_normal((512, 768)).astype(np.float32), rng.standard_normal((768, 512)).astype(np.float32),
              ptr, np.where(np.arange(nv) % 9 == 5, -1, ptr).astype(np.int32),
              rng.integers(0, 4, nv, dtype=np.int32), rng.integers(0, 6, nv, dtype=np.int32),
              (np.arange(nv) % 7 != 3).astype(np.int32))


# the tap × gate pairs the probes run (probe7, probe8 K1-K5, probe9, probe10,
# probe12), in place and into a fresh output: name → (row_update keywords,
# tolerance against plain)
ROW_CASES = {
    "copy": (dict(mul=1.000001), 0.0),
    "copy fresh": (dict(mul=1.000001, in_place=False), 0.0),
    "copy static fresh": (dict(mul=1.000001, in_place=False, src_ptr=False, dst_ptr=False), 0.0),
    "bf16": (dict(tap="bf16", tap_scale=1e-3), 1e-6),
    "bf16 valid": (dict(tap="bf16", tap_scale=1e-3, gate="valid"), 1e-6),
    "f32t valid": (dict(tap="f32t", tap_scale=1e-3, gate="valid"), 1e-6),
    "f32t valid fresh": (dict(tap="f32t", tap_scale=1e-3, gate="valid", in_place=False), 1e-6),
    "f32t": (dict(tap="f32t", tap_scale=1e-3, mul=1.000001), 1e-6),
    "f32t fresh": (dict(tap="f32t", tap_scale=1e-9, in_place=False), 1e-6),
    "sum": (dict(tap="sum", tap_scale=1e-9), 1e-6),
    "ptr": (dict(gate="ptr", mul=1.000001), 0.0),
}


def row_case(device, nv, case, fn, zero=False):
    """(fn's output, plain's, the rows to compare, tolerance) of ROW_CASES[case],
    on zero rows where `zero`."""
    vba, img, img_t, ptr, ptr_gated, wv, wu, valid = rows_inputs(device, nv)
    if zero:
        vba = torch.zeros_like(vba)
    kw, tol = ROW_CASES[case]
    p = ptr_gated if kw.get("gate") == "ptr" else ptr
    taps = dict(img=img_t if kw.get("tap") == "f32t" else img, wv=wv, wu=wu, valid=valid)
    got = fn(vba.clone(), p, **taps, **kw)
    want = plain.row_update(vba.clone(), p, **taps, **kw)
    if kw.get("in_place", True):
        rows = slice(None)
    else:
        rows = p.long() if kw.get("dst_ptr", True) else torch.arange(nv, device=device)
    return got, want, rows, tol


def assert_taps_on_zero_rows(got, want, tap):
    """On zero rows the output is the scaled tap itself (a tap of 1e-9 would
    vanish beside a row): the window sum within 1e-5 of the largest value,
    the other taps bit for bit, as chip_smoke.py holds them."""
    err, top = float((got - want).abs().max()), float(want.abs().max())
    assert top > 0
    assert err <= 1e-5 * top if tap == "sum" else torch.equal(got, want)


def assert_row_case(device, nv, case, fn):
    """ROW_CASES[case] through fn against plain within its tolerance, and a
    tap's case again on zero rows."""
    got, want, rows, tol = row_case(device, nv, case, fn)
    assert float((got[rows] - want[rows]).abs().max()) <= tol
    tap = ROW_CASES[case][0].get("tap")
    if tap:
        got, want, rows, _ = row_case(device, nv, case, fn, zero=True)
        assert_taps_on_zero_rows(got[rows], want[rows], tap)


@pytest.mark.parametrize("case", list(ROW_CASES))
@pytest.mark.parametrize("nv", [1, 37, 6001])
def test_row_update_chunks_equal_plain(device, case, nv):
    """P2 at step counts below a warp a step (1, 37) and one whose last
    CTA's chunk is part full (6,001 of 8,192 rows), over the probes'
    tap × gate pairs: copies bit for bit, taps within 1e-6 and on zero rows
    as assert_taps_on_zero_rows, one launch."""
    assert_row_case(device, nv, case, lambda *a, **k: launched("probe_rows", lambda: probes.row_update(*a, **k)))


@pytest.mark.parametrize("case", list(ROW_CASES))
def test_row_update_simple_design_equals_plain(device, case):
    """P2's design it replaced (one CTA a step), at 6,001 steps: as the
    kernel's bars, not counted."""
    build.reset_launch_counts()
    assert_row_case(device, 6001, case, probes.row_update_simple)
    torch.cuda.synchronize()
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


def first_rows(nb: int, nv: int, seed: int = 0) -> np.ndarray:
    """nv rows < nb drawn with repeats; the list starts and ends with a
    repeated row, and its first row is listed three times or more."""
    rows = np.random.default_rng(seed).integers(0, nb, nv).astype(np.int32)
    rows[1], rows[-2], rows[nv // 2] = rows[0], rows[-1], rows[0]
    return rows


@pytest.mark.parametrize("design", ["chunks", "simple"])
@pytest.mark.parametrize("nb,nv", [(8, 6), (64, 300), (8192, 4096), (8192, 5003)])
@pytest.mark.parametrize("offset", [0, 1])
def test_row_stores_first_gate_repeats_equal_plain(device, design, nb, nv, offset):
    """probe13's int8 row stores through the "first" gate: a list that
    starts and ends with a repeat and lists a row three times or more, few
    and many rows, the list as a view off a 16-byte boundary (offset 1): a
    repeated row gains 1 once, 127 wraps, bit for bit with plain."""
    vol = np.random.default_rng(4).integers(-128, 128, (nb, S3)).astype(np.int8)
    vol[:, 0] = 127
    rows = first_rows(nb, nv)
    assert np.bincount(rows).max() >= 3
    vol_t, rows_t = on(device, vol, rows)
    rows_v = at_offset(rows_t, offset)
    fn = probes.row_update if design == "chunks" else probes.row_update_simple
    got = fn(vol_t.clone(), rows_v, gate="first")
    torch.cuda.synchronize()
    assert torch.equal(got, plain.row_update(vol_t.clone(), rows_t, gate="first"))
    assert (got[rows_t.long(), 0] == -128).all()


@pytest.mark.parametrize("case", ["f32 bf16 valid", "f32 sum fresh", "int8 first"])
def test_row_update_rows_off_16_bytes_equal_plain(device, case):
    """Rows that are not whole 16-byte pieces (510 floats, 500 int8) in a
    view one row into its buffer, and the window sum over an image whose
    rows are off 16 bytes (766 columns): element by element in the same
    kernel, as plain; the taps also on zero rows."""
    rng = np.random.default_rng(6)
    nv = 300
    if case == "int8 first":
        vol = at_offset(on(device, rng.integers(-128, 128, (1000, 500)).astype(np.int8))[0], 500)
        (rows,) = on(device, first_rows(1000, nv))
        got = launched("probe_rows", lambda: probes.row_update(vol.clone(), rows, gate="first"))
        assert torch.equal(got, plain.row_update(vol.clone(), rows, gate="first"))
        return
    vba, img = on(device, rng.standard_normal((1000, 510)).astype(np.float32),
                  rng.standard_normal((512, 766)).astype(np.float32))
    vba = at_offset(vba, 510)
    ptr, wv, wu, valid = on(device, rng.permutation(1000)[:nv].astype(np.int32), rng.integers(0, 4, nv, dtype=np.int32),
                            rng.integers(0, 5, nv, dtype=np.int32), (np.arange(nv) % 7 != 3).astype(np.int32))
    if case == "f32 bf16 valid":
        kw, rows = dict(tap="bf16", tap_scale=1e-3, gate="valid", valid=valid), slice(None)
    else:
        kw, rows = dict(tap="sum", tap_scale=1e-9, in_place=False), ptr.long()
    got = launched("probe_rows", lambda: probes.row_update(vba.clone(), ptr, img=img, wv=wv, wu=wu, **kw))
    want = plain.row_update(vba.clone(), ptr, img=img, wv=wv, wu=wu, **kw)
    assert float((got[rows] - want[rows]).abs().max()) <= 1e-6
    zeros = torch.zeros_like(vba)
    got = launched("probe_rows", lambda: probes.row_update(zeros.clone(), ptr, img=img, wv=wv, wu=wu, **kw))
    want = plain.row_update(zeros.clone(), ptr, img=img, wv=wv, wu=wu, **kw)
    assert_taps_on_zero_rows(got[rows], want[rows], kw["tap"])


def test_row_update_window_sum_is_the_same_every_call(device):
    """The sum tap's window sums run in a fixed order: two calls give equal
    bits."""
    vba, img, _t, ptr, _g, wv, wu, _v = rows_inputs(device, 500)
    kw = dict(tap="sum", tap_scale=1e-3, img=img, wv=wv, wu=wu, in_place=False)
    zeros = torch.zeros_like(vba)
    assert torch.equal(probes.row_update(zeros, ptr, **kw)[ptr.long()], probes.row_update(zeros, ptr, **kw)[ptr.long()])


@pytest.mark.parametrize("name,kw,tol", probe8.ATTEMPTS)
def test_row_update_probe8_bodies_equal_plain(device, name, kw, tol):
    vba, depth, ptr, wv, wu = on(device, *probe8.make(512, 64))
    got = launched("probe_rows", lambda: probe8.attempt(probes.row_update, vba.clone(), depth, ptr, wv, wu, **kw))
    want = probe8.attempt(plain.row_update, vba.clone(), depth, ptr, wv, wu, **kw)
    rows = ptr.long() if kw.get("in_place", True) is False else slice(None)
    assert float((got[rows] - want[rows]).abs().max()) <= tol, name


@pytest.mark.parametrize("attempt", range(len(probe10.ATTEMPTS)))
def test_row_update_probe10_attempts_equal_plain(device, attempt):
    name, flags = probe10.ATTEMPTS[attempt]
    args = on(device, *probe10.make(512, 64))
    got = launched("probe_rows", lambda: probe10.attempt(probes.row_update, args[0].clone(), *args[1:], *flags))
    want = probe10.attempt(plain.row_update, args[0].clone(), *args[1:], *flags)
    dynamic, in_place, tap = flags
    rows = slice(None) if in_place else (args[2].long() if dynamic else slice(0, 64))
    assert float((got[rows] - want[rows]).abs().max()) <= (1e-6 if tap else 0.0), name


@pytest.mark.parametrize("tap,tap_scale,gate", [("bf16", 1e-3, "none"), ("f32t", 1e-9, "none"),
                                                 ("f32t", 1e-3, "valid"), ("sum", 1e-9, "none")])
def test_row_update_taps_on_zero_rows_equal_plain(device, tap, tap_scale, gate):
    """On zero rows the output is the scaled tap itself (a 1e-9 tap vanishes
    beside rows of unit size): bit for bit, the window's sum within 1e-5 of
    the largest (its 16,384 terms summed in another order)."""
    _vba, depth, ptr, wv, wu, valid = on(device, *probe9.make(512, 64))
    if tap != "f32t":  # the normal window: the 512×768 image, not the transposed one
        depth = torch.from_numpy(np.random.default_rng(2).standard_normal((512, 768)).astype(np.float32)).to(device)
    kw = dict(tap=tap, img=depth, wv=wv, wu=wu, gate=gate, valid=valid, tap_scale=tap_scale, in_place=False)
    zeros = torch.zeros((512, S3), device=device)
    got = launched("probe_rows", lambda: probes.row_update(zeros, ptr, **kw))[ptr.long()]
    want = plain.row_update(zeros, ptr, **kw)[ptr.long()]
    assert float(want.abs().max()) > 0
    if tap == "sum":
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    else:
        assert torch.equal(got, want)


def test_row_update_valid_gate_equals_plain(device):
    """probe9's update: the transposed tap, the valid gate, in place."""
    args = on(device, *probe9.make(512, 64))
    got = launched("probe_rows", lambda: probe9.update(probes.row_update, args[0].clone(), *args[1:]))
    want = probe9.update(plain.row_update, args[0].clone(), *args[1:])
    assert float((got - want).abs().max()) <= 1e-6


def test_row_stores_add_one_once(device):
    """probe13's int8 row stores: repeated rows gain 1 once, 127 wraps."""
    vol = np.random.default_rng(3).integers(-128, 128, (64, S3)).astype(np.int8)
    vol[:, 0] = 127
    rows = probe13.make_rows(64, 256)
    vol_t, rows_t = on(device, vol, rows)
    got = launched("probe_rows", lambda: probe13.row_stores(probes.row_update, vol_t.clone(), rows_t))
    assert torch.equal(got, plain.row_update(vol_t.clone(), rows_t, gate="first"))
    assert (got[rows_t.long(), 0] == -128).all()


@pytest.mark.parametrize("case", ["kacc", "rk"])
def test_page_sum_equals_plain(device, case):
    if case == "kacc":
        pages, p = on(device, *probe9.make_pages(256, 24))
        ids, k, cols, scale, hashed = p.reshape(-1, 16), 16, S3, 1.0, False
    else:
        pages, pid = on(device, *probe13.make_volume(256, 24))
        ids, k, cols, scale, hashed = pid.reshape(24, -1), 48, 128, 1e-6, True
    got = launched("probe_page_sum", lambda: probes.page_sum(pages, ids, k, cols, scale, hashed))
    assert torch.equal(got, plain.page_sum(pages, ids, k, cols, scale, hashed))


# (dtype, row_len, buffer offset in elements, pages a tile read, ids' columns, columns, hashed): the float4
# path at page counts 1, 10 of 16 and 256; int8 at 1, 47 of 64 and 256 pages, rows of 1,024 and 500 bytes and
# a view off 16 bytes; the float32 element path for rows that are not whole 16-byte pieces, views off 16
# bytes and hashed rows
PAGE_CASES = {
    "f32 k=1": (torch.float32, 512, 0, 1, 16, 512, False),
    "f32 k=10 of 16": (torch.float32, 512, 0, 10, 16, 512, False),
    "f32 k=256": (torch.float32, 512, 0, 256, 256, 512, False),
    "f32 260 of 512 columns": (torch.float32, 512, 0, 16, 16, 260, False),
    "f32 rows of 510": (torch.float32, 510, 0, 16, 16, 510, False),
    "f32 view off 16 bytes": (torch.float32, 512, 1, 16, 16, 512, False),
    "f32 hashed": (torch.float32, 512, 0, 48, 64, 128, True),
    "int8 k=1": (torch.int8, 512, 0, 1, 64, 128, True),
    "int8 k=47 of 64": (torch.int8, 512, 0, 47, 64, 128, True),
    "int8 k=256": (torch.int8, 512, 0, 256, 256, 128, True),
    "int8 rows of 1024": (torch.int8, 1024, 0, 48, 64, 700, True),
    "int8 not hashed": (torch.int8, 512, 0, 48, 64, 512, False),
    "int8 rows of 500": (torch.int8, 500, 0, 48, 64, 128, True),
    "int8 view off 16 bytes": (torch.int8, 512, 3, 48, 64, 128, True),
}


@pytest.mark.parametrize("design", ["columns", "simple"])
@pytest.mark.parametrize("case", list(PAGE_CASES))
def test_page_sum_paths_equal_plain(device, case, design):
    """P3 over its 16-byte and element paths, page counts 1 to 256 and
    ids with more columns than pages read; int8 pages in [-128, 128) at
    256 pages a tile (the widest integer sums): bit for bit with plain, one
    launch counted (the simple design none)."""
    dtype, row_len, offset, k, id_cols, cols, hashed = PAGE_CASES[case]
    rng = np.random.default_rng(8)
    rows = 300
    if dtype == torch.int8:
        pages = rng.integers(-128, 128, (rows, row_len)).astype(np.int8)
    else:
        pages = rng.standard_normal((rows, row_len)).astype(np.float32)
    pages_t, ids = on(device, pages, rng.integers(0, rows, (40, id_cols), dtype=np.int32))
    pages_v = at_offset(pages_t, offset)
    scale = 1e-6 if hashed else 1.0
    want = plain.page_sum(pages_t, ids, k, cols, scale, hashed)
    if design == "columns":
        got = launched("probe_page_sum", lambda: probes.page_sum(pages_v, ids, k, cols, scale, hashed))
    else:
        build.reset_launch_counts()
        got = probes.page_sum_simple(pages_v, ids, k, cols, scale, hashed)
        torch.cuda.synchronize()
        assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rows_per_cta", [1, 8, 64])
def test_scaled_copy_equals_plain(device, rows_per_cta):
    (x,) = on(device, np.random.default_rng(4).standard_normal((512, S3)).astype(np.float32))
    got = launched("probe_scale", lambda: probes.scaled_copy(x, rows_per_cta))
    assert torch.equal(got, plain.scaled_copy(x, rows_per_cta))


@pytest.mark.parametrize("values", ["normal", "integer"])
def test_gemm_equals_plain(device, values):
    """[256, 96] · [96, 384]: non-square, so a swapped index shows."""
    rng = np.random.default_rng(5)
    shapes = ((256, 96), (96, 384))
    if values == "normal":
        a, b = (rng.standard_normal(s).astype(np.float32) for s in shapes)
    else:
        a, b = (rng.integers(-8, 9, s).astype(np.float32) for s in shapes)
    a_t, b_t = (t.to(torch.bfloat16) for t in on(device, a, b))
    got = launched("probe_gemm", lambda: probes.gemm_bf16(a_t, b_t))
    want = plain.gemm_bf16(a_t, b_t)
    if values == "integer":
        assert torch.equal(got, want)
    else:
        assert float(plain.bf16_product_bound(got, a_t, b_t).max()) <= 1.0


@pytest.mark.parametrize("rows_per_cta,row_len", [(1, 512), (3, 512), (8, 512), (1024, 512), (9, 512), (40, 512),
                                                  (5, 1000), (2, 4)])
def test_scaled_copy_ring_equals_plain(device, rows_per_cta, row_len):
    """P4's ring of 16 KB chunks in 4 stages, 7 CTAs: blocks of one chunk
    and less (1, 3, 8 rows, 2 rows of 4 floats), a last chunk cut short (9
    rows: 16 KB + 2 KB; 5 rows of 1,000 floats: 16 KB + 3.5 KB), chunk
    counts that are not a multiple of the ring's depth (40 rows: 5 chunks)
    and one that is (1,024 rows: 128 chunks); bit for bit."""
    rng = np.random.default_rng(rows_per_cta)
    (x,) = on(device, rng.standard_normal((7 * rows_per_cta, row_len)).astype(np.float32))
    got = launched("probe_scale", lambda: probes.scaled_copy(x, rows_per_cta))
    assert torch.equal(got, plain.scaled_copy(x, rows_per_cta))


@pytest.mark.parametrize("rows_per_cta", [1, 9, 1024])
def test_scaled_copy_simple_design_equals_plain(device, rows_per_cta):
    """P4's design the ring replaced, kept for comparisons: bit for bit, and
    not counted."""
    (x,) = on(device, np.random.default_rng(8).standard_normal((3 * rows_per_cta, S3)).astype(np.float32))
    build.reset_launch_counts()
    got = probes.scaled_copy_simple(x, rows_per_cta)
    torch.cuda.synchronize()
    assert torch.equal(got, plain.scaled_copy(x, rows_per_cta))
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


@pytest.mark.parametrize("values", ["normal", "integer"])
@pytest.mark.parametrize("m,k,n", [(128, 64, 256), (128, 96, 384), (200, 136, 136), (384, 1000, 520)])
def test_gemm_off_the_tile_equals_plain(device, m, k, n, values):
    """P5's 128×256×64 tiles at shapes off them: one 128-row M, K not a
    multiple of 64 (the TMA fills the last stage past K with zeros), N not a
    multiple of 256 (a tile's columns past N are not stored; 136 leaves a
    64-column box wholly past N), M not a multiple of 128."""
    rng = np.random.default_rng(m + k + n)
    if values == "normal":
        a, b = (rng.standard_normal(s).astype(np.float32) for s in ((m, k), (k, n)))
    else:
        a, b = (rng.integers(-8, 9, s).astype(np.float32) for s in ((m, k), (k, n)))
    a_t, b_t = (t.to(torch.bfloat16) for t in on(device, a, b))
    got = launched("probe_gemm", lambda: probes.gemm_bf16(a_t, b_t))
    if values == "integer":
        assert torch.equal(got, plain.gemm_bf16(a_t, b_t))
    else:
        assert float(plain.bf16_product_bound(got, a_t, b_t).max()) <= 1.0


def test_gemm_2048_on_integers_is_bit_equal(device):
    """probe11's 2048³ on integer inputs in [-8, 8]: every partial sum is
    exact in float32, so any order of the sum gives plain's bits."""
    rng = np.random.default_rng(9)
    a, b = (rng.integers(-8, 9, (2048, 2048)).astype(np.float32) for _ in range(2))
    a_t, b_t = (t.to(torch.bfloat16) for t in on(device, a, b))
    got = launched("probe_gemm", lambda: probes.gemm_bf16(a_t, b_t))
    assert torch.equal(got, plain.gemm_bf16(a_t, b_t))


def test_gemm_wmma_design_equals_plain(device):
    """P5's design the wgmma ring replaced, kept for comparisons: bit for bit
    on integer inputs, within the bound on normal ones, not counted."""
    rng = np.random.default_rng(10)
    a, b = (t.to(torch.bfloat16) for t in on(device, rng.integers(-8, 9, (256, 96)).astype(np.float32),
                                             rng.integers(-8, 9, (96, 384)).astype(np.float32)))
    build.reset_launch_counts()
    assert torch.equal(probes.gemm_bf16_wmma(a, b), plain.gemm_bf16(a, b))
    a, b = (t.to(torch.bfloat16) for t in on(device, rng.standard_normal((256, 96)).astype(np.float32),
                                             rng.standard_normal((96, 384)).astype(np.float32)))
    assert float(plain.bf16_product_bound(probes.gemm_bf16_wmma(a, b), a, b).max()) <= 1.0
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)


def test_gemm_refuses_rows_the_tensor_maps_cannot_take(device):
    """The tensor maps need rows of 16-byte multiples: N and K multiples of 8."""
    a = torch.zeros((128, 100), dtype=torch.bfloat16, device=device)
    with pytest.raises(ValueError):
        probes.gemm_bf16(a, torch.zeros((100, 128), dtype=torch.bfloat16, device=device))
    with pytest.raises(ValueError):
        probes.gemm_bf16(a[:, :96].contiguous(), torch.zeros((96, 100), dtype=torch.bfloat16, device=device))


def test_window_sums_equal_plain(device):
    img, starts = on(device, *probe13.make_window(64))
    got = launched("probe_window_sums", lambda: probe13.window_sums(probes.window_sums, img, starts))
    assert torch.equal(got, plain.window_sums(img, starts.reshape(64, -1)))


def test_page_sum_refuses_more_columns_than_a_row(device):
    """Unhashed columns must lie in the row: plain would index past it."""
    pages = torch.zeros((4, 16), dtype=torch.float32, device=device)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        probes.page_sum(pages, ids, 3, 17)


# (image, window rows, window columns, output columns): probe13's shape; windows of a width that is not a
# whole number of warps or 16-byte pieces, with scalar zero columns; one of no columns
WINDOW_CASES = {
    "probe13": ((512, 768), 64, 64, 128),
    "37x50 into 61": ((100, 90), 37, 50, 61),
    "20x200 into 256": ((300, 300), 20, 200, 256),
    "5x0 into 8": ((100, 90), 5, 0, 8),
}


@pytest.mark.parametrize("design", ["warps", "simple"])
@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_sums_at_the_last_start_equal_plain(device, case, design):
    """P6 with windows at the image's last legal start (rows, columns or
    both) and at random ones, over starts with a third column: bit for bit
    with plain, zero past win_w, one launch counted (the simple design
    none)."""
    (h, w), win_h, win_w, out_w = WINDOW_CASES[case]
    rng = np.random.default_rng(9)
    nt = 40
    a = rng.integers(0, h - win_h + 1, nt)
    b = rng.integers(0, w - win_w + 1, nt)
    a[::2], b[::3], a[1], b[1] = h - win_h, w - win_w, 0, 0
    img, starts = on(device, rng.standard_normal((h, w)).astype(np.float32),
                     np.stack([a, b, np.full(nt, 99)], axis=1).astype(np.int32))
    want = plain.window_sums(img, starts, win_h, win_w, out_w)
    if design == "warps":
        got = launched("probe_window_sums", lambda: probes.window_sums(img, starts, win_h, win_w, out_w))
    else:
        build.reset_launch_counts()
        got = probes.window_sums_simple(img, starts, win_h, win_w, out_w)
        torch.cuda.synchronize()
        assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert torch.equal(got, want)
    assert (got[:, win_w:] == 0).all()


@pytest.mark.parametrize("n_ctas", [1, 132, 1056])
def test_l2_read_sums_each_ctas_share(device, n_ctas):
    """The plain read under the smoke's L2 floor: each CTA's sum of its
    float4 pieces, on integers (exact in any order), as the plain version
    strides them; a buffer not a whole number of strides."""
    rng = np.random.default_rng(10)
    (buf,) = on(device, rng.integers(-8, 8, 4 * 300_001).astype(np.float32))
    assert torch.equal(probes.l2_read(buf, n_ctas).cpu(), probes.l2_read(buf.cpu(), n_ctas))


def test_probes_entry_point_runs_on_the_card(device):
    """`python -m infinitam_tpu_torch.probes`: all nine probes on the card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-m", "infinitam_tpu_torch.probes"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout
    assert f"device: {torch.cuda.get_device_name(0)}" in out
    assert all(f"--- {name}" in out for name in ("probe2", "probe6", "probe7", "probe8", "probe9", "probe10",
                                                  "probe11", "probe12", "probe13"))
    assert "FAIL" not in out and "device not measured" not in out
