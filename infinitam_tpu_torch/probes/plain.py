"""Plain PyTorch twins of the probes' kernels P1-P6 (csrc/probes.cu).

Each function computes what its kernel computes, with the same float32
operations in the same order where the kernel has one (the P2 row update's
tap, scale and factor; P3's and P6's sums, taken in the kernel's order), so
that on the card a kernel is held to its twin bit for bit where no sum
order differs. The kernel wrappers (`ops/kernels/probes.py`) take these for
tensors on the CPU; the tests hold them to the JAX probes' Pallas bodies,
and chip_smoke.py holds each kernel to them on the card.
"""

from __future__ import annotations

import torch

WIN = 128  # the probes' window: 128×128 pixels of the padded 512×768 depth image
TAPS = ("none", "bf16", "f32t", "sum")
GATES = ("none", "valid", "ptr", "first")


def gather(tab: torch.Tensor, idx: torch.Tensor, axis=None) -> torch.Tensor:
    """P1: `take` (axis None: the table flattened, the output shaped as
    `idx`) or `take_along_axis` on axis 0 or 1 of a 2-D table. Indices
    must lie in range."""
    i = idx.long()
    if axis is None:
        return tab.reshape(-1)[i.reshape(-1)].reshape(idx.shape)
    if axis == 0:
        return tab[i, torch.arange(idx.shape[1], device=idx.device)[None, :]]
    if axis == 1:
        return tab[torch.arange(idx.shape[0], device=idx.device)[:, None], i]
    raise ValueError(f"gather: axis {axis} is not None, 0 or 1")


def window_taps(img: torch.Tensor, wv: torch.Tensor, wu: torch.Tensor, row_len: int, tap: str) -> torch.Tensor:
    """[steps, row_len] float32 taps of the P2 row update: element k of step
    i reads its window at dv = (3k + i) mod 128, du = 7·dv mod 128; "bf16"
    img[wv·128 + dv, wu·128 + du] rounded to bfloat16, "f32t" the transposed
    img[wu·128 + du, wv·128 + dv], "sum" the whole window's sum."""
    steps = torch.arange(wv.shape[0], device=img.device)[:, None]
    k = torch.arange(row_len, device=img.device)[None, :]
    v0, u0 = wv.long()[:, None] * WIN, wu.long()[:, None] * WIN
    dv = (3 * k + steps) % WIN
    du = (7 * dv) % WIN
    if tap == "bf16":
        return img[v0 + dv, u0 + du].to(torch.bfloat16).float()
    if tap == "f32t":
        return img[u0 + du, v0 + dv]
    if tap == "sum":
        h, w = img.shape[0] // WIN, img.shape[1] // WIN
        sums = img[:h * WIN, :w * WIN].reshape(h, WIN, w, WIN).sum(dim=(1, 3))
        return sums[wv.long(), wu.long()][:, None].expand(-1, row_len)
    raise ValueError(f"window_taps: tap {tap!r} is not one of {TAPS[1:]}")


def first_steps(ptr: torch.Tensor) -> torch.Tensor:
    """The steps that list their row first (in step order)."""
    order = torch.argsort(ptr, stable=True)
    s = ptr[order]
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return torch.sort(order[first]).values


def row_update(vba: torch.Tensor, ptr: torch.Tensor, *, in_place: bool = True, src_ptr: bool = True,
               dst_ptr: bool = True, tap: str = "none", img=None, wv=None, wu=None, gate: str = "none",
               valid=None, tap_scale: float = 0.0, mul: float = 1.0) -> torch.Tensor:
    """P2: step i of len(ptr) reads row src(i) of `vba` [rows, row_len] and
    writes row dst(i) (each ptr[i], or i) of the output: `vba` itself with
    `in_place`, else a fresh tensor of which only the written rows are
    defined. float32 rows: out = gate ? (row + tap · tap_scale) · mul : row
    (no tap: row · mul), gates "none", "valid" (valid[i] > 0) and "ptr"
    (ptr[i] ≥ 0; a step with ptr[i] < 0 touches nothing). int8 rows (gate
    "first", no tap): row + 1 with int8 wrap-around, once for a row listed
    by several steps (the first of them updates it). Precondition of every
    gate but "first": the written rows are distinct; raises otherwise."""
    if tap not in TAPS or gate not in GATES:
        raise ValueError(f"row_update: tap {tap!r} or gate {gate!r} unknown")
    out = vba if in_place else torch.empty_like(vba)
    steps = torch.arange(ptr.shape[0], device=vba.device)
    p = ptr.long()
    if gate == "ptr":
        steps = steps[p >= 0]
    elif gate == "first":
        steps = first_steps(p)
    src = p[steps] if src_ptr else steps
    dst = p[steps] if dst_ptr else steps
    if gate != "first" and torch.unique(dst).numel() != dst.numel():
        raise ValueError("row_update: two steps write one row (the kernel's precondition: distinct rows)")
    rows = vba[src]
    if vba.dtype == torch.int8:
        if tap != "none" or gate != "first":
            raise ValueError("row_update: int8 rows take no tap and the gate 'first'")
        out[dst] = (rows.int() + 1).to(torch.int8)
        return out
    new = rows
    if tap != "none":
        # the tap's position depends on the step's index in the whole list
        new = rows + window_taps(img, wv, wu, vba.shape[1], tap)[steps] * tap_scale
    new = new * mul
    if gate == "valid":
        new = torch.where(valid[steps][:, None] > 0, new, rows)
    out[dst] = new
    return out


def page_sum(pages: torch.Tensor, ids: torch.Tensor, k_pages: int, n_cols: int, scale: float = 1.0,
             hashed: bool = False) -> torch.Tensor:
    """P3: out[t, c] = scale · Σ_{k<k_pages} f32(pages[ids[t, k], sel(t, c)]),
    sel = c, or (17c + t) mod row_len when `hashed`; `ids` [tiles, ≥ k_pages]
    (its first k_pages columns are read); the sum runs in k order."""
    nt, row_len = ids.shape[0], pages.shape[1]
    c = torch.arange(n_cols, device=pages.device)[None, :]
    sel = (17 * c + torch.arange(nt, device=pages.device)[:, None]) % row_len if hashed else c
    rows = ids[:, :k_pages].long()
    s = torch.zeros((nt, n_cols), dtype=torch.float32, device=pages.device)
    for k in range(k_pages):
        s = s + pages[rows[:, k:k + 1], sel].float()
    return s * scale


def scaled_copy(x: torch.Tensor, rows_per_cta: int, mul: float = 1.000001) -> torch.Tensor:
    """P4: x · mul (`rows_per_cta` sets only the kernel's decomposition)."""
    del rows_per_cta
    return x * mul


def gemm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P5: bf16(a · b) for bf16 a [M, K] and b [K, N], the product in
    float32 (on the card in full float32: PyTorch's default keeps TF32 off
    for matrix products)."""
    return (a.float() @ b.float()).to(torch.bfloat16)


def window_sums(img: torch.Tensor, starts: torch.Tensor, win_h: int = 64, win_w: int = 64,
                out_w: int = 128) -> torch.Tensor:
    """P6: out[t, c] = Σ_{r<win_h} img[a_t + r, b_t + c] for c < win_w and 0
    for win_w ≤ c < out_w, (a_t, b_t) = starts[t, :2]; the sum in r order.
    Windows must lie inside the image."""
    a, b = starts[:, 0].long(), starts[:, 1].long()
    cols = b[:, None] + torch.arange(win_w, device=img.device)[None, :]
    s = torch.zeros((starts.shape[0], win_w), dtype=torch.float32, device=img.device)
    for r in range(win_h):
        s = s + img[(a + r)[:, None], cols]
    out = torch.zeros((starts.shape[0], out_w), dtype=torch.float32, device=img.device)
    out[:, :win_w] = s
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x|: 2^(e − 7) on [2^e, 2^(e+1))."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 7)


def bf16_product_bound(got: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|got − a·b| over its allowance for a product of bf16 a [M, K] and b
    [K, N] accumulated in float32 and rounded to bf16: half a bf16 ulp of
    `got` plus γ_{K−1} · (|a|·|b|), the float32 summation's error bound for
    any order (γ_n = n·u / (1 − n·u), u = 2⁻²⁴; Higham, Accuracy and
    Stability of Numerical Algorithms, §3.1). The exact product is taken in
    float64 (exact for bf16 inputs at these depths). ≤ 1 on every element
    for any correct order of the sum; two correct orders can still differ by
    many bf16 ulps of an element near a zero of its sum."""
    k, u = a.shape[1], 2.0 ** -24
    gamma = (k - 1) * u / (1 - (k - 1) * u)
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    return (got.double() - exact).abs() / (0.5 * bf16_ulp(got).double() + gamma * scale)
