"""View building ops: raw depth conversion, the depth bilateral filter and
the sensor-noise normals (counterpart of infinitam_tpu/ops/view_ops.py;
reference: ITMViewBuilder.h:7-114 convertDisparityToDepth,
convertDepthAffineToFloat, filterDepth, computeNormalAndWeight).

Plain tensor ops on the whole image; the JAX package leaves these to XLA
and so does the port (no hand kernel). The bilateral filter stacks its 25
taps into one [25, H, W] tensor (one `unfold`), so a pass is ~30 ops
whatever the window."""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from infinitam_tpu_torch.ops.raycast import norm3

# reference: MEAN_SIGMA_L in ITMViewBuilder.h:30
_MEAN_SIGMA_L = 1.2232
# the 5×5 window's offsets, i (rows) outer and j (columns) inner, as the JAX
# package's loop visits them and F.unfold lays them out
_TAPS = [(i, j) for i in range(-2, 3) for j in range(-2, 3)]


def disparity_to_depth(disparity: torch.Tensor, a: float, b: float, fx_depth: float) -> torch.Tensor:
    """Kinect disparity → metric depth: 8·b·fx/(a − d); invalid → −1."""
    disp = a - disparity.to(torch.float32)
    zero = disp == 0.0
    # a full tensor numerator: `scalar / tensor` would compute a reciprocal
    # and a product, one rounding more than the reference's division
    num = torch.full_like(disp, 8.0 * b * fx_depth)
    depth = torch.where(zero, torch.zeros_like(disp), num / torch.where(zero, torch.ones_like(disp), disp))
    return torch.where(depth > 0.0, depth, torch.full_like(depth, -1.0))


def depth_affine_to_float(raw: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Affine raw → metric depth: a·raw + b; raw <= 0 or > 32000 invalid → −1."""
    raw = raw.to(torch.float32)
    invalid = (raw <= 0) | (raw > 32000)
    return torch.where(invalid, torch.full_like(raw, -1.0), raw * a + b)


@functools.cache
def _spatial_terms(device: torch.device) -> torch.Tensor:
    """(|i| + |j|)·σ_L² of each tap as float32 [25, 1, 1], each computed in
    double and rounded once, as the JAX package's Python constants are;
    made once per device (a copy from the host would wait for the card)."""
    c = [(abs(i) + abs(j)) * _MEAN_SIGMA_L * _MEAN_SIGMA_L for i, j in _TAPS]
    return torch.tensor(c, dtype=torch.float32, device=device)[:, None, None]


def bilateral_filter_depth(depth: torch.Tensor) -> torch.Tensor:
    """One pass of the reference's depth-adaptive 5×5 bilateral filter
    (filterDepth; the view builder applies 5 passes). The 2 px border passes
    through unfiltered; invalid (< 0) pixels stay −1.

    The taps are summed over the stacked axis, not one after another as the
    JAX package's loop adds them, so a pass rounds differently by a few
    ulps (tests/test_torch_view.py states the tolerance)."""
    z = depth
    H, W = z.shape
    valid = z >= 0.0
    sigma_z = 1.0 / (0.0012 + 0.0019 * (z - 0.4) ** 2 + 0.0001 / torch.sqrt(z.clamp(min=1e-6)) * 0.25)
    # [25, H, W]: the 5×5 neighbourhood of each pixel, i (rows) outer
    taps = F.unfold(F.pad(z[None, None], (2, 2, 2, 2), value=-1.0), 5).view(25, H, W)
    dz2 = (taps - z) ** 2
    w = torch.where(taps >= 0.0, torch.exp(-0.5 * (_spatial_terms(z.device) + dz2 * sigma_z * sigma_z)), 0.0)
    # an invalid tap has w = 0, so its −1 adds nothing to the sum
    num = (w * taps).sum(dim=0)
    den = w.sum(dim=0)
    filtered = torch.where(den > 0, num / den.clamp(min=1e-20), -1.0)
    out = torch.where(valid, filtered, -1.0)
    result = z.clone()
    result[2:-2, 2:-2] = out[2:-2, 2:-2]  # the 2 px border keeps its input
    return result


def compute_normals_and_weights(depth: torch.Tensor, intrinsics) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel camera-frame surface normal and depth-noise σ_z for WICP
    (computeNormalAndWeight). Returns (normals [H, W, 4] with w = ±1
    validity, sigma_z [H, W] with −1 where invalid). `intrinsics` is an
    `Intrinsics` (fx, fy, cx, cy as Python floats)."""
    H, W = depth.shape
    dev = depth.device
    cx, cy = intrinsics.cx, intrinsics.cy
    # the reference multiplies by 1/fx, 1/fy ("projParams inverted")
    inv_fx, inv_fy = 1.0 / intrinsics.fx, 1.0 / intrinsics.fy

    p = F.pad(depth[None, None], (1, 1, 1, 1), value=-1.0)[0, 0]
    z = depth
    zxp = p[1: 1 + H, 2: 2 + W]  # depth at (x+1, y)
    zxm = p[1: 1 + H, 0:W]  # (x-1, y)
    zyp = p[2: 2 + H, 1: 1 + W]  # (x, y+1)
    zym = p[0:H, 1: 1 + W]  # (x, y-1)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)

    def unproject(zv, x_pix, y_pix):
        return zv * (x_pix - cx) * inv_fx, zv * (y_pix - cy) * inv_fy, zv

    xp1 = unproject(zxp, xs + 1.0, ys)
    xm1 = unproject(zxm, xs - 1.0, ys)
    yp1 = unproject(zyp, xs, ys + 1.0)
    ym1 = unproject(zym, xs, ys - 1.0)
    a = [u - v for u, v in zip(xp1, xm1)]  # diff_x
    b = [u - v for u, v in zip(yp1, ym1)]  # diff_y

    def cross(i, j, k, m):
        # a_i·b_j − a_k·b_m rounded as `jnp.cross` on the CPU: one fused
        # multiply-add, fma(a_i, b_j, −(a_k·b_m)), here in float64 (where
        # the float32 product is exact) rounded once to float32
        return (a[i].double() * b[j].double() - (a[k] * b[m]).double()).float()

    n = [cross(1, 2, 2, 1), cross(2, 0, 0, 2), cross(0, 1, 1, 0)]
    # jnp.linalg.norm of 3 components, rounded as the JAX package rounds it
    norm = norm3(*n)
    valid = (z >= 0) & (zxp > 0) & (zxm > 0) & (zyp > 0) & (zym > 0) & (norm > 0)
    n = [c / norm.clamp(min=1e-20) for c in n]

    theta = torch.arccos(n[2].clamp(-1.0, 1.0))
    denom = math.pi * 0.5 - theta
    theta_diff = theta / torch.where(denom.abs() < 1e-6, torch.full_like(denom, 1e-6), denom)
    sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2 + 0.0001 / torch.sqrt(z.clamp(min=1e-6)) * theta_diff**2

    zero = torch.zeros_like(z)
    normals = torch.stack([torch.where(valid, c, zero) for c in n] + [torch.where(valid, 1.0, -1.0)], dim=-1)
    return normals, torch.where(valid, sigma, torch.full_like(sigma, -1.0))
