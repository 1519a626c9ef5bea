"""The frozen traffic counts (perfbench/reference.py with `counts`) against
counts made by hand at a tiny size."""

from __future__ import annotations

import torch

from conftest import tiny_config
from perfbench import reference as R
from perfbench.roofline import least_per_step, least_seconds

IMG = (6, 8)
PROJ = (8.0, 8.0, 3.5, 2.5)


def fresh(kind="hash", cfg=None):
    counts = [{k: 0 for k in ("icp_bytes", "icp_ops", "integrate_bytes", "integrate_ops", "raycast_bytes",
                              "raycast_ops")}]
    return R.Reference(cfg or tiny_config(kind), IMG, PROJ, "cpu", counts=counts), counts


def test_icp_launch_counts_every_pixel_and_each_distinct_tap():
    ref, counts = fresh()
    H, W = IMG
    depth = torch.ones(IMG)
    eye = torch.eye(4)
    fx, fy, cx, cy = PROJ
    xs = torch.arange(W, dtype=torch.float32)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32)[:, None].expand(H, W)
    pmap = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones(IMG), torch.ones(IMG)], -1)
    nmap = torch.zeros(H, W, 4)
    nmap[..., 2] = -1.0
    nmap[..., 3] = 1.0
    _b, _A, valid = ref._icp_terms(depth, 0, eye, pmap, nmap, eye)
    # each pixel projects onto itself: the in-frame pixels are x ≤ W−2,
    # y ≤ H−2, and their four corners cover every pixel once; all of them
    # pass the gates, so the normals' taps cover every pixel again
    assert int(valid.sum()) == (W - 1) * (H - 1)
    assert counts[0]["icp_bytes"] == H * W * 4 + 16 * (2 * H * W) + 2 * 16 + 2 * 48 + 44 * 4
    assert counts[0]["icp_ops"] == H * W * R.ICP_OPS_PIXEL + (W - 1) * (H - 1) * R.ICP_OPS_VALID


def test_integrate_counts_against_a_voxel_by_voxel_count():
    ref, counts = fresh()
    depth = torch.full(IMG, 1.01)  # off the voxel planes, so no voxel sits on the band's edge
    ref.integrate(depth, torch.eye(4))
    c = counts[0]
    # the same rules, voxel by voxel, over the reference's visible blocks
    S, vs, mu = ref.p.block, ref.p.voxel, ref.p.mu
    H, W = IMG
    fx, fy, cx, cy = PROJ
    pixels, n_upd = set(), 0
    bx, by, bz = (t.tolist() for t in R.unpack_keys(ref.visible))
    for b in zip(bx, by, bz):
        for i in range(S**3):
            x, y, z = ((b[0] * S + i % S) * vs, (b[1] * S + (i // S) % S) * vs, (b[2] * S + i // (S * S)) * vs)
            if z <= 0:
                continue
            u, v = fx * x / z + cx, fy * y / z + cy
            if not (1 <= u <= W - 2 and 1 <= v <= H - 2):
                continue
            pixels.add(int(v + 0.5) * W + int(u + 0.5))
            n_upd += 1.01 - z >= -mu
    n_vis = ref.visible.numel()
    assert n_vis > 0
    assert c["integrate_bytes"] == 20 * n_vis + 65 + 4 * len(pixels) + 8 * n_upd
    assert c["integrate_ops"] == n_vis * S**3 * R.INTEGRATE_OPS_VOXEL + n_upd * R.INTEGRATE_OPS_UPDATE


def test_dense_integrate_counts_against_a_voxel_by_voxel_count():
    cfg = tiny_config("dense")
    X, Y, Z = 32, 32, 16
    cfg["settings"]["plain"].update(size=[X, Y, Z], offset=[-16, -16, 40])  # z 0.80-1.10 m, wider than the view
    ref, counts = fresh(cfg=cfg)
    depth = torch.full(IMG, 1.01)
    depth[0, :3] = 0.0  # holes: a voxel that taps one is in frame but not updated
    t = (0.0037, -0.0021, 0.0013)  # off the voxel planes, so no voxel sits on a gate's edge
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor(t)
    ref.integrate(depth, pose)
    c = counts[0]
    # the same rules, voxel by voxel, over the whole array
    vs, mu = ref.p.voxel, ref.p.mu
    H, W = IMG
    fx, fy, cx, cy = PROJ
    ox, oy, oz = ref.p.dense_offset
    pixels, n_in, n_upd = set(), 0, 0
    for k in range(Z):
        for j in range(Y):
            for i in range(X):
                x, y, z = ((i + ox) * vs + t[0], (j + oy) * vs + t[1], (k + oz) * vs + t[2])
                u, v = fx * x / z + cx, fy * y / z + cy
                if not (1 <= u <= W - 2 and 1 <= v <= H - 2):
                    continue
                p = int(v + 0.5) * W + int(u + 0.5)
                pixels.add(p)
                n_in += 1
                d = float(depth.reshape(-1)[p])
                n_upd += d > 0 and d - z >= -mu
    assert 0 < n_upd < n_in < X * Y * Z
    assert int((ref.w > 0).sum()) == n_upd
    assert c["integrate_bytes"] == 4 * len(pixels) + 16 * n_upd + 4 * (X + Y + Z) + 48 + 16
    assert c["integrate_ops"] == n_in * R.INTEGRATE_OPS_VOXEL + n_upd * R.INTEGRATE_OPS_DENSE_UPDATE


def test_raycast_of_an_empty_map_reads_each_ray_once():
    ref, counts = fresh()
    ref.raycast(torch.eye(4))
    H, W = IMG
    # no visible block: every pixel's range is empty at the far plane, so
    # each ray reads one empty voxel there and stops
    far = ref.p.fmax / ref.p.voxel
    fx, fy, cx, cy = PROJ
    cells = set()
    for yy in range(H):
        for xx in range(W):
            d = torch.tensor([(xx - cx) / fx, (yy - cy) / fy, 1.0])
            p = torch.floor(d * far + 0.5).long()
            blk = torch.div(p, ref.p.block, rounding_mode="floor")
            g = blk - torch.tensor(ref.p.grid_origin)
            if all(0 <= int(g[i]) < ref.p.grid_dims[i] for i in range(3)):
                cells.add(tuple(g.tolist()))
    assert counts[0]["raycast_ops"] == H * W * (R.RAYCAST_OPS_RAY + R.RAYCAST_OPS_READ + R.RAYCAST_OPS_EMPTY)
    assert counts[0]["raycast_bytes"] == H * W * 24 + 64 + 4 * len(cells)


def test_least_time_takes_the_larger_bound_and_sums_lanes():
    assert least_seconds(3.35e12, 0) == 1.0
    assert least_seconds(0, 67e12) == 1.0
    frame = {"icp_bytes": 3.35e9, "icp_ops": 0}
    assert least_per_step([[frame, frame], [frame, frame]], "icp") == 2e-3
