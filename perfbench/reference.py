"""Plain PyTorch reference of the two configurations' frame step.

What InfiniTAM v2 does to each depth frame (ITMMainEngine::ProcessFrame):
track the camera by coarse-to-fine point-to-plane ICP against the last
raycast (ITMDepthTracker), allocate the voxel blocks that the ±μ band of each
depth ray crosses (the hash volume's AllocateSceneFromDepth), fuse the frame
into the TSDF of the visible blocks or of the whole dense array
(IntegrateIntoScene), and raycast the next frame's point and normal maps
(CreateICPMaps). It is written from those semantics and the configuration
file alone: it imports nothing of the program under test, keeps its map in
structures of its own (a sorted table of block keys with unbounded extent,
or the dense array), and runs every loop on the host where the reference
breaks out of it.

`dtype` is the precision of the arithmetic: float32 as the configuration
states, or a lower one (bfloat16) for the control that the comparison must
reject. The running TSDF is stored as the configuration's voxel type: int16
scaled by 32767 and a uint8 weight for the hash volume (ITMVoxel_s), float32
for the dense array (ITMVoxel_f).

With `counts` the reference also records, for each frame, what each of the
frame's kernels must read, write and compute on these inputs
(perfbench/roofline.py turns it into a least time).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

KEY_BITS = 20
KEY_BIAS = 1 << (KEY_BITS - 1)
SDF_SCALE = 32767.0

# float32 operations a kernel spends on each unit of work (csrc/*.cu of the
# port as PR 3-11 counted them; a multiply-add counts 2)
ICP_OPS_PIXEL = 116  # back-projection, two transforms, projection, the point tap, the gate
ICP_OPS_VALID = 121  # a valid pixel's normal tap, b, A and its 29 products and sums
INTEGRATE_OPS_VOXEL = 37  # centre, transform, projection, depth tap, η and its gate
INTEGRATE_OPS_UPDATE = 12  # an updated voxel's running average and quantisation
INTEGRATE_OPS_DENSE_UPDATE = 8  # K2d's updated voxel: the running average, no quantisation
RAYCAST_OPS_RAY = 80  # the ray from the pixel and its two depth bounds
RAYCAST_OPS_READ = 10  # every march step: + 0.5, floor and convert per axis, the sdf ≤ 0 test
RAYCAST_OPS_DECODE = 2  # a hash voxel's int16 sdf: convert and scale
RAYCAST_OPS_FOUND = 10  # a found voxel's step
RAYCAST_OPS_EMPTY = 34  # an empty voxel's step to the block's exit
RAYCAST_OPS_HIT = 95  # a hit's secant step and two trilinear refinements


def pack_keys(bx: torch.Tensor, by: torch.Tensor, bz: torch.Tensor) -> torch.Tensor:
    """int64 key of block coords (each within ±2^19)."""
    return (((bx.long() + KEY_BIAS) << (2 * KEY_BITS)) | ((by.long() + KEY_BIAS) << KEY_BITS)
            | (bz.long() + KEY_BIAS))


def unpack_keys(k: torch.Tensor):
    m = (1 << KEY_BITS) - 1
    return ((k >> (2 * KEY_BITS)) & m) - KEY_BIAS, ((k >> KEY_BITS) & m) - KEY_BIAS, (k & m) - KEY_BIAS


def distinct(idx: torch.Tensor) -> int:
    return int(torch.unique(idx).numel())


def invert(M: torch.Tensor) -> torch.Tensor:
    R, t = M[:3, :3], M[:3, 3]
    out = torch.eye(4, dtype=M.dtype, device=M.device)
    out[:3, :3] = R.T
    out[:3, 3] = -(R.T @ t)
    return out


def transform(M: torch.Tensor, x, y, z):
    """M[:3, :3]·(x, y, z) + M[:3, 3] on component planes. In float32 the
    sums run in float64 and round once; a lower precision computes in its
    own type."""
    if M.dtype != torch.float32:
        return tuple(M[i, 0] * x + M[i, 1] * y + M[i, 2] * z + M[i, 3] for i in range(3))
    p = torch.stack(torch.broadcast_tensors(*(torch.as_tensor(c) for c in (x, y, z))), -1).double()
    Md = M.double()
    return (p @ Md[:3, :3].T + Md[:3, 3]).float().unbind(-1)


def coerce(M: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalise the rotation (ITMPose::Coerce): two Newton steps."""
    R = M[:3, :3]
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    for _ in range(2):
        R = R @ (1.5 * eye - 0.5 * (R.T @ R))
    out = M.clone()
    out[:3, :3] = R
    return out


class Params:
    """The numbers of a configuration file that the reference uses."""

    def __init__(self, cfg: dict):
        s = cfg["settings"]
        self.kind = cfg["kind"]
        sc = s["scene"]
        self.voxel, self.mu, self.max_w = sc["voxel_size"], sc["mu"], sc["max_w"]
        self.fmin, self.fmax = sc["view_frustum_min"], sc["view_frustum_max"]
        self.stop_at_max_w = sc.get("stop_integrating_at_max_w", False)
        tr = s["tracking"]
        self.n_levels = tr["n_levels"]
        its = list(tr["iterations_per_level"][: self.n_levels])
        while len(its) < self.n_levels:
            its.append(its[-1] + 2)
        self.iterations = its
        step = tr["dist_thresh"] / self.n_levels
        self.dist = [tr["dist_thresh"] - step * (self.n_levels - 1 - lvl) for lvl in range(self.n_levels)]
        self.term = tr["termination_threshold"]
        self.n_rot = tr["n_rotation_only_levels"]
        self.min_valid = tr["min_valid_points"]
        self.block = s["hashing"]["block_size"]
        self.n_blocks = s["hashing"]["n_blocks"]
        self.alloc_subsample = s["alloc_subsample"]
        self.grid_dims = tuple(s["block_grid"]["dims"])
        self.grid_origin = tuple(s["block_grid"]["origin"])
        self.dense_size = tuple(s["plain"]["size"])
        self.dense_offset = tuple(s["plain"]["offset"])


class Reference:
    """One sequence's reference state: its map and the camera's last maps."""

    def __init__(self, cfg: dict, img_size, proj, device, dtype=torch.float32, counts: Optional[list] = None):
        self.p = Params(cfg)
        self.H, self.W = img_size
        self.dev = torch.device(device)
        self.dtype = dtype
        self.proj = [float(v) for v in proj]
        self.counts = counts
        S = self.p.block
        self.lin = torch.arange(S**3, device=self.dev)
        self.local = (self.lin % S, (self.lin // S) % S, self.lin // (S * S))
        self._lin_w = torch.tensor([1, S, S * S], device=self.dev)
        gx, gy, gz = self.p.grid_dims
        self._grid_dims = torch.tensor([gx, gy, gz], device=self.dev)
        self._grid_origin = torch.tensor(self.p.grid_origin, device=self.dev)
        self._grid_stride = torch.tensor([gy * gz, gz, 1], device=self.dev)
        self.xs = torch.arange(self.W, dtype=dtype, device=self.dev)[None, :].expand(self.H, self.W)
        self.ys = torch.arange(self.H, dtype=dtype, device=self.dev)[:, None].expand(self.H, self.W)
        if self.p.kind == "hash":
            self.keys = torch.zeros(0, dtype=torch.long, device=self.dev)  # sorted
            self.rows = torch.zeros(0, dtype=torch.long, device=self.dev)
            self.sdf_q = torch.full((self.p.n_blocks, S**3), int(SDF_SCALE), dtype=torch.int32, device=self.dev)
            self.w = torch.zeros((self.p.n_blocks, S**3), dtype=torch.int32, device=self.dev)
            self.n_rows = 0
            self.alloc_overflow = 0
            self.visible = torch.zeros(0, dtype=torch.long, device=self.dev)
        else:
            X, Y, Z = self.p.dense_size
            sdf_dtype = torch.float32 if dtype == torch.float32 else dtype
            self.sdf = torch.ones((Z, Y, X), dtype=sdf_dtype, device=self.dev)
            self.w = torch.zeros((Z, Y, X), dtype=torch.int32, device=self.dev)

    def _f(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.dev).to(self.dtype)

    # ----- tracking ---------------------------------------------------------

    def _pyramid(self, depth):
        levels = [depth]
        for _ in range(self.p.n_levels - 1):
            d = levels[-1]
            H, W = d.shape
            v = d[: H - H % 2, : W - W % 2].reshape(H // 2, 2, W // 2, 2)
            good = v > 0
            cnt = good.sum(dim=(1, 3))
            s = torch.where(good, v, torch.zeros_like(v)).sum(dim=(1, 3))
            levels.append(torch.where(cnt > 0, s / cnt.clamp(min=1).to(s.dtype), torch.zeros_like(s)))
        return levels

    @staticmethod
    def _bilinear4(img, u, v):
        """Bilinear tap of a [H, W, 4] map at (u, v) inside its 0..W−2, 0..H−2
        range, and whether all four corners are valid (w ≥ 0)."""
        x0, y0 = torch.floor(u), torch.floor(v)
        dx, dy = (u - x0)[..., None], (v - y0)[..., None]
        # in float32 the taps lie inside already; a lower precision may round
        # u or v past the last pixel
        ix, iy = x0.long().clamp(0, img.shape[1] - 2), y0.long().clamp(0, img.shape[0] - 2)
        a, b = img[iy, ix], img[iy, ix + 1]
        c, d = img[iy + 1, ix], img[iy + 1, ix + 1]
        ok = (a[..., 3] >= 0) & (b[..., 3] >= 0) & (c[..., 3] >= 0) & (d[..., 3] >= 0)
        return a * (1 - dx) * (1 - dy) + b * dx * (1 - dy) + c * (1 - dx) * dy + d * dx * dy, ok

    def _icp_terms(self, depth, lvl, inv_pose, pmap, nmap, scene_pose):
        H, W = depth.shape
        Hs, Ws = pmap.shape[:2]
        vf = [c * 0.5**lvl for c in self.proj]
        fx, fy, cx, cy = self.proj
        xs = torch.arange(W, dtype=self.dtype, device=self.dev)[None, :].expand(H, W)
        ys = torch.arange(H, dtype=self.dtype, device=self.dev)[:, None].expand(H, W)
        valid = depth > 1e-8
        d = torch.where(valid, depth, torch.ones_like(depth))
        p = transform(inv_pose, d * (xs - vf[2]) / vf[0], d * (ys - vf[3]) / vf[1], d)
        q = transform(scene_pose, *p)
        valid = valid & (q[2] > 0)
        zs = torch.where(valid, q[2], torch.ones_like(q[2]))
        u = fx * q[0] / zs + cx
        v = fy * q[1] / zs + cy
        inside = valid & (u >= 0) & (u <= Ws - 2) & (v >= 0) & (v <= Hs - 2)
        uc, vc = u.clamp(0, Ws - 2), v.clamp(0, Hs - 2)
        tgt, ok = self._bilinear4(pmap, uc, vc)
        valid = inside & ok
        dxyz = [tgt[..., i] - p[i] for i in range(3)]
        valid = valid & (dxyz[0] ** 2 + dxyz[1] ** 2 + dxyz[2] ** 2 <= self.p.dist[lvl])
        n, _ = self._bilinear4(nmap, uc, vc)
        nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
        b = nx * dxyz[0] + ny * dxyz[1] + nz * dxyz[2]
        px, py, pz = p
        A = torch.stack([ny * pz - nz * py, nz * px - nx * pz, nx * py - ny * px, nx, ny, nz], dim=-1)
        if self.counts is not None:
            self._count_icp(depth, u, v, inside, valid, Ws)
        return b, A, valid

    def _count_icp(self, depth, u, v, inside, valid, Ws):
        """K1's least traffic of one launch: every depth pixel read, the
        distinct map pixels its bilinear taps read (points for the in-frame
        pixels, normals for those that pass the gates), the intrinsics and
        poses and the 44-word result; its float32 operations."""
        def corners(m):
            x0, y0 = torch.floor(u[m]).long(), torch.floor(v[m]).long()
            base = y0 * Ws + x0
            return torch.cat([base, base + 1, base + Ws, base + Ws + 1])

        n_taps = distinct(corners(inside)) + distinct(corners(valid))
        h, w = depth.shape
        self.counts[-1]["icp_bytes"] += h * w * 4 + 16 * n_taps + 2 * 16 + 2 * 48 + 44 * 4
        self.counts[-1]["icp_ops"] += h * w * ICP_OPS_PIXEL + int(valid.sum()) * ICP_OPS_VALID

    def _solve(self, h, g, lam, rot_only):
        n = 3 if rot_only else 6
        sub = h[:n, :n].double()
        eye = torch.eye(n, dtype=torch.float64, device=self.dev)
        A = sub * (1.0 + float(lam) * eye)
        L, info = torch.linalg.cholesky_ex(A)
        x = torch.cholesky_solve(g[:n].double()[:, None], L)[:, 0]
        if int(info) != 0 or not bool(torch.isfinite(x).all()):
            x = torch.zeros(n, dtype=torch.float64, device=self.dev)
        x = x.to(self.dtype)
        return torch.cat([x, torch.zeros(3, dtype=self.dtype, device=self.dev)]) if rot_only else x

    def _apply_delta(self, ip, step):
        w0, w1, w2, t0, t1, t2 = (float(s) for s in step.float())
        tinc = self._f([[1.0, w2, -w1, t0], [-w2, 1.0, w0, t1], [w1, -w0, 1.0, t2], [0.0, 0.0, 0.0, 1.0]])
        return coerce(tinc @ ip)

    def track(self, pose_prev, depth, pmap, nmap, scene_pose):
        """The pose of `depth` by ICP from `pose_prev` against the maps
        (points, normals [H, W, 4], w < 0 a hole) raycast at `scene_pose`."""
        pyr = self._pyramid(depth)
        ip = invert(pose_prev)
        acc = torch.float64 if self.dtype == torch.float32 else self.dtype
        for lvl in range(self.p.n_levels - 1, -1, -1):
            rot_only = lvl >= self.p.n_levels - self.p.n_rot
            ip_good = ip
            f_old, lam = 1e20, 1.0
            h_good = torch.zeros((6, 6), dtype=acc, device=self.dev)
            g_good = torch.zeros(6, dtype=acc, device=self.dev)
            for _ in range(self.p.iterations[lvl]):
                b, A, valid = self._icp_terms(pyr[lvl], lvl, ip, pmap, nmap, scene_pose)
                vm = valid.reshape(-1)
                Af = A.reshape(-1, 6)[vm].to(acc)
                bf = b.reshape(-1)[vm].to(acc)
                N = int(vm.sum())
                f = math.sqrt(abs(float((bf * bf).sum()))) / N if N > self.p.min_valid else 1e5
                if N <= 0 or f > f_old:
                    h, g, base = h_good, g_good, ip_good
                    lam *= 10.0
                else:
                    h, g, base = Af.T @ Af / N, bf @ Af / N, ip
                    f_old = f
                    lam /= 10.0
                step = self._solve(h, g, lam, rot_only)
                ip_good, h_good, g_good = base, h, g
                ip = self._apply_delta(base, step)
                if math.sqrt(float((step.double() ** 2).sum())) / 6.0 < self.p.term:
                    break
        return invert(coerce(ip))

    # ----- allocation and visibility (hash volume) --------------------------

    def _band_keys(self, depth, pose):
        """Keys of the blocks that the ±μ band of each depth ray (every
        alloc_subsample-th pixel) crosses, by an exact 3-D DDA."""
        s = self.p.alloc_subsample
        d = depth[::s, ::s].reshape(-1)
        Ph, Pw = depth[::s, ::s].shape
        fx, fy, cx, cy = (c / s for c in self.proj)
        mu = self.p.mu
        ok = (d > 0) & (d - mu >= self.p.fmin) & (d + mu <= self.p.fmax)
        d = torch.where(ok, d, torch.ones_like(d))
        xs = torch.arange(Pw, dtype=self.dtype, device=self.dev).repeat(Ph)
        ys = torch.arange(Ph, dtype=self.dtype, device=self.dev).repeat_interleave(Pw)
        pc = ((xs - cx) / fx * d, (ys - cy) / fy * d, d)
        norm = torch.sqrt(pc[0] ** 2 + pc[1] ** 2 + pc[2] ** 2)
        inv = invert(pose)
        edge = self.p.voxel * self.p.block
        a = [c / edge for c in transform(inv, *(c * (1 - mu / norm) for c in pc))]
        e = [c / edge for c in transform(inv, *(c * (1 + mu / norm) for c in pc))]
        a = torch.stack(a, -1).float()
        dirv = torch.stack(e, -1).float() - a
        cell = torch.floor(a)
        stepv = torch.sign(dirv)
        tiny = dirv.abs() < 1e-12
        safe = torch.where(tiny, torch.ones_like(dirv), dirv)
        t_max = torch.where(tiny, torch.full_like(dirv, math.inf), (cell + (stepv > 0).float() - a) / safe)
        t_delta = torch.where(tiny, torch.full_like(dirv, math.inf), 1.0 / safe.abs())
        n_steps = 2 + 3 * math.ceil(2 * mu / edge)
        keys, live = [], ok.clone()
        for _ in range(n_steps):
            keys.append(torch.where(live, pack_keys(cell[:, 0], cell[:, 1], cell[:, 2]), -1))
            axis = torch.argmin(t_max, dim=1, keepdim=True)
            t_cross = torch.gather(t_max, 1, axis)[:, 0]
            live = live & (t_cross <= 1.0)
            cell = cell.scatter_add(1, axis, torch.gather(stepv, 1, axis))
            t_max = t_max.scatter_add(1, axis, torch.gather(t_delta, 1, axis))
        k = torch.cat(keys)
        return torch.unique(k[k >= 0])

    def _lookup(self, keys):
        """(rows, found) of keys in the map."""
        if self.keys.numel() == 0:
            return torch.zeros_like(keys), torch.zeros_like(keys, dtype=torch.bool)
        pos = torch.searchsorted(self.keys, keys).clamp(max=self.keys.numel() - 1)
        found = self.keys[pos] == keys
        return torch.where(found, self.rows[pos], 0), found

    def _allocate(self, keys):
        _rows, found = self._lookup(keys)
        new = keys[~found]
        room = self.p.n_blocks - self.n_rows
        if new.numel() > room:
            self.alloc_overflow += int(new.numel() - room)
            new = new[:room]
        rows = torch.arange(self.n_rows, self.n_rows + new.numel(), device=self.dev)
        self.n_rows += new.numel()
        allk = torch.cat([self.keys, new])
        allr = torch.cat([self.rows, rows])
        order = torch.argsort(allk)
        self.keys, self.rows = allk[order], allr[order]

    def _in_view(self, keys, pose):
        """Blocks of which a corner projects into the image (checkBlockVisibility)."""
        bx, by, bz = (c.to(self.dtype) * (self.p.voxel * self.p.block) for c in unpack_keys(keys))
        fx, fy, cx, cy = self.proj
        e = self.p.voxel * self.p.block
        vis = torch.zeros(keys.shape, dtype=torch.bool, device=self.dev)
        for dx in (0, e):
            for dy in (0, e):
                for dz in (0, e):
                    x, y, z = transform(pose, bx + dx, by + dy, bz + dz)
                    ok = z >= 1e-10
                    zs = torch.where(ok, z, torch.ones_like(z))
                    u, v = fx * x / zs + cx, fy * y / zs + cy
                    vis = vis | (ok & (u >= 0) & (u < self.W) & (v >= 0) & (v < self.H))
        return vis

    # ----- fusion -----------------------------------------------------------

    def _update(self, old_sdf, old_w, pts, pose, depth):
        """The running-average TSDF update of voxels at world points `pts`
        (three planes): (new sdf, new w, updated, passed the η gate,
        in-frame, depth pixel)."""
        fx, fy, cx, cy = self.proj
        x, y, z = transform(pose, *pts)
        valid = z > 0
        zs = torch.where(valid, z, torch.ones_like(z))
        u, v = fx * x / zs + cx, fy * y / zs + cy
        inside = valid & (u >= 1) & (u <= self.W - 2) & (v >= 1) & (v <= self.H - 2)
        ui = (u + 0.5).long().clamp(0, self.W - 1)
        vi = (v + 0.5).long().clamp(0, self.H - 1)
        pix = vi * self.W + ui
        dm = depth.reshape(-1)[pix]
        eta = dm - z
        passed = inside & (dm > 0) & (eta >= -self.p.mu)
        upd = passed & (old_w < self.p.max_w) if self.p.stop_at_max_w else passed
        new_f = torch.clamp(eta / self.p.mu, max=1.0)
        merged = (old_w.to(self.dtype) * old_sdf + new_f) / (old_w + 1).to(self.dtype)
        return (torch.where(upd, merged, old_sdf), torch.where(upd, (old_w + 1).clamp(max=self.p.max_w), old_w),
                upd, passed, inside, pix)

    def integrate(self, depth, pose):
        """Fuse one frame at `pose` (world→camera) into the map."""
        depth = depth.to(self.dtype)
        pose = pose.to(self.dtype)
        if self.p.kind == "dense":
            return self._integrate_dense(depth, pose)
        cand = self._band_keys(depth, pose)
        self._allocate(cand)
        prev = self.visible[self._in_view(self.visible, pose)] if self.visible.numel() else self.visible
        vis = torch.unique(torch.cat([cand, prev]))
        rows, found = self._lookup(vis)
        vis, rows = vis[found], rows[found]
        self.visible = vis
        S = self.p.block
        bx, by, bz = unpack_keys(vis)
        pts = tuple(((b[:, None] * S + loc[None, :]).to(self.dtype) * self.p.voxel)
                    for b, loc in zip((bx, by, bz), self.local))
        old_sdf = (self.sdf_q[rows].to(self.dtype) * (1.0 / SDF_SCALE)).to(self.dtype)
        old_w = self.w[rows]
        sdf, w, upd, _passed, inside, pix = self._update(old_sdf, old_w, pts, pose, depth)
        self.sdf_q[rows] = torch.round(sdf.float().clamp(-1.0, 1.0) * SDF_SCALE).to(torch.int32)
        self.w[rows] = w
        if self.counts is not None:
            c = self.counts[-1]
            n_vis = vis.numel()
            c["integrate_bytes"] += (4 * (2 * n_vis + 3 * n_vis) + 64 + 1 + 4 * distinct(pix[inside])
                                     + 4 * 2 * int(upd.sum()))
            c["integrate_ops"] += n_vis * S**3 * INTEGRATE_OPS_VOXEL + int(upd.sum()) * INTEGRATE_OPS_UPDATE

    def _dense_axes(self):
        X, Y, Z = self.p.dense_size
        ox, oy, oz = self.p.dense_offset

        def axis(n, o):
            return ((torch.arange(n, device=self.dev) + o).to(self.dtype) * self.p.voxel)

        return axis(X, ox), axis(Y, oy), axis(Z, oz)

    def _integrate_dense(self, depth, pose):
        ax, ay, az = self._dense_axes()
        X, Y, Z = self.p.dense_size
        slab = max(1, (1 << 24) // (X * Y))
        tapped = torch.zeros(self.H * self.W, dtype=torch.bool, device=self.dev)
        n_in = n_pass = n_upd = 0
        for z0 in range(0, Z, slab):
            pts = (ax.reshape(1, 1, X), ay.reshape(1, Y, 1), az[z0:z0 + slab].reshape(-1, 1, 1))
            sdf, w, upd, passed, inside, pix = self._update(self.sdf[z0:z0 + slab], self.w[z0:z0 + slab], pts, pose,
                                                            depth)
            self.sdf[z0:z0 + slab] = sdf.to(self.sdf.dtype)
            self.w[z0:z0 + slab] = w
            if self.counts is not None:
                tapped[pix[inside]] = True
                n_in, n_pass, n_upd = n_in + int(inside.sum()), n_pass + int(passed.sum()), n_upd + int(upd.sum())
        if self.counts is not None:
            # K2d's least traffic: each distinct depth pixel an in-frame voxel
            # taps, sdf and weight read for each voxel past the η gate and
            # written for each updated, the three axes, the pose's rows and
            # the intrinsics; every in-frame voxel's centre, transform,
            # projection, tap and gates, and each updated voxel's average
            c = self.counts[-1]
            c["integrate_bytes"] += 4 * int(tapped.sum()) + 8 * (n_pass + n_upd) + 4 * (X + Y + Z) + 48 + 16
            c["integrate_ops"] += n_in * INTEGRATE_OPS_VOXEL + n_upd * INTEGRATE_OPS_DENSE_UPDATE

    # ----- raycast ----------------------------------------------------------

    def _grid_rows(self):
        """The row of each allocated block of the configuration's block
        grid, −1 elsewhere: [gx·gy·gz], the raycast's lookup table."""
        gx, gy, gz = self.p.grid_dims
        bx, by, bz = unpack_keys(self.keys)
        g = (bx - self.p.grid_origin[0], by - self.p.grid_origin[1], bz - self.p.grid_origin[2])
        inb = (g[0] >= 0) & (g[0] < gx) & (g[1] >= 0) & (g[1] < gy) & (g[2] >= 0) & (g[2] < gz)
        cell = (g[0] * gy + g[1]) * gz + g[2]
        grid = torch.full((gx * gy * gz,), -1, dtype=torch.long, device=self.dev)
        grid[cell[inb]] = self.rows[inb]
        return grid

    def _read(self, pts, counted=None):
        """(sdf, found) at integer voxel coords [..., 3] (nearest voxel): a
        hash voxel is found when its block is allocated and lies in the
        configuration's block grid, which the raycast reads; a dense voxel
        when it lies in the array. Empty space reads 1. With `counts`, the
        reads where `counted` holds are logged for the raycast's traffic."""
        S = self.p.block
        log = self.counts is not None and counted is not None
        if self.p.kind == "dense":
            X, Y, Z = self.p.dense_size
            ox, oy, oz = self.p.dense_offset
            px, py, pz = pts[..., 0] - ox, pts[..., 1] - oy, pts[..., 2] - oz
            found = (px >= 0) & (px < X) & (py >= 0) & (py < Y) & (pz >= 0) & (pz < Z)
            idx = (pz.clamp(0, Z - 1) * Y + py.clamp(0, Y - 1)) * X + px.clamp(0, X - 1)
            s = self.sdf.reshape(-1)[idx].to(self.dtype)
            if log:
                self._touched.append(torch.where(found & counted, idx, -1).reshape(-1))
            return torch.where(found, s, torch.ones_like(s)), found
        blk = torch.div(pts, S, rounding_mode="floor")
        g = blk - self._grid_origin
        in_grid = ((g >= 0) & (g < self._grid_dims)).all(-1)
        cell = (g.clamp(min=0).minimum(self._grid_dims - 1) * self._grid_stride).sum(-1)
        rows = self._grid[cell]
        found = in_grid & (rows >= 0)
        idx = rows.clamp(min=0) * S**3 + ((pts - blk * S) * self._lin_w).sum(-1)
        s = (self.sdf_q.reshape(-1)[idx].to(self.dtype) * (1.0 / SDF_SCALE)).to(self.dtype)
        if log:
            self._touched_cells.append(torch.where(in_grid & counted, cell, -1).reshape(-1))
            self._touched.append(torch.where(found & counted, idx, -1).reshape(-1))
        return torch.where(found, s, torch.ones_like(s)), found

    def _read_trilinear(self, p, counted=None):
        """Trilinear sdf at float voxel coords [..., 3] over the 8 voxels
        around, read as one stacked read."""
        base = torch.floor(p)
        c = p - base
        k = torch.arange(8, device=self.dev)
        off = torch.stack([k & 1, (k >> 1) & 1, k >> 2], -1).reshape((8,) + (1,) * (p.dim() - 1) + (3,))
        v, _found = self._read(base.long()[None] + off, None if counted is None else counted[None].expand(8, *counted.shape))
        cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
        r00 = (1 - cx) * v[0] + cx * v[1]
        r10 = (1 - cx) * v[2] + cx * v[3]
        r01 = (1 - cx) * v[4] + cx * v[5]
        r11 = (1 - cx) * v[6] + cx * v[7]
        return (1 - cz) * ((1 - cy) * r00 + cy * r10) + cz * ((1 - cy) * r01 + cy * r11)

    def _ranges(self, pose):
        """Per-pixel depth range of the raycast [H, W] ×2: the hash volume's
        visible blocks' projected boxes, min and max z, on an 8× subsampled
        raster (CreateExpectedDepths; a cell no block covers gets an empty
        range at the far plane); the dense array's whole frustum."""
        H, W = self.H, self.W
        fmin, fmax = self.p.fmin, self.p.fmax
        full = torch.full((H, W), fmin, dtype=self.dtype, device=self.dev)
        if self.p.kind == "dense" or self.visible.numel() == 0:
            if self.p.kind == "dense":
                return full, torch.full_like(full, fmax)
            return torch.full_like(full, fmax), torch.full_like(full, fmax)
        sub = 8
        Hs, Ws = (H + sub - 1) // sub, (W + sub - 1) // sub
        fx, fy, cx, cy = self.proj
        e = self.p.voxel * self.p.block
        bx, by, bz = (c.to(self.dtype) for c in unpack_keys(self.visible))
        us, vs, zs = [], [], []
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    x, y, z = transform(pose, (bx + dx) * e, (by + dy) * e, (bz + dz) * e)
                    ok = z > 1e-6
                    zsafe = torch.where(ok, z, torch.ones_like(z))
                    far = torch.where(z <= 0, -1e9, 1e9).to(self.dtype)
                    us.append(torch.where(ok, fx * x / zsafe + cx, far))
                    vs.append(torch.where(ok, fy * y / zsafe + cy, far))
                    zs.append(z)
        U, V, Z = torch.stack(us, -1), torch.stack(vs, -1), torch.stack(zs, -1)
        behind = (Z <= 0).any(-1)
        u0 = torch.floor(U.amin(-1) / sub).long().clamp(0, Ws - 1)
        u1 = torch.ceil(U.amax(-1) / sub).long().clamp(0, Ws - 1)
        v0 = torch.floor(V.amin(-1) / sub).long().clamp(0, Hs - 1)
        v1 = torch.ceil(V.amax(-1) / sub).long().clamp(0, Hs - 1)
        zlo = torch.where(behind, fmin, Z.amin(-1).clamp(min=fmin)).to(self.dtype)
        zhi = torch.where(behind, fmax, Z.amax(-1).clamp(max=fmax)).to(self.dtype)
        zmin_img = torch.full((Hs * Ws + 1,), fmax, dtype=self.dtype, device=self.dev)
        zmax_img = torch.full((Hs * Ws + 1,), fmin, dtype=self.dtype, device=self.dev)
        span = int(torch.maximum(u1 - u0, v1 - v0).max()) + 1
        for du in range(span):
            for dv in range(span):
                uu, vv = u0 + du, v0 + dv
                cell = torch.where((uu <= u1) & (vv <= v1), vv * Ws + uu, Hs * Ws)
                zmin_img = zmin_img.scatter_reduce(0, cell, zlo, reduce="amin")
                zmax_img = zmax_img.scatter_reduce(0, cell, zhi, reduce="amax")
        zmin_img, zmax_img = zmin_img[:-1].reshape(Hs, Ws), zmax_img[:-1].reshape(Hs, Ws)
        empty = zmax_img < zmin_img
        zmin_img = torch.where(empty, fmax, zmin_img).to(self.dtype)
        zmax_img = torch.where(empty, fmax, zmax_img).to(self.dtype)
        rows = (torch.arange(H, device=self.dev) // sub)[:, None]
        cols = (torch.arange(W, device=self.dev) // sub)[None, :]
        return zmin_img[rows, cols], zmax_img[rows, cols]

    def raycast(self, pose):
        """Points [H, W, 4] in voxel units, w = 1 where a ray found the
        surface (castRay over the `_ranges`: a step of max(sdf·μ/voxel, 1)
        voxels in allocated space and to the block's exit through empty
        space, stop at the first sdf ≤ 0 or past the far end; then a secant
        step and two trilinear refinements)."""
        H, W = self.H, self.W
        fx, fy, cx, cy = self.proj
        pose = pose.to(self.dtype)
        inv = invert(pose)
        iv = 1.0 / self.p.voxel
        zmin, zmax = self._ranges(pose)
        dx, dy = (self.xs - cx) / fx, (self.ys - cy) / fy
        start = torch.stack([c * iv for c in transform(inv, dx * zmin, dy * zmin, zmin)], -1)
        end = torch.stack([c * iv for c in transform(inv, dx * zmax, dy * zmax, zmax)], -1)
        ray = end - start
        ray = ray / torch.sqrt((ray * ray).sum(-1, keepdim=True)).clamp(min=1e-12)
        ray_len = torch.sqrt(dx * dx + dy * dy + 1.0)
        total = ray_len * zmin * iv
        len_end = ray_len * zmax * iv
        S = self.p.block
        scale = self.p.mu * iv
        pt = start
        sdf = torch.ones((H, W), dtype=self.dtype, device=self.dev)
        active = torch.ones((H, W), dtype=torch.bool, device=self.dev)
        tiny = ray.abs() < 1e-9
        safe = torch.where(tiny, torch.full_like(ray, 1e-9), ray)
        up = (ray > 0).to(self.dtype)
        n_found = n_empty = n_stop = 0
        self._touched, self._touched_cells = [], []
        if self.p.kind == "hash":
            self._grid = self._grid_rows()
        # every step advances at least half a voxel, so a march ends within
        # this many steps in float32; in a lower precision the sum may stall
        max_steps = 2 * int(math.ceil(float((len_end - total).float().max()))) + 2
        for _ in range(max_steps):
            if not bool(active.any()):
                break
            s, found = self._read(torch.floor(pt + 0.5).long(), active)
            hit = found & (s <= 0)
            if self.counts is not None:
                n_found += int((active & found & (s > 0)).sum())
                n_empty += int((active & ~found).sum())
                n_stop += int((active & found & (s <= 0)).sum())
            nxt = (torch.floor(pt / S) + up) * S
            t_exit = torch.where(tiny, torch.full_like(pt, 1e9), (nxt - pt) / safe).amin(-1)
            empty_step = torch.clamp(t_exit + 0.01, 0.5, float(S))
            step = torch.where(found, torch.clamp(s * scale, min=1.0), empty_step)
            adv = active & ~hit
            pt = torch.where(adv[..., None], pt + step[..., None] * ray, pt)
            total = torch.where(adv, total + step, total)
            sdf = torch.where(active, s, sdf)
            active = adv & (total < len_end)
        hit = sdf <= 0
        p = pt + (sdf * scale)[..., None] * ray
        for _ in range(2):
            p = p + (self._read_trilinear(p, hit) * scale)[..., None] * ray
        if self.counts is not None:
            vox = torch.cat(self._touched)
            n_bytes = H * W * (4 + 4 + 16) + 4 * distinct(vox[vox >= 0]) + 48 + 16
            if self._touched_cells:
                cells = torch.cat(self._touched_cells)
                n_bytes += 4 * distinct(cells[cells >= 0])
            decode = RAYCAST_OPS_DECODE if self.p.kind == "hash" else 0
            n_ops = (H * W * RAYCAST_OPS_RAY + (n_found + n_empty + n_stop) * RAYCAST_OPS_READ
                     + (n_found + n_stop) * decode + n_found * RAYCAST_OPS_FOUND + n_empty * RAYCAST_OPS_EMPTY
                     + int(hit.sum()) * RAYCAST_OPS_HIT)
            self.counts[-1]["raycast_bytes"] += n_bytes
            self.counts[-1]["raycast_ops"] += n_ops
            self._touched, self._touched_cells = [], []
        return torch.cat([torch.where(hit[..., None], p, pt), hit.to(self.dtype)[..., None]], -1)

    def maps(self, pose):
        """The tracker's maps at `pose` (renderICP): points in metres and
        world-frame unit normals from image-space differences (±2 px, ±1 px
        where those span a jump over 15 cm), w = 1 valid / −1 invalid."""
        r = self.raycast(pose)
        inv = invert(pose.to(self.dtype))
        light = -inv[:3, 2] / torch.sqrt((inv[:3, 2] ** 2).sum())
        px, py, pz = r[..., 0], r[..., 1], r[..., 2]
        found = r[..., 3] > 0

        def sh(a, dy, dx):
            return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))

        def diffs(d):
            ok = sh(found, 0, d) & sh(found, 0, -d) & sh(found, d, 0) & sh(found, -d, 0)
            return ([sh(c, 0, d) - sh(c, 0, -d) for c in (px, py, pz)],
                    [sh(c, d, 0) - sh(c, -d, 0) for c in (px, py, pz)], ok)

        dx2, dy2, ok2 = diffs(2)
        jump = torch.maximum(sum(c * c for c in dx2), sum(c * c for c in dy2)) * self.p.voxel**2 > 0.15**2
        dx1, dy1, ok1 = diffs(1)
        use1 = ~ok2 | jump
        ddx = [torch.where(use1, a, b) for a, b in zip(dx1, dx2)]
        ddy = [torch.where(use1, a, b) for a, b in zip(dy1, dy2)]
        ok = torch.where(use1, ok1, ok2)
        nx = -(ddx[1] * ddy[2] - ddx[2] * ddy[1])
        ny = -(ddx[2] * ddy[0] - ddx[0] * ddy[2])
        nz = -(ddx[0] * ddy[1] - ddx[1] * ddy[0])
        norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
        inv_n = 1.0 / norm.clamp(min=1e-12)
        nx, ny, nz = nx * inv_n, ny * inv_n, nz * inv_n
        angle = nx * light[0] + ny * light[1] + nz * light[2]
        H, W = self.H, self.W
        xs = torch.arange(W, device=self.dev)[None, :]
        ys = torch.arange(H, device=self.dev)[:, None]
        border = (xs > 2) & (xs < W - 3) & (ys > 2) & (ys < H - 3)
        valid = found & ok & (angle > 0) & border & (norm > 0)
        w = torch.where(valid, 1.0, -1.0).to(self.dtype)
        zero = torch.zeros_like(px)
        pm = torch.stack([torch.where(valid, c * self.p.voxel, zero) for c in (px, py, pz)] + [w], -1)
        nm = torch.stack([torch.where(valid, c, zero) for c in (nx, ny, nz)] + [w], -1)
        return pm, nm

    # ----- the map as the comparison reads it -------------------------------

    def voxels(self):
        """Hash: (sorted block keys [K], sdf_q [K, S³] int32, w [K, S³]);
        dense: (sdf [Z, Y, X], w)."""
        if self.p.kind == "dense":
            return self.sdf, self.w
        return self.keys, self.sdf_q[self.rows], self.w[self.rows]
