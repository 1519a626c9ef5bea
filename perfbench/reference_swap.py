"""Plain PyTorch reference of InfiniTAM's host swap tier on the voxel-block
hash (ITMSwappingEngine, ITMGlobalCache; `useSwapping` in ITMLibSettings).

The hash reference of perfbench/reference.py, with upstream's swap steps in
upstream's order each frame (ITMDenseMapper::ProcessFrame): allocate, the
blocks visible last frame kept where a corner projects into the image
padded by an eighth on each side (checkBlockVisibility with
`useSwapping`); a visible block that was swapped out takes a fresh block;
integrate; swap in: each such block is merged with what the host store
holds of it (combineVoxelDepthInformation: the weighted mean of the stored
and the device voxel, the weight capped at max_w; a stored weight of 0
leaves the device voxel); swap out: every resident block that is not
visible goes to the host store and its block is freed, at most
n_transfer_blocks a frame (SDF_TRANSFER_BLOCK_NUM), in key order.

It is synchronous: a block leaves in the frame it leaves the view and comes
back merged in the frame it returns. It keeps its host store of its own,
keyed by block coordinate, and copies none of the program's schedule (its
quanta, its rotating eviction window, its two-frame lag). Its map is the
resident blocks and the stored ones, which is what a drained program holds
whatever its schedule. It imports nothing but torch and the hash reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from perfbench.reference import SDF_SCALE, Reference, transform, unpack_keys


def find_keys(keys: torch.Tensor, sorted_keys: torch.Tensor):
    """(positions in `sorted_keys`, found) of each key."""
    if sorted_keys.numel() == 0:
        return torch.zeros_like(keys), torch.zeros_like(keys, dtype=torch.bool)
    pos = torch.searchsorted(sorted_keys, keys).clamp(max=sorted_keys.numel() - 1)
    return pos, sorted_keys[pos] == keys


class SwapReference(Reference):
    """One sequence's reference state with the host swap tier: the resident
    blocks (Reference's sorted keys and rows), the freed rows, and the host
    store (sorted keys, int16-scaled sdf and weights as int32)."""

    def __init__(self, cfg: dict, img_size, proj, device, dtype=torch.float32, counts: Optional[list] = None):
        super().__init__(dict(cfg, kind="hash"), img_size, proj, device, dtype=dtype, counts=counts)
        self.transfer = cfg["settings"]["hashing"]["n_transfer_blocks"]
        S3 = self.p.block ** 3
        self.free = torch.zeros(0, dtype=torch.long, device=self.dev)
        self.store_keys = torch.zeros(0, dtype=torch.long, device=self.dev)
        self.store_q = torch.zeros((0, S3), dtype=torch.int32, device=self.dev)
        self.store_w = torch.zeros((0, S3), dtype=torch.int32, device=self.dev)
        self.n_swapped_out = self.n_swapped_in = 0  # blocks moved out, and merged back with stored data

    def _allocate(self, keys):
        """New blocks take freed rows first, then rows never used."""
        _rows, found = self._lookup(keys)
        new = keys[~found]
        room = self.free.numel() + self.p.n_blocks - self.n_rows
        if new.numel() > room:
            self.alloc_overflow += int(new.numel() - room)
            new = new[:room]
        k = min(new.numel(), self.free.numel())
        rows = torch.cat([self.free[:k], torch.arange(self.n_rows, self.n_rows + new.numel() - k, device=self.dev)])
        self.free = self.free[k:]
        self.n_rows += new.numel() - k
        allk, allr = torch.cat([self.keys, new]), torch.cat([self.rows, rows])
        order = torch.argsort(allk)
        self.keys, self.rows = allk[order], allr[order]

    def _in_view(self, keys, pose):
        """Blocks of which a corner projects into the image padded by an
        eighth of its size on each side (checkBlockVisibility, the swap
        path's test)."""
        e = self.p.voxel * self.p.block
        bx, by, bz = (c.to(self.dtype) * e for c in unpack_keys(keys))
        fx, fy, cx, cy = self.proj
        pw, ph = self.W / 8.0, self.H / 8.0
        vis = torch.zeros(keys.shape, dtype=torch.bool, device=self.dev)
        for dx in (0, e):
            for dy in (0, e):
                for dz in (0, e):
                    x, y, z = transform(pose, bx + dx, by + dy, bz + dz)
                    ok = z >= 1e-10
                    zs = torch.where(ok, z, torch.ones_like(z))
                    u, v = fx * x / zs + cx, fy * y / zs + cy
                    vis = vis | (ok & (u >= -pw) & (u < self.W + pw) & (v >= -ph) & (v < self.H + ph))
        return vis

    def integrate(self, depth, pose):
        """Allocate and fuse (Reference.integrate, with the padded test),
        then swap in and swap out."""
        super().integrate(depth, pose)
        self._swap_in()
        self._swap_out()

    def _swap_in(self):
        """Merge the stored content of every visible block that has some:
        those the frame has just given a fresh block."""
        pos, back = find_keys(self.visible, self.store_keys)
        if not bool(back.any()):
            return
        keys, pos = self.visible[back], pos[back]
        rows, _found = self._lookup(keys)
        q_dev, w_dev = self.sdf_q[rows], self.w[rows]
        q_old, w_old = self.store_q[pos], self.store_w[pos]
        f_dev = (q_dev.to(self.dtype) * (1.0 / SDF_SCALE)).to(self.dtype)
        f_old = (q_old.to(self.dtype) * (1.0 / SDF_SCALE)).to(self.dtype)
        w_sum = w_old + w_dev
        f = (w_old.to(self.dtype) * f_old + w_dev.to(self.dtype) * f_dev) / w_sum.clamp(min=1).to(self.dtype)
        use = w_old > 0
        self.sdf_q[rows] = torch.where(use, torch.round(f.float().clamp(-1.0, 1.0) * SDF_SCALE).to(torch.int32), q_dev)
        self.w[rows] = torch.where(use, w_sum.clamp(max=self.p.max_w), w_dev)
        self.n_swapped_in += int(use.any(-1).sum())
        keep = torch.ones(self.store_keys.shape, dtype=torch.bool, device=self.dev)
        keep[pos] = False
        self.store_keys, self.store_q, self.store_w = self.store_keys[keep], self.store_q[keep], self.store_w[keep]

    def _swap_out(self):
        """Every resident block that is not visible, up to the transfer
        buffer, to the host store; its row is cleared and freed."""
        _pos, vis = find_keys(self.keys, torch.sort(self.visible)[0])
        out = torch.nonzero(~vis)[:, 0][: self.transfer]
        if out.numel() == 0:
            return
        keys, rows = self.keys[out], self.rows[out]
        allk = torch.cat([self.store_keys, keys])
        order = torch.argsort(allk)
        self.store_keys = allk[order]
        self.store_q = torch.cat([self.store_q, self.sdf_q[rows]])[order]
        self.store_w = torch.cat([self.store_w, self.w[rows]])[order]
        self.sdf_q[rows] = int(SDF_SCALE)
        self.w[rows] = 0
        self.free = torch.cat([self.free, rows])
        keep = torch.ones(self.keys.shape, dtype=torch.bool, device=self.dev)
        keep[out] = False
        self.keys, self.rows = self.keys[keep], self.rows[keep]
        self.n_swapped_out += out.numel()

    def voxels(self):
        """(sorted block keys [K], sdf_q [K, S³] int32, w [K, S³]) of the
        resident blocks and the stored ones together."""
        keys = torch.cat([self.keys, self.store_keys])
        q = torch.cat([self.sdf_q[self.rows], self.store_q])
        w = torch.cat([self.w[self.rows], self.store_w])
        order = torch.argsort(keys)
        return keys[order], q[order], w[order]


def reference_lane(cfg, depths, poses, img_size, proj, device, dtype=torch.float32, counts=None):
    """perfbench/compare.py reference_lane with the swap tier: (the
    reference's pose for each frame from the program's previous one [N, 4,
    4] (frame 0: the identity), its map, its last maps, the reference)."""
    ref = SwapReference(cfg, img_size, proj, device, dtype=dtype, counts=counts)
    P = torch.as_tensor(poses, device=device)
    out = [torch.eye(4, dtype=torch.float32, device=device)]
    maps = None
    for i in range(depths.shape[0]):
        if counts is not None:
            counts.append({k: 0 for k in ("icp_bytes", "icp_ops", "integrate_bytes", "integrate_ops",
                                          "raycast_bytes", "raycast_ops")})
        d = depths[i].to(dtype)
        if i > 0:
            out.append(ref.track(P[i - 1].to(dtype), d, maps[0], maps[1], P[i - 1].to(dtype)).float())
        ref.integrate(d, P[i])
        maps = ref.maps(P[i])
    return torch.stack(out).cpu().numpy(), ref.voxels(), maps, ref


def free_run(cfg, depths, img_size, proj, device, dtype):
    """The reference on its own, tracking from its own poses, as
    perfbench/compare.py free_run: (poses [N, 4, 4], map, last maps)."""
    ref = SwapReference(cfg, img_size, proj, device, dtype=dtype)
    pose = torch.eye(4, dtype=dtype, device=device)
    poses, maps = [], None
    for i in range(depths.shape[0]):
        d = depths[i].to(dtype)
        if i > 0:
            pose = ref.track(pose, d, maps[0], maps[1], pose)
        poses.append(pose.float())
        ref.integrate(d, pose)
        maps = ref.maps(pose)
    return torch.stack(poses).cpu().numpy(), ref.voxels(), maps
