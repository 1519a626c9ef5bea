"""Checkpoint and resume of the whole engine state.

Counterpart of infinitam_tpu/utils/checkpoint.py, in its file format: one
`.npz` of the volume, render state, tracking state and swap states, with
`frame_no` and the leaf names in a JSON `__meta__` entry, and the host store
beside it as `<path>.cache.npz` (reference ITMGlobalCache::SaveToFile; the
reference persists nothing more).

Format v2 keys each leaf by its path in the state tree, named as
`jax.tree_util.keystr` names the JAX package's (`['vol'].entry_pos`): dict
keys sorted, NamedTuple fields in order, None fields absent. This module
writes and reads those names itself, so a snapshot written by either
package loads into the other. Leaves missing from a snapshot keep the live
value and are reported, so the block-grid caches can be rebuilt and the
allocator's epochs reset; unknown stored leaves are ignored. Format v1
(positional leaves) loads only when its leaf count matches. A restore checks
the volume's invariants and raises on a snapshot that breaks them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from infinitam_tpu_torch.engine import hash_volume as hv
from infinitam_tpu_torch.engine.swapping import GlobalCache, SwapExchange

FORMAT_VERSION = 2


def _flatten(tree: Any, path: str = ""):
    """[(name, leaf)] of a tree of dicts, NamedTuples, tensors and arrays, in
    the JAX package's order and names."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k], f"{path}[{k!r}]")]
    if hasattr(tree, "_fields"):
        return [x for k in tree._fields for x in _flatten(getattr(tree, k), f"{path}.{k}")]
    return [(path, tree)]


def _unflatten(like: Any, leaves: dict, path: str = ""):
    """`like` with each leaf replaced by leaves[name]."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, f"{path}[{k!r}]") for k in like}
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, k), leaves, f"{path}.{k}") for k in like._fields))
    return leaves[path]


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Save a tree of tensors (or arrays) to one .npz, leaves keyed by path."""
    flat = _flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, (_n, x) in enumerate(flat)}
    meta = dict(meta or {})
    meta["__format__"] = FORMAT_VERSION
    meta["__names__"] = [n for n, _x in flat]
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str, like: Any) -> Tuple[Any, dict, list]:
    """Load into the structure of `like`, matching leaves by path name; each
    leaf goes to the device of `like`'s leaf. Returns (tree, meta, names of
    the leaves the snapshot lacks, which keep `like`'s value)."""
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}
    flat = _flatten(like)
    stored = meta.get("__names__")
    missing: list = []
    leaves = {}
    if stored is None:
        # format v1: positional leaves, loadable only while the leaf count
        # matches (a changed layout would be guessed wrong)
        n_stored = sum(1 for k in z.files if k.startswith("leaf_"))
        if n_stored != len(flat):
            raise ValueError(f"checkpoint {path!r} is format v1 with {n_stored} leaves but the live state has "
                             f"{len(flat)}; re-save with the current version (leaf names are recorded since format v2)")
        for i, (name, x) in enumerate(flat):
            leaves[name] = torch.from_numpy(z[f"leaf_{i}"]).to(x.device)
    else:
        by_name = {n: i for i, n in enumerate(stored)}
        for name, x in flat:
            if name in by_name:
                leaves[name] = torch.from_numpy(z[f"leaf_{by_name[name]}"]).to(x.device)
            else:
                missing.append(name)
                leaves[name] = x
    return _unflatten(like, leaves), meta, missing


def validate_volume(vol, settings) -> None:
    """Raise on a volume that breaks the snapshot invariants: no entry points
    at the reserved sentinel row (the integrate step writes masked lanes
    there), the free stacks' tops in range. It reads back to the host."""
    B = settings.hashing.n_blocks
    sent = hv.sentinel_row(settings.hashing)
    if bool((vol.entry_ptr == sent).any()):
        raise ValueError(f"snapshot violates the sentinel-row invariant: some hash entry points at reserved VBA "
                         f"row {sent} (pre-sentinel snapshot?)")
    lfb = int(vol.last_free_block)
    if not (-1 <= lfb <= B - 2):
        raise ValueError(f"snapshot free-stack top {lfb} outside [-1, {B - 2}]")
    if int(vol.last_free_excess) >= settings.hashing.n_excess:
        raise ValueError("snapshot excess free-stack top out of range")


def _engine_tree(engine) -> dict:
    return {"vol": engine.vol, "render_state": engine.render_state, "tracking_state": engine.tracking_state,
            "swap_states": engine.swap_states}


def save_engine(path: str, engine) -> None:
    """Snapshot a MainEngine: its state, its frame count and, with swapping,
    the host store (after draining the exchange, so that the snapshot holds
    every processed frame)."""
    if engine.swapping:
        engine.flush_swap()
    save_pytree(path, _engine_tree(engine), meta={"frame_no": engine.frame_no})
    if engine.global_cache is not None:
        engine.global_cache.save(path + ".cache.npz")


def load_engine(path: str, engine) -> None:
    """Restore a snapshot into a MainEngine of the same settings, on the
    engine's device. Raises on a volume that breaks the invariants; rebuilds
    the block-grid caches from the hash when the snapshot lacks them and
    resets the allocator's claim and epoch planes when it lacks those."""
    loaded, meta, missing = load_pytree(path, _engine_tree(engine))
    vol, rs = loaded["vol"], loaded["render_state"]
    validate_volume(vol, engine.settings)
    if vol.entry_grid is not None and any("entry_grid" in n or "block_grid" in n for n in missing):
        vol = hv.refresh_caches(vol, engine.settings.block_grid)
    # "cell_epoch": an older name of the claim plane in the JAX package
    if rs.cell_claim is not None and any(k in n for n in missing
                                         for k in ("cell_claim", "cell_epoch", "entry_epoch", "epoch")):
        rs = rs._replace(cell_claim=torch.zeros_like(rs.cell_claim), entry_epoch=torch.zeros_like(rs.entry_epoch),
                         epoch=torch.zeros_like(rs.epoch))
    engine.vol, engine.render_state = vol, rs
    engine.tracking_state = loaded["tracking_state"]
    engine.swap_states = loaded["swap_states"]
    engine.frame_no = int(meta.get("frame_no", 0))
    cache_path = path + ".cache.npz"
    if engine.global_cache is not None and os.path.exists(cache_path):
        engine.global_cache = GlobalCache.load(cache_path)
    if engine.swapping:
        # a snapshot is taken drained: nothing of the engine's earlier frames
        # may merge into it
        engine.swap_exchange = SwapExchange(engine.settings, engine.settings.use_color, device=engine.device)
