"""State conversion between the JAX package and the port.

Both packages keep their state in NamedTuples with the same field names,
shapes and dtypes (`HashVolume`, `RenderStateVH`, `TrackingState`). The
exchange format is a dict of numpy arrays keyed by field (None where a field
is absent), so this module needs neither package's arrays: `to_numpy` reads a
JAX or a PyTorch state, `from_numpy` builds the port's state on a device.
"""

from __future__ import annotations

from typing import Type, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def to_numpy(state) -> dict:
    """{field: numpy array or None} of a JAX or PyTorch state NamedTuple."""
    out = {}
    for name in state._fields:
        v = getattr(state, name)
        if v is None:
            out[name] = None
        elif torch.is_tensor(v):
            out[name] = v.detach().cpu().numpy()
        else:
            out[name] = np.asarray(v)
    return out


def from_numpy(cls: Type[T], arrays: dict, device: torch.device | str = "cuda") -> T:
    """The port's state `cls` (e.g. hash_volume.HashVolume) from
    `to_numpy` output, copied onto `device` (the card unless the caller
    passes device="cpu")."""
    missing = set(cls._fields) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{
        k: None if arrays[k] is None else torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in cls._fields
    })
