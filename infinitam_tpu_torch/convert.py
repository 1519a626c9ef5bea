"""State conversion between the JAX package and the port.

Both packages keep their state in NamedTuples with the same field names,
shapes and dtypes (`HashVolume`, `RenderStateVH`, `TrackingState`, the
dense array's `DenseVolume`), their
swap states in one [E] int32 array, and their host store in a `GlobalCache`
dataclass of numpy arrays with the same fields. The exchange format is a
dict of numpy arrays keyed by field (None where a field is absent), or one
numpy array for the swap states, so this module needs neither package's
arrays: `to_numpy` reads a JAX or a PyTorch state, `from_numpy` builds the
port's.
"""

from __future__ import annotations

import dataclasses
from typing import Type, TypeVar

import numpy as np
import torch

T = TypeVar("T")


def _array(v) -> np.ndarray:
    # a copy: the port updates `vox` in place
    return v.detach().to("cpu", copy=True).numpy() if torch.is_tensor(v) else np.asarray(v)


def to_numpy(state):
    """A state NamedTuple or a GlobalCache of either package as {field:
    numpy array or None}; a single array (the swap states), JAX or torch,
    as a numpy array."""
    if hasattr(state, "_fields"):
        return {name: None if getattr(state, name) is None else _array(getattr(state, name))
                for name in state._fields}
    if dataclasses.is_dataclass(state):
        return {f.name: None if getattr(state, f.name) is None else np.array(getattr(state, f.name), copy=True)
                for f in dataclasses.fields(state)}
    return _array(state)


def from_numpy(cls: Type[T], arrays, device: torch.device | str = "cuda") -> T:
    """The port's `cls` from `to_numpy` output: a state NamedTuple (e.g.
    hash_volume.HashVolume) copied onto `device` (the card unless the caller
    passes device="cpu"); `torch.Tensor` for the swap states, also on
    `device`; swapping.GlobalCache, whose arrays stay on the host."""
    if cls is torch.Tensor:
        return torch.from_numpy(np.array(arrays, copy=True)).to(device)
    names = [f.name for f in dataclasses.fields(cls)] if dataclasses.is_dataclass(cls) else cls._fields
    missing = set(names) - set(arrays)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    if dataclasses.is_dataclass(cls):
        return cls(**{k: None if arrays[k] is None else np.array(arrays[k], copy=True) for k in names})
    return cls(**{
        k: None if arrays[k] is None else torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in names
    })
