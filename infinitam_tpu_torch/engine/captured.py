"""The frame steps as captured CUDA graphs: the port's counterpart of
`jax.jit` (infinitam_tpu/engine/hash_pipeline.py:1521 process_frame_hash and
:1696 process_sequence_hash, dense_pipeline.py:118 process_frame_dense,
parallel/batch.py:83-110 the batched steps).

`run(name, static, body, state, frame)` runs one step,
`body(state, frame) → (new_state, out)`:

- On the card, as one replay of a `torch.cuda.CUDAGraph`. A graph is
  recorded once for each key, as jit compiles one program for each: the
  name and the static arguments (settings, fusion_active, the lane count),
  the shapes and dtypes of every input, which optional inputs are None, and
  the addresses of the `state` tensors, which the graph reads and writes
  where they lie. Before each replay the `frame` tensors (the frame's
  images, the intrinsics and extrinsics, the pose and merge inputs) are
  copied into the graph's static inputs. Inside the graph, after the step,
  every new state tensor is copied into the caller's (one the step wrote
  in place needs no copy), so the caller's state keeps its identity from
  frame to frame and the step's intermediates stay in the graph's private
  pool. `out` is
  packed into one byte buffer inside the graph: the graph's static output,
  which the next replay overwrites, so a caller copies what it keeps
  (`Outputs.read`).
- On the CPU (the caller asked for it: the state lies there), eagerly: the
  same body, copy-back and packing, with no graph.

Before a step is captured it runs once as a warm-up on a clone of the state
(a real frame, which K2 would otherwise fuse into the caller's map), on the
capture stream. That makes what capture may not: the kernel library, K1's
ticket counters (a set of its own for each graph, ops/kernels/icp.py), the
kernels' occupancy caches, the cuBLAS and cuSOLVER handles and workspaces.
A capture that fails raises; nothing runs eagerly in its place.

The kernel wrappers count their launches as they run. A capture records
launches without running them, so the counts it added are taken back; each
replay then counts the hand kernels the graph itself holds, read from its
kernel nodes by function name (build.counter_of), and a capture whose
kernel nodes differ from the launches its wrappers counted raises. The
warm-up's launches, on the clone, are not counted either: the counts are
those of the frames the caller asked for (build.launch_counts).

With spans on (engine/spans.py), a step adds a `begin` mark before its
body and an `end` mark after the copy-back and the packing, and records
the host spans `stage` (the frame's copies) and `replay`; a graph with
marks is captured apart from the one without (the key holds the
addresses of the ring the marks write, none while spans are off, and the
graph lives no longer than the ring), and its warm-up runs with the marks
paused.

A graph lives as long as the caller's state tensors it was captured with,
and at most MAX_GRAPHS graphs live at once (the least recently replayed
goes first): each holds its frame's intermediates in its pool. `clear()`
frees them all.
"""

from __future__ import annotations

import ctypes
import functools
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, NamedTuple, Optional

import torch

from infinitam_tpu_torch.engine import spans
from infinitam_tpu_torch.ops.kernels import build
from infinitam_tpu_torch.ops.kernels import icp as icp_kernel

MAX_GRAPHS = 8
_PAD = 8  # bytes each packed output is aligned to, so it views back as any dtype


# ----- pytrees of NamedTuples, tuples, lists, dicts, None and tensors -----

def tree_map(fn: Callable, tree):
    """`tree` with each tensor t replaced by fn(t)."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def leaves(tree) -> list:
    """The tensors of `tree`, in order."""
    out = []
    tree_map(out.append, tree)
    return out


def refill(live, fresh) -> None:
    """Write a fresh map (`fresh`, a state of the same structure) into the
    tensors of `live`, in place: a graph's key holds the addresses of the
    state tensors it was captured with, so a run from the refilled state
    replays that graph without a new capture."""
    for a, b in zip(leaves(live), leaves(fresh), strict=True):
        a.copy_(b)


def _structure(tree, leaf_key: Callable):
    """A hashable description of `tree`: its containers, None and other
    values as they are, and leaf_key(t) for each tensor."""
    if torch.is_tensor(tree):
        return leaf_key(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__qualname__, tuple(_structure(x, leaf_key) for x in tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(x, leaf_key) for x in tree))
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k], leaf_key)) for k in sorted(tree)))
    return tree


def _layout(t: torch.Tensor):
    return ("T", tuple(t.shape), t.dtype, t.device)


def _address(t: torch.Tensor):
    return ("T", t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


# ----- the step's outputs, packed into one byte buffer ---------------------

class _Slot(NamedTuple):
    offset: int
    n_bytes: int
    dtype: torch.dtype
    shape: tuple


class Outputs(NamedTuple):
    """A step's outputs packed into `buf` (uint8 [n_bytes]); on the card
    the graph's static output, overwritten by its next replay."""

    buf: torch.Tensor
    tree: Any  # the outputs' structure, each tensor replaced by its _Slot

    def read(self, buf: Optional[torch.Tensor] = None):
        """The outputs as views into `buf` (default: a copy of `self.buf`,
        one device op); `buf` may carry leading dims (a row a frame), which
        every output then carries too. With spans on, the host span `read`."""
        t = spans.start()
        buf = self.buf.clone() if buf is None else buf
        lead = tuple(buf.shape[:-1])

        def view(s):
            if not isinstance(s, _Slot):
                return s
            return buf[..., s.offset:s.offset + s.n_bytes].view(s.dtype).reshape(lead + s.shape)

        out = _map_slots(view, self.tree)
        spans.host("read", t)
        return out


def _map_slots(fn, tree):
    if isinstance(tree, _Slot):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_slots(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_slots(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_slots(fn, v) for k, v in tree.items()}
    return tree


def pack(out) -> Outputs:
    """`out`'s tensors as the bytes of one buffer (one cat), each at an
    offset aligned to 8 bytes."""
    parts, offset = [], 0

    def slot(t):
        nonlocal offset
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % _PAD
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=t.device))
        s = _Slot(offset, b.numel(), t.dtype, tuple(t.shape))
        offset += b.numel() + pad
        return s

    tree = tree_map(slot, out)
    if not parts:
        raise ValueError("a captured step needs at least one output tensor")
    return Outputs(torch.cat(parts), tree)


# ----- the caller's state: un-aliased, then written back in place ----------

def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def unalias(state):
    """`state` with each tensor that shares its memory with another tensor
    of the state, or whose elements overlap (a stride-0 expansion), or
    that is not contiguous, replaced by a contiguous copy of its own: the
    copy-back writes every tensor of the state, and two writes into one
    memory would leave only the last."""
    seen: dict = {}
    for t in leaves(state):
        seen[_storage(t)] = seen.get(_storage(t), 0) + 1

    def own(t):
        shared = t.numel() > 0 and seen[_storage(t)] > 1
        return t.clone(memory_format=torch.contiguous_format) if shared or not t.is_contiguous() else t

    return tree_map(own, state)


def copy_back(state, new_state) -> None:
    """Write each tensor of `new_state` into the caller's tensor of `state`
    at the same place (skipping the ones the step returned as they were, or
    wrote in place: the same memory, shape and strides). A new tensor that
    shares memory with a tensor of the state (the step passed one field on
    as another) is copied first, so that no write reads what an earlier
    write has overwritten."""
    if _structure(state, _layout) != _structure(new_state, _layout):
        raise TypeError("the step changed the structure, shapes or dtypes of its state")
    dst, src = leaves(state), leaves(new_state)
    owned = {_storage(d) for d in dst}
    pairs = [(d, s.clone() if _storage(s) in owned else s) for d, s in zip(dst, src)
             if _address(s) != _address(d)]
    for d, s in pairs:
        d.copy_(s)


# ----- graphs ---------------------------------------------------------------

class _Graph:
    """One captured step: the graph, its static inputs and outputs, and
    what the smoke reports of it."""

    def __init__(self, name: str):
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.frame = None  # static inputs, the frame's tensors are copied into them
        self.out: Optional[Outputs] = None
        self.launches: dict = {}  # hand kernel nodes of the graph, by launch counter: launches a replay
        self.tally: dict = {}  # launches the wrappers counted during capture (equal to `launches`)
        self.counters: dict = {}  # K1's ticket counters of this graph
        self.capture_seconds = 0.0  # warm-up, capture and instantiation
        self.pool_bytes = 0  # device memory the graph's pool reserved during capture
        self.nodes = self.kernel_nodes = 0
        self.replays = 0
        self.dead = False

    def stats(self) -> dict:
        return {"name": self.name, "capture_s": self.capture_seconds, "pool_bytes": self.pool_bytes,
                "nodes": self.nodes, "kernel_nodes": self.kernel_nodes, "replays": self.replays,
                "launches": dict(self.launches), "tally": dict(self.tally)}


# the live graphs by key, least recently replayed first: like jit's cache,
# one for the process
_graphs: "OrderedDict[tuple, _Graph]" = OrderedDict()


@functools.cache
def _capture_stream(index: int) -> torch.cuda.Stream:
    """The stream a device's warm-ups and captures run on."""
    return torch.cuda.Stream(torch.device("cuda", index))


def graphs() -> list:
    """stats() of each live graph, oldest first."""
    _drop_dead()
    return [g.stats() for g in _graphs.values()]


def clear() -> None:
    """Free every graph and its pool."""
    _graphs.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _drop_dead() -> None:
    for key in [k for k, g in _graphs.items() if g.dead]:
        del _graphs[key]


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _cu(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed ({err})")


def _kernel_name(cu, node: ctypes.c_void_p) -> str:
    """The name of the function a kernel node launches."""
    p = _KernelNodeParams()
    _cu("cuGraphKernelNodeGetParams", cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)))
    name = ctypes.c_char_p()
    if p.func and cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)) == 0:
        return name.value.decode()
    if p.kern and cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)) == 0:
        return name.value.decode()
    raise RuntimeError("a kernel node of a captured graph has no function name")


def _graph_kernels(graph: torch.cuda.CUDAGraph) -> tuple:
    """(nodes, kernel nodes, {launch counter: its kernel nodes}) of a
    captured graph, read through libcuda's graph API: the hand kernels it
    holds, by the names of their functions (build.counter_of)."""
    cu = ctypes.CDLL("libcuda.so.1")
    h = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu("cuGraphGetNodes", cu.cuGraphGetNodes(h, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _cu("cuGraphGetNodes", cu.cuGraphGetNodes(h, nodes, ctypes.byref(n)))
    kind = ctypes.c_int(0)
    kernels, hand = 0, {}
    for node in nodes:
        node = ctypes.c_void_p(node)
        _cu("cuGraphNodeGetType", cu.cuGraphNodeGetType(node, ctypes.byref(kind)))
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        kernels += 1
        counter = build.counter_of(_kernel_name(cu, node))
        if counter is not None:
            hand[counter] = hand.get(counter, 0) + 1
    return n.value, kernels, hand


def _capture(name: str, body: Callable, state, frame, device: torch.device) -> _Graph:
    g = _Graph(name)
    t0 = time.perf_counter()
    g.frame = tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), frame)
    stream = _capture_stream(device.index)
    stream.wait_stream(torch.cuda.current_stream(device))
    with icp_kernel.graph_counters(g.counters):
        # warm-up: one real frame on a clone of the state, on the capture
        # stream; its launches rehearse the graph's and are not counted
        with build.tally(), torch.cuda.stream(stream), spans.paused():
            warm = tree_map(torch.clone, state)
            new_warm, _out = body(warm, g.frame)
            copy_back(warm, new_warm)
            del warm, new_warm, _out
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with build.tally() as tally:
            with torch.cuda.graph(graph, stream=stream):
                reserved = torch.cuda.memory_reserved(device)
                g.out = _step(body, state, g.frame)
        g.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    graph.instantiate()
    g.nodes, g.kernel_nodes, g.launches = _graph_kernels(graph)
    g.graph, g.tally = graph, tally
    if g.launches != g.tally:
        raise RuntimeError(f"captured {name!r}: the graph holds the hand kernels {g.launches}, but their wrappers "
                           f"counted {g.tally} launches during capture")
    g.capture_seconds = time.perf_counter() - t0
    return g


def _step(body: Callable, state, frame) -> Outputs:
    """The step between its begin and end marks: the body, its copy into
    the caller's state, its packed outputs."""
    spans.phase("begin")
    new_state, out = body(state, frame)
    copy_back(state, new_state)
    packed = pack(out)
    spans.phase("end")
    return packed


def run(name: str, static: tuple, body: Callable, state, frame):
    """One step, `body(state, frame) → (new_state, out)`, as the module
    docstring says: a graph replay on the card, the body eagerly on the
    CPU. `state` holds the caller's tensors the step updates, `frame` the
    tensors that may change every call (copied into static inputs).
    Returns (state, Outputs): the caller's state, written in place (a
    tensor `unalias` had to copy is replaced, once), and the packed
    outputs."""
    state = unalias(state)
    first = leaves(state)[0]
    spans.step()
    if first.device.type != "cuda":
        return state, _step(body, state, frame)
    _drop_dead()
    ring = spans.ring()
    key = (name, static, _structure(ring, _address), _structure(state, _address), _structure(frame, _layout))
    g = _graphs.get(key)
    if g is None:
        g = _capture(name, body, state, frame, first.device)
        _graphs[key] = g
        for t in leaves(state) + list(ring):
            _watch(t, g)
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
    _graphs.move_to_end(key)
    t = spans.start()
    for dst, src in zip(leaves(g.frame), leaves(frame)):
        dst.copy_(src, non_blocking=True)
    spans.host("stage", t)
    t = spans.start()
    g.graph.replay()
    spans.host("replay", t)
    g.replays += 1
    build.add_launches(g.launches)
    return state, g.out


# the weak references that retire a graph when a tensor it reads is freed,
# by id (a weak reference compares its tensors when two hash alike)
_watchers: dict = {}


def _watch(t: torch.Tensor, g: _Graph) -> None:
    gref = weakref.ref(g)

    def retire(ref):
        _watchers.pop(id(ref), None)
        graph = gref()
        if graph is not None:
            graph.dead = True  # dropped at the next run, never during a capture

    ref = weakref.ref(t, retire)
    _watchers[id(ref)] = ref

