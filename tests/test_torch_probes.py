"""The probes' kernels P1-P6 (infinitam_tpu_torch/probes/, ops/kernels/probes.py)
held to the JAX probes' Pallas bodies on the CPU.

One case per `pl.pallas_call` site of tools/ (16): the site's body is lifted
out of the unedited script with `ast` (the scripts run their benchmarks at
import, so they cannot be imported) and run in Pallas interpret mode in a
namespace where `pl.pallas_call` adds `interpret=True` and keeps its output
and the module's constants are shrunk (literal sizes too, where a body
spells them out); for probe8 and probe10, whose `attempt` only prints,
`jax.jit` is the identity. The port's side runs through the kernel wrappers
on CPU tensors, that is through the plain twins. Bars: P1, P4, probe13's
`rk` and `sk` and P2's copies bit for bit; P2's taps within 1e-6 (the XLA
CPU build forms some `row + tap · s` as one FMA); `kacc` and P6 within 1e-5
(sum order); P5 within one bf16 ulp of the JAX output (both also within
the float32 summation bound of the exact product,
plain.bf16_product_bound), and bit for bit on integer inputs whose sums
are exact in float32.

Besides: `sk`'s repeated rows gain 1 once, int8 wraps around, the aliased
updates leave their unlisted rows untouched, the P2 precondition (distinct
written rows) holds for the probes' inputs and the plain twin raises on a
repeat, probe9.py:115's own call fails under this jax (the reference fault
the port does not copy), and `python -m infinitam_tpu_torch.probes --cpu`
runs all nine probes.
"""

import ast
import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from infinitam_tpu_torch.ops.kernels import build, probes
from infinitam_tpu_torch.probes import (
    __main__ as probes_main,
    plain,
    probe6,
    probe7,
    probe8,
    probe9,
    probe10,
    probe12,
    probe13,
)

# the tensors here are small: one intra-op thread per process keeps torch from
# contending for the cores with the other test workers (tier-1 runs under xdist)
torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parents[1] / "tools"
S3, WIN = 512, 128


class PallasInterpret:
    """`pl` with `pallas_call` in interpret mode, keeping each call's output."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *args, **kwargs):
        call = pl.pallas_call(*args, interpret=True, **kwargs)

        def run(*operands):
            out = call(*operands)
            self.outputs.append(out)
            return out

        return run


class JaxNoJit:
    """`jax` with `jit` the identity."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **_kw):
        return fn


class Literals(ast.NodeTransformer):
    """Replaces the integer literals named in `sizes` (a body's spelled-out
    sizes) by smaller ones."""

    def __init__(self, sizes):
        self.sizes = sizes

    def visit_Constant(self, node):
        if type(node.value) is int and node.value in self.sizes:
            return ast.copy_location(ast.Constant(self.sizes[node.value]), node)
        return node


def lift(script: str, names, *, literals=None, jit=True, **consts):
    """The named top-level functions of tools/`script`, exec'd in a namespace
    of `consts` with `pl.pallas_call` in interpret mode; returns (namespace,
    the pallas shim that holds the calls' outputs)."""
    tree = ast.parse((TOOLS / script).read_text())
    nodes = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in nodes) == sorted(names), f"{script} lacks one of {names}"
    module = ast.fix_missing_locations(Literals(literals or {}).visit(ast.Module(body=nodes, type_ignores=[])))
    shim = PallasInterpret()
    ns = dict(jax=jax if jit else JaxNoJit(), jnp=jnp, pl=shim, pltpu=pltpu, np=np, print=lambda *a, **k: None,
              **consts)
    exec(compile(module, str(TOOLS / script), "exec"), ns)
    return ns, shim


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(a)


def assert_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.from_numpy(want.copy()).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def assert_close(got: torch.Tensor, want, atol: float) -> None:
    err = float(np.max(np.abs(got.numpy().astype(np.float64) - np.asarray(want, np.float64))))
    assert err <= atol, err


# --- P1 gather ---------------------------------------------------------------


def test_probe2_take_matches_callA():
    """tools/probe2.py:27 (`callA`, body `kA`): take from f32, int8 and int32
    tables, bit for bit."""
    ns, _ = lift("probe2.py", ["kA", "callA"])
    rng = np.random.default_rng(0)
    for tab in (rng.standard_normal(4096).astype(np.float32), rng.integers(-128, 128, 8192).astype(np.int8),
                rng.integers(-2**31, 2**31 - 1, 4096, dtype=np.int32)):
        idx = rng.integers(0, tab.size, 2048, dtype=np.int32)
        assert_equal(probes.gather(T(tab), T(idx)), ns["callA"](J(tab), J(idx)))


def test_probe2_take_along_axis_matches_callB():
    """tools/probe2.py:47 (`callB`, body `kB`): [1024, 128] by [8, 128]."""
    ns, _ = lift("probe2.py", ["kB", "callB"])
    rng = np.random.default_rng(1)
    tab = rng.standard_normal((1024, 128)).astype(np.float32)
    idx = rng.integers(0, 1024, (8, 128), dtype=np.int32)
    assert_equal(probes.gather(T(tab), T(idx), axis=0), ns["callB"](J(tab), J(idx)))


@pytest.mark.parametrize("case", [(8, 128, "float32", 0), (8, 128, "float32", 1), (64, 128, "int8", 0),
                                  (8, 128, "int8", 1), (32, 128, "bfloat16", 0)])
def test_probe6_gather_chain_matches_try_dg(case):
    """tools/probe6.py:42 (`try_dg.call`, body `kern`): 4 chained gathers with
    the script's feedback, on its own tables, give the same indices."""
    rows, cols, dtype, axis = case
    calls = []

    def timed(f, *args, n=3):
        calls.append((args, f(*args)))
        return 0.0

    ns, _ = lift("probe6.py", ["try_dg"], K=4, key=jax.random.PRNGKey(0), timed=timed, report=lambda *a: None)
    ns["try_dg"](rows, cols, getattr(jnp, dtype), axis, "case")
    assert len(calls) == 1, "try_dg failed"
    (tab, idx), want = calls[0]
    tab_t = torch.from_numpy(np.array(tab.astype(jnp.float32))).to(getattr(torch, dtype))
    assert_equal(probe6.call(tab_t, T(idx), axis, k_steps=4), want)


# --- P2 row update -----------------------------------------------------------


def test_probe7_update_matches_run():
    """tools/probe7.py:77 (`run`, body `kernel`): the in-place bf16-tap
    update on the script's correctness case (512 rows, 64 steps), ≤ 1e-6;
    the rows no step lists are untouched."""
    ns, _ = lift("probe7.py", ["kernel", "run"], S3=S3, WIN=WIN)
    args = probe7.make(512, 64)
    want = np.asarray(ns["run"](*map(J, args)))
    got = probe7.update(probes.row_update, *map(T, args))
    assert_close(got, want, 1e-6)
    untouched = np.setdiff1d(np.arange(512), args[2])
    assert_equal(got[untouched], args[0][untouched])
    np.testing.assert_array_equal(want[untouched], args[0][untouched])


def probe8_namespace(rows, nv, zero_rows=False):
    vba, depth, ptr, wv, wu = probe8.make(rows, nv)
    if zero_rows:
        vba = np.zeros_like(vba)
    consts = dict(B=rows, S3=S3, NV=nv, WIN=WIN, vba=J(vba.reshape(rows, 8, 64)), depth=J(depth), ptrs=J(ptr),
                  wv=J(wv), wu=J(wu))
    ns, shim = lift("probe8.py", ["attempt", "k1", "k2", "k3", "k4", "k5"], jit=False, **consts)
    return ns, shim, (vba, depth, ptr, wv, wu)


def test_probe8_bodies_match_attempt():
    """tools/probe8.py:28 (`attempt`, bodies k1-k5): the copies bit for bit,
    the taps within 1e-6; the fresh output is compared on its written rows."""
    ns, shim, (vba, depth, ptr, wv, wu) = probe8_namespace(512, 32)
    cases = [("k1", {}, dict(mul=1.000001)), ("k1", dict(alias=False), dict(mul=1.000001, in_place=False)),
             ("k2", {}, dict(mul=1.000001)), ("k3", dict(with_win=True), dict(tap="bf16", tap_scale=1e-3)),
             ("k4", dict(with_win=True), dict(tap="sum", tap_scale=1e-9)), ("k5", {}, dict(gate="ptr", mul=1.000001))]
    for body, opts, kw in cases:
        n = len(shim.outputs)
        ns["attempt"](body, ns[body], **opts)
        assert len(shim.outputs) == n + 1, f"attempt {body} {opts} failed"
        want = np.asarray(shim.outputs[-1]).reshape(512, S3)
        got = probe8.attempt(probes.row_update, T(vba), T(depth), T(ptr), T(wv), T(wu), **kw)
        rows = ptr if kw.get("in_place", True) is False else np.arange(512)
        if "tap" in kw:
            assert_close(got[rows], want[rows], 1e-6)
        else:
            assert_equal(got[rows], want[rows])


def test_probe8_window_sum_on_zero_rows():
    """k4's 1e-9 · Σwindow vanishes beside rows of unit size: on zero rows
    the output is the scaled sum itself, held to 1e-5 of its size (the two
    sums of 16,384 terms run in different orders)."""
    ns, shim, (vba, depth, ptr, wv, wu) = probe8_namespace(512, 32, zero_rows=True)
    ns["attempt"]("k4", ns["k4"], with_win=True)
    want = np.asarray(shim.outputs[-1]).reshape(512, S3)[ptr]
    got = probe8.attempt(probes.row_update, T(vba), T(depth), T(ptr), T(wv), T(wu), tap="sum",
                         tap_scale=1e-9)[ptr].numpy()
    assert np.abs(want).min() > 0
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_probe9_integrate_pattern_matches_run():
    """tools/probe9.py:53 (`run`, body `kernel`): the transposed float32 tap
    with `valid`, in place, ≤ 1e-6; unlisted rows untouched."""
    ns, _ = lift("probe9.py", ["kernel", "run"], S3=S3, WIN=WIN)
    args = probe9.make(512, 64)
    want = np.asarray(ns["run"](*map(J, args)))
    got = probe9.update(probes.row_update, *map(T, args))
    assert_close(got, want, 1e-6)
    untouched = np.setdiff1d(np.arange(512), args[2])
    assert_equal(got[untouched], args[0][untouched])


ROWS10, NV10 = 512, 64


@pytest.fixture(scope="module")
def probe10_runs():
    """Each of tools/probe10.py's 8 attempts, run through its `attempt` with
    the JAX namespace's outputs kept: (inputs, [output per attempt])."""
    vba, depth_t, ptr, seq, wv, wu = probe10.make(ROWS10, NV10)
    consts = dict(S3=S3, WIN=WIN, B=ROWS10, NV=NV10, vba=J(vba.reshape(ROWS10, 1, S3)), depthT=J(depth_t),
                  ptrs=J(ptr), seq=J(seq), wv=J(wv), wu=J(wu), OVH=0.0)

    def timed(f, *args, n=3):
        f(*args)
        return 0.0

    ns, shim = lift("probe10.py", ["attempt"], jit=False, timed=timed, **consts)
    outs = []
    for _name, (dynamic, in_place, tap) in probe10.ATTEMPTS:
        n = len(shim.outputs)
        kw = dict(dyn_in=dynamic, dyn_out=dynamic, alias=in_place, window=tap, matmul=tap)
        if _name.endswith("arbitrary"):
            kw["semantics"] = "arbitrary"
        if _name.startswith("copy+window"):
            kw["window"] = True
        ns["attempt"](_name, **kw)
        assert len(shim.outputs) == n + 1, f"attempt {_name} failed"
        outs.append(np.asarray(shim.outputs[-1]).reshape(ROWS10, S3))
    return (vba, depth_t, ptr, seq, wv, wu), outs


def test_probe10_attempts_match(probe10_runs):
    """tools/probe10.py:69 (`attempt`, body `kern`): the 8 attempts, copies
    bit for bit and taps within 1e-6; the aliased ones on every row (the
    unlisted rows untouched), the others on their written rows."""
    args, outs = probe10_runs
    for (name, flags), want in zip(probe10.ATTEMPTS, outs):
        dynamic, in_place, tap = flags
        got = probe10.attempt(probes.row_update, *map(T, args), *flags)
        rows = np.arange(ROWS10) if in_place else (args[2] if dynamic else np.arange(NV10))
        if tap:
            assert_close(got[rows], want[rows], 1e-6)
        else:
            assert_equal(got[rows], want[rows])
        if in_place:
            untouched = np.setdiff1d(np.arange(ROWS10), args[2] if dynamic else np.arange(NV10))
            assert_equal(got[untouched], args[0][untouched])


def test_probe10_library_calls_compute_the_static_copies(probe10_runs):
    """probe10.LIBRARY: the library call beside each static-map copy
    (`vba[:NV].mul_`, `torch.mul(vba[:NV], ·)`) computes the attempt's
    written rows, bit for bit with the JAX output."""
    args, outs = probe10_runs
    for (name, _flags), want in zip(probe10.ATTEMPTS, outs):
        if name in probe10.LIBRARY:
            got = probe10.LIBRARY[name](T(args[0]), NV10)
            assert got.shape == (NV10, S3), name
            assert_equal(got, want[:NV10])


@pytest.mark.parametrize("attempt", [0, 2, 6])
def test_probe10_simple_design_matches(probe10_runs, attempt):
    """P2's design its chunks replaced (kept for comparisons on the card) at
    three of tools/probe10.py:69's attempts (static no-alias, dynamic alias,
    the transposed tap): on the CPU its wrapper takes the plain twin, as
    the JAX outputs."""
    args, outs = probe10_runs
    (name, flags), want = probe10.ATTEMPTS[attempt], outs[attempt]
    got = probe10.attempt(probes.row_update_simple, *map(T, args), *flags)
    dynamic, in_place, tap = flags
    rows = np.arange(ROWS10) if in_place else (args[2] if dynamic else np.arange(NV10))
    if tap:
        assert_close(got[rows], want[rows], 1e-6)
    else:
        assert_equal(got[rows], want[rows])


def test_probe12_integ_matches():
    """tools/probe12.py:105 (`integ`, body `kern`): not aliased, row + 1e-9 ·
    tap, compared on the written rows, ≤ 1e-6."""
    vba, depth_t, ptr, _seq, wv, wu = probe10.make(512, 64)
    ns, _ = lift("probe12.py", ["kern", "integ"], S3=S3, WIN=WIN, B=512, NV=64, depthT=J(depth_t), ptrs=J(ptr),
                 wv=J(wv), wu=J(wu))
    want = np.asarray(ns["integ"](J(vba.reshape(512, 1, S3)))).reshape(512, S3)
    got = probe12.integ(probes.row_update, T(vba), T(depth_t), T(ptr), T(wv), T(wu))
    assert_close(got[ptr], want[ptr], 1e-6)
    # 1e-9 · tap vanishes beside rows of unit size: on zero rows the output
    # is the scaled tap itself, held to 1e-6 of its size
    zeros = np.zeros_like(vba)
    want = np.asarray(ns["integ"](J(zeros.reshape(512, 1, S3)))).reshape(512, S3)[ptr]
    got = probe12.integ(probes.row_update, T(zeros), T(depth_t), T(ptr), T(wv), T(wu))[ptr].numpy()
    assert np.abs(want).min() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def probe13_rows(nb=64, nv=128):
    vol = np.random.default_rng(3).integers(-128, 128, (nb, S3)).astype(np.int8)
    vol[:, :4] = [127, -128, 126, -1]  # int8 wraps at 127
    rows = probe13.make_rows(nb, nv)
    return vol, rows


def test_probe13_row_stores_match_sc():
    """tools/probe13.py:113 (`sc`, body `sk`): int8 +1 in place, bit for bit,
    on rows drawn with repeats."""
    vol, rows = probe13_rows()
    ns, _ = lift("probe13.py", ["sk", "sc"], NB=64, S3=S3, NVv=128)
    want = np.asarray(ns["sc"](J(vol), J(rows)))
    assert_equal(probe13.row_stores(probes.row_update, T(vol), T(rows)), want)


def test_probe13_row_stores_simple_design_match_sc():
    """P2's design its chunks replaced, at tools/probe13.py:113 (`sc`, body
    `sk`): on the CPU its wrapper takes the plain twin, bit for bit."""
    vol, rows = probe13_rows()
    ns, _ = lift("probe13.py", ["sk", "sc"], NB=64, S3=S3, NVv=128)
    assert_equal(probe13.row_stores(probes.row_update_simple, T(vol), T(rows)), ns["sc"](J(vol), J(rows)))


def test_sk_adds_one_once_to_a_repeated_row_and_wraps():
    """A row listed several times gains 1 once, in JAX and in the port; 127
    wraps to -128; unlisted rows are untouched."""
    vol, rows = probe13_rows()
    counts = np.bincount(rows, minlength=64)
    assert counts.max() >= 3, "the rows must repeat for this case"
    got = probe13.row_stores(probes.row_update, T(vol), T(rows)).numpy()
    listed = counts > 0
    np.testing.assert_array_equal(got[listed], (vol[listed].astype(np.int32) + 1).astype(np.int8))
    np.testing.assert_array_equal(got[~listed], vol[~listed])
    assert (got[listed][:, 0] == -128).all() and (got[listed][:, 1] == -127).all()


def test_row_update_precondition_distinct_rows():
    """The probes' step lists name distinct rows (permutations); the plain
    twin raises where two steps would write one row (the kernel would race),
    but not for the gate 'first'."""
    for ptr in (probe7.make(512, 64)[2], probe8.make(512, 32)[2], probe9.make(512, 64)[2],
                probe10.make(512, 64)[2]):
        assert np.unique(ptr).size == ptr.size
    vba = torch.zeros((8, S3))
    with pytest.raises(ValueError, match="distinct"):
        plain.row_update(vba, torch.tensor([1, 2, 1], dtype=torch.int32), mul=2.0)
    plain.row_update(torch.zeros((8, S3), dtype=torch.int8), torch.tensor([1, 2, 1], dtype=torch.int32),
                     gate="first")


@pytest.mark.parametrize("in_place", [True, False])
def test_row_update_valid_gate_keeps_a_gated_row(in_place):
    """A step the valid gate turns off keeps its row as it is: in place the
    row is left untouched (the kernel returns before it reads it), into a
    fresh output the row is copied; a step it keeps is updated."""
    vba = torch.from_numpy(np.random.default_rng(6).standard_normal((8, S3)).astype(np.float32))
    ptr, valid = torch.tensor([5, 2, 7], dtype=torch.int32), torch.tensor([1, 0, 1], dtype=torch.int32)
    got = probes.row_update(vba.clone(), ptr, in_place=in_place, gate="valid", valid=valid, mul=2.0)
    assert_equal(got[[2]], vba[[2]].numpy())
    assert_equal(got[[5, 7]], 2.0 * vba[[5, 7]].numpy())
    if in_place:
        assert_equal(got[[0, 1, 3, 4, 6]], vba[[0, 1, 3, 4, 6]].numpy())


# --- P3 page gather-sum ------------------------------------------------------


def run_acc(kacc, pages, ptrs, k):
    """tools/probe9.py:106 `run_acc` with its scratch inside the grid spec,
    as probe13.py:49 puts it: the call jax 0.9 accepts, around the script's
    unedited body `kacc`."""
    nt = ptrs.shape[0] // k
    gs = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(nt, k),
        in_specs=[pl.BlockSpec((1, 1, S3), lambda t, kk, p: (p[t * k + kk], 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, S3), lambda t, kk, p: (t, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((k, S3), jnp.float32)],
    )
    return pl.pallas_call(kacc, out_shape=jax.ShapeDtypeStruct((nt, 1, S3), jnp.float32), grid_spec=gs,
                          interpret=True)(ptrs, pages.reshape(pages.shape[0], 1, S3)).reshape(nt, S3)


def test_probe9_page_accumulator_matches_kacc():
    """tools/probe9.py:115 (`run_acc`, body `kacc`): P3 with K = 16 against
    the body in the call above, ≤ 1e-5."""
    ns, _ = lift("probe9.py", ["kacc"], K=16)
    pages, p = probe9.make_pages(256, 24)
    want = np.asarray(run_acc(ns["kacc"], J(pages), J(p), 16))
    assert_close(probe9.accumulate(probes.page_sum, T(pages), T(p)), want, 1e-5)


def test_embedding_bag_sum_is_the_page_accumulator():
    """The library call the smoke times beside P3 at `kacc`:
    F.embedding_bag(ids, pages, mode="sum") sums each tile's pages in k
    order, bit for bit the plain twin at probe9's layout."""
    pages, p = (T(a) for a in probe9.make_pages(256, 24))
    ids = p.reshape(-1, probe9.K)
    got = torch.nn.functional.embedding_bag(ids.long(), pages, mode="sum")
    assert torch.equal(got, plain.page_sum(pages, ids, probe9.K, S3))


def test_probe9_run_acc_fails_under_this_jax():
    """The reference fault the port does not copy: the script's own call
    passes scratch_shapes beside a grid_spec, which jax refuses."""
    ns, _ = lift("probe9.py", ["kacc", "run_acc"], K=16, S3=S3)
    pages, p = probe9.make_pages(64, 4)
    with pytest.raises(ValueError, match="scratch_shapes"):
        ns["run_acc"](J(pages), J(p))


def test_probe13_raycast_skeleton_matches_rc():
    """tools/probe13.py:51 (`rc`, body `rk`): int8 pages, the hashed column
    selector, 1e-6 · the sum; bit for bit (the sums of 48 int8 values are
    exact in float32)."""
    ns, _ = lift("probe13.py", ["rk", "rc"], NB=256, S3=S3, NT=16, KP=48)
    vol, pid = probe13.make_volume(256, 16)
    want = np.asarray(ns["rc"](J(vol), J(pid))).reshape(16, 128)
    assert_equal(probe13.raycast_skeleton(probes.page_sum, T(vol), T(pid)), want)


# --- P4 scaled copy ----------------------------------------------------------


def test_probe11_copy_matches_cp():
    """tools/probe11.py:58 (`cp`, body `ck`): 64 CTAs of 64 rows (the
    script's 65,536 rows shrunk to 4,096), bit for bit."""
    x = np.random.default_rng(4).standard_normal((4096, S3)).astype(np.float32)
    ns, _ = lift("probe11.py", ["ck", "cp"], literals={65536: 4096}, X=J(x))
    assert_equal(probes.scaled_copy(T(x), 64), ns["cp"](J(x)))


def test_probe11_tiny_copy_matches_cp2():
    """tools/probe11.py:73 (`cp2`, body `ck`): one-row CTAs (6,144 shrunk to
    256), bit for bit."""
    y = np.random.default_rng(5).standard_normal((256, S3)).astype(np.float32)
    ns, _ = lift("probe11.py", ["ck", "cp2"], literals={6144: 256})
    assert_equal(probes.scaled_copy(T(y), 1), ns["cp2"](J(y)))


@pytest.mark.parametrize("ctas,rows", [(64, 8), (8, 64), (1, 512)])
def test_probe12_copy_matches_cp(ctas, rows):
    """tools/probe12.py:59 (`cp`, body `ck`): the script's chain of 4
    copies at its three decompositions (shrunk to 512 rows), bit for bit."""
    ns, _ = lift("probe12.py", ["ck", "cp"])
    x = np.random.default_rng(6).standard_normal((ctas * rows, S3)).astype(np.float32)
    want, got = J(x), T(x)
    for _ in range(4):
        want, got = ns["cp"](want, ctas, rows), probes.scaled_copy(got, rows)
    assert_equal(got, want)


def test_probe11_copy_simple_design_matches_cp():
    """P4's design its ring replaced (kept for comparisons on the card) at
    tools/probe11.py:58, shrunk as above: on the CPU its wrapper takes the
    plain twin, bit for bit."""
    x = np.random.default_rng(4).standard_normal((4096, S3)).astype(np.float32)
    ns, _ = lift("probe11.py", ["ck", "cp"], literals={65536: 4096}, X=J(x))
    assert_equal(probes.scaled_copy_simple(T(x), 64), ns["cp"](J(x)))


# --- P5 bf16 GEMM ------------------------------------------------------------


@pytest.mark.parametrize("values", ["normal", "integer"])
def test_probe11_matmul_matches_mm(values):
    """tools/probe11.py:31 (`mm`, body `mk`) at 256³ in 128×128 tiles: within
    one bf16 ulp of the JAX output on normal inputs, both within the float32
    summation bound of the exact product (plain.bf16_product_bound); bit for
    bit on integer inputs in [-8, 8] (every partial sum exact in float32)."""
    n = 256
    ns, _ = lift("probe11.py", ["mk", "mm"], M=n, N=n, K=n, TM=128, TN=128)
    rng = np.random.default_rng(7)
    if values == "normal":
        a, b = (rng.standard_normal((n, n)).astype(np.float32) for _ in range(2))
    else:
        a, b = (rng.integers(-8, 9, (n, n)).astype(np.float32) for _ in range(2))
    a_j, b_j = J(a).astype(jnp.bfloat16), J(b).astype(jnp.bfloat16)
    want = torch.from_numpy(np.asarray(ns["mm"](a_j, b_j).astype(jnp.float32))).to(torch.bfloat16)
    got = probes.gemm_bf16(T(a).to(torch.bfloat16), T(b).to(torch.bfloat16))
    if values == "integer":
        assert torch.equal(got, want)
    else:
        ulps = (got.float() - want.float()).abs() / plain.bf16_ulp(torch.maximum(got.float().abs(),
                                                                                   want.float().abs()))
        assert float(ulps.max()) <= 1.0
        a_t, b_t = T(a).to(torch.bfloat16), T(b).to(torch.bfloat16)
        assert float(plain.bf16_product_bound(got, a_t, b_t).max()) <= 1.0
        assert float(plain.bf16_product_bound(want, a_t, b_t).max()) <= 1.0


def test_probe11_matmul_wmma_design_matches_mm():
    """P5's design its wgmma ring replaced (kept for comparisons on the
    card) at tools/probe11.py:31 on integer inputs at 256³: on the CPU its
    wrapper takes the plain twin, bit for bit with the JAX output."""
    n = 256
    ns, _ = lift("probe11.py", ["mk", "mm"], M=n, N=n, K=n, TM=128, TN=128)
    a, b = (np.random.default_rng(7 + i).integers(-8, 9, (n, n)).astype(np.float32) for i in range(2))
    want = torch.from_numpy(np.asarray(ns["mm"](J(a).astype(jnp.bfloat16), J(b).astype(jnp.bfloat16))
                                       .astype(jnp.float32))).to(torch.bfloat16)
    assert torch.equal(probes.gemm_bf16_wmma(T(a).to(torch.bfloat16), T(b).to(torch.bfloat16)), want)


# --- P6 window column sums ---------------------------------------------------


def test_probe13_window_sums_match_wc():
    """tools/probe13.py:85 (`wc`, body `wk`): 64×64 windows of the 512×768
    image at the tiles' starts, zero past column 64, ≤ 1e-5."""
    ns, _ = lift("probe13.py", ["wk", "wc"], H2=512, W2=768, NT=16)
    img, starts = probe13.make_window(16)
    want = np.asarray(ns["wc"](J(img), J(starts))).reshape(16, 128)
    got = probe13.window_sums(probes.window_sums, T(img), T(starts))
    assert_close(got, want, 1e-5)
    assert (got[:, 64:] == 0).all()


# --- the entry point ---------------------------------------------------------


def test_probes_entry_point_runs_every_probe_on_the_cpu():
    """`python -m infinitam_tpu_torch.probes --cpu`: all nine probes, the
    plain versions, no kernel launched; probe8's bodies equal their twins."""
    build.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        results = probes_main.main(["--cpu"])
    assert list(results) == list(probes_main.NAMES)
    assert all(results[name] for name in results)
    assert all(r["ok"] for r in results["probe8"])
    assert "device: cpu" in out.getvalue() and "correctness max err = 0.00e+00" in out.getvalue()
    assert build.launch_counts() == dict.fromkeys(build.KERNELS, 0)
    assert build.library.cache_info().currsize == 0
