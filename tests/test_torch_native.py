"""The port's native host runtime (infinitam_tpu_torch/utils/native.py),
held to the JAX package's (infinitam_tpu/utils/native.py) and to the
pure-Python image IO (utils/image_io.py), on the CPU.

The port builds its own copy of the JAX package's native/itpu_io.cpp
(infinitam_tpu_torch/native/itpu_io.cpp) with g++ into build/native/ under a
name hashed from the source and flags; it never runs `make -C native`, so
the committed native/libitpu_io.so stays byte for byte as it was. The copy
keeps a prefetcher's out-of-order frames in that prefetcher (the JAX
package's source keeps one stash a thread), so two prefetchers read in turn
on one thread each get their own frames. Without a
source (or a compiler) every entry point keeps the JAX contract: None or
False, and the prefetcher raises RuntimeError. Outputs are compared exactly
(16-bit depth and 8-bit colour, the STL's header and vertices), but for the
STL's facet normals, within 1e-6: the committed JAX library was built with
-march=native, whose FMA contraction rounds the cross product otherwise.
"""

import hashlib
import os
import struct
from pathlib import Path

import numpy as np
import pytest

from infinitam_tpu.utils import native as j_native
from infinitam_tpu_torch.utils import image_io, native

REPO = Path(__file__).resolve().parents[1]
PREBUILT = REPO / "native" / "libitpu_io.so"


def digest(path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def prebuilt_digest():
    before = digest(PREBUILT)
    yield before
    assert digest(PREBUILT) == before  # the committed library is untouched


def test_library_builds_into_build_native(prebuilt_digest):
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert path.name.startswith("libitpu_io_") and path != PREBUILT
    for name in native.SIGNATURES:
        assert getattr(lib, name) is not None
    assert digest(PREBUILT) == prebuilt_digest


def test_pgm_reader_matches_jax_and_python(tmp_path, prebuilt_digest):
    img = np.random.default_rng(0).integers(0, 65535, (24, 32)).astype(np.uint16)
    p = str(tmp_path / "d.pgm")
    image_io.write_pgm(p, img)
    got = native.read_pgm_native(p, 24, 32)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, j_native.read_pgm_native(p, 24, 32))
    np.testing.assert_array_equal(got, image_io.read_pgm(p))
    assert native.read_pgm_native(p, 24, 33) is None  # another size
    assert native.read_pgm_native(str(tmp_path / "missing.pgm"), 24, 32) is None


def test_stl_writer_matches_jax(tmp_path, prebuilt_digest):
    tris = np.random.default_rng(1).standard_normal((7, 3, 3)).astype(np.float32)
    a, b = str(tmp_path / "a.stl"), str(tmp_path / "b.stl")
    assert native.write_stl_native(a, tris) and j_native.write_stl_native(b, tris)
    raw, jraw = open(a, "rb").read(), open(b, "rb").read()
    assert raw[:84] == jraw[:84] and len(raw) == len(jraw) == 84 + 7 * 50
    assert struct.unpack("<I", raw[80:84])[0] == 7
    rec = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])
    got, ref = np.frombuffer(raw[84:], dtype=rec), np.frombuffer(jraw[84:], dtype=rec)
    np.testing.assert_array_equal(got["v"], tris)
    np.testing.assert_array_equal(got["a"], ref["a"])
    # the facet normals: the committed library was built with -march=native,
    # whose FMA contraction rounds the cross product otherwise
    np.testing.assert_allclose(got["n"], ref["n"], rtol=0, atol=1e-6)


def test_prefetcher_matches_jax_and_python(tmp_path, prebuilt_digest):
    rng = np.random.default_rng(2)
    depth_paths, rgb_paths, frames = [], [], []
    for i in range(5):
        d = rng.integers(0, 5000, (16, 20)).astype(np.uint16)
        c = rng.integers(0, 255, (16, 20, 3)).astype(np.uint8)
        depth_paths.append(str(tmp_path / f"{i:04d}.pgm"))
        rgb_paths.append(str(tmp_path / f"{i:04d}.ppm"))
        image_io.write_pgm(depth_paths[-1], d)
        image_io.write_ppm(rgb_paths[-1], c)
        frames.append((d, c))
    # the two libraries side by side: each keeps its own out-of-order stash
    pf = native.NativePrefetcher(depth_paths, rgb_paths, 16, 20, n_threads=2)
    jpf = j_native.NativePrefetcher(depth_paths, rgb_paths, 16, 20, n_threads=2)
    for i in (0, 3, 1, 4, 2):
        (d, c), (jd, jc) = pf.get(i), jpf.get(i)
        np.testing.assert_array_equal(d, frames[i][0])
        np.testing.assert_array_equal(c, frames[i][1])
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(c, jc)
    assert pf.get(5) is None  # past the list
    for f in (pf, jpf):
        f.close()
    pf.close()  # a second close is a no-op
    # a depth-only prefetcher of the same library after the first is closed
    dpf = native.NativePrefetcher(depth_paths, None, 16, 20)
    for i in (4, 0, 2, 1, 3):
        d_only, none = dpf.get(i)
        np.testing.assert_array_equal(d_only, frames[i][0])
        assert none is None
    assert dpf.get(5) is None  # drained: nothing left in the stash
    dpf.close()


def write_frames(directory, seed, n, with_rgb):
    """n random 16×20 frames written as PGM (and PPM) files: (depth paths,
    rgb paths or None, [(depth, rgb or None)])."""
    rng = np.random.default_rng(seed)
    depth_paths, rgb_paths, frames = [], [], []
    for i in range(n):
        d = rng.integers(0, 5000, (16, 20)).astype(np.uint16)
        c = rng.integers(0, 255, (16, 20, 3)).astype(np.uint8) if with_rgb else None
        depth_paths.append(str(directory / f"{seed}_{i:04d}.pgm"))
        image_io.write_pgm(depth_paths[-1], d)
        if with_rgb:
            rgb_paths.append(str(directory / f"{seed}_{i:04d}.ppm"))
            image_io.write_ppm(rgb_paths[-1], c)
        frames.append((d, c))
    return depth_paths, rgb_paths if with_rgb else None, frames


def test_two_prefetchers_read_in_turn_on_one_thread(tmp_path, prebuilt_digest):
    """An RGB prefetcher and a depth-only one over other files, read in turn
    on this thread, each fetching out of order: every frame comes back
    whole and its own (with the JAX package's source, the first fetch of
    frame 4 leaves frames 0-3 in the thread's stash, and the depth-only
    prefetcher's frame 0 is then the RGB one's)."""
    n = 6
    rgb_paths_d, rgb_paths_c, rgb_frames = write_frames(tmp_path, 3, n, with_rgb=True)
    depth_paths, _none, depth_frames = write_frames(tmp_path, 4, n, with_rgb=False)
    a = native.NativePrefetcher(rgb_paths_d, rgb_paths_c, 16, 20, n_threads=2)
    b = native.NativePrefetcher(depth_paths, None, 16, 20, n_threads=2)
    try:
        for i, j in ((4, 0), (0, 4), (2, 5), (5, 1), (1, 2), (3, 3)):
            (ad, ac), (bd, bc) = a.get(i), b.get(j)
            np.testing.assert_array_equal(ad, rgb_frames[i][0])
            np.testing.assert_array_equal(ac, rgb_frames[i][1])
            np.testing.assert_array_equal(bd, depth_frames[j][0])
            assert bc is None
        assert a.get(n) is None and b.get(n) is None  # both drained
    finally:
        a.close()
        b.close()


def test_unbuildable_library_keeps_the_jax_contract(tmp_path, monkeypatch, prebuilt_digest):
    monkeypatch.setattr(native, "SOURCE", tmp_path / "absent.cpp")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.get_lib() is None
    assert native.read_pgm_native(str(tmp_path / "x.pgm"), 4, 4) is None
    assert native.write_stl_native(str(tmp_path / "x.stl"), np.zeros((1, 3, 3), np.float32)) is False
    assert not os.path.exists(tmp_path / "x.stl")
    with pytest.raises(RuntimeError):
        native.NativePrefetcher([], None, 4, 4)
