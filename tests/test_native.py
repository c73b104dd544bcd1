"""Native (C++) BVH builder agrees exactly with the NumPy reference."""

import os

import numpy as np
import pytest

from myraytracer_tpu.runtime.native import native_available, build_bvh_native


def _python_build(v0, v1, v2, leaf_size):
    os.environ["MRT_NO_NATIVE"] = "1"
    try:
        from myraytracer_tpu.ops.bvh import build_bvh

        return build_bvh(v0, v1, v2, leaf_size=leaf_size)
    finally:
        del os.environ["MRT_NO_NATIVE"]


needs_native = pytest.mark.skipif(
    not native_available(), reason="native runtime not built"
)


@needs_native
@pytest.mark.parametrize("n,leaf", [(1, 2), (7, 2), (300, 2), (300, 4), (1000, 8)])
def test_native_matches_python(n, leaf):
    rng = np.random.default_rng(n)
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    tri = (base + rng.normal(size=(n, 3, 3)) * 0.5).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    a = build_bvh_native(v0, v1, v2, leaf)
    b = _python_build(v0, v1, v2, leaf)

    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.left, b.left)
    np.testing.assert_array_equal(a.first, b.first)
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.entry, b.entry)
    np.testing.assert_array_equal(a.skip, b.skip)
    np.testing.assert_allclose(a.bbmin, b.bbmin, rtol=1e-6)
    np.testing.assert_allclose(a.bbmax, b.bbmax, rtol=1e-6)
    assert a.max_leaf == b.max_leaf


@needs_native
def test_native_degenerate_centroids():
    rng = np.random.default_rng(0)
    tri = np.tile(rng.normal(size=(1, 3, 3)).astype(np.float32), (33, 1, 1))
    a = build_bvh_native(tri[:, 0], tri[:, 1], tri[:, 2], 2)
    b = _python_build(tri[:, 0], tri[:, 1], tri[:, 2], 2)
    assert a.max_leaf <= 2
    np.testing.assert_array_equal(a.count, b.count)


@needs_native
def test_native_is_faster_at_scale():
    import time

    rng = np.random.default_rng(1)
    n = 40000
    base = rng.uniform(-50, 50, size=(n, 1, 3))
    tri = (base + rng.normal(size=(n, 3, 3)) * 0.5).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    t0 = time.perf_counter()
    build_bvh_native(v0, v1, v2, 4)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _python_build(v0, v1, v2, 4)
    t_py = time.perf_counter() - t0
    assert t_native < t_py, (t_native, t_py)


@needs_native
@pytest.mark.parametrize("n", [300, 2000])
def test_native_sah_matches_python(n):
    rng = np.random.default_rng(n + 1)
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    tri = (base + rng.normal(size=(n, 3, 3)) * 0.5).astype(np.float32)
    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]

    a = build_bvh_native(v0, v1, v2, 4, builder="sah")

    os.environ["MRT_NO_NATIVE"] = "1"
    try:
        from myraytracer_tpu.ops.bvh import build_bvh

        b = build_bvh(v0, v1, v2, leaf_size=4, builder="sah")
    finally:
        del os.environ["MRT_NO_NATIVE"]

    assert a.n_nodes == b.n_nodes
    np.testing.assert_array_equal(a.order, b.order)
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.entry, b.entry)
    np.testing.assert_allclose(a.bbmin, b.bbmin, rtol=1e-6)


def test_stale_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than bvh_builder.cpp is rebuilt before loading."""
    import shutil

    from myraytracer_tpu.runtime import native

    here = tmp_path / "runtime"
    here.mkdir()
    for f in ("bvh_builder.cpp", "build.sh"):
        shutil.copy(os.path.join(native._HERE, f), here / f)
    so = here / "libmrt_runtime.so"
    so.write_bytes(b"stale: not a shared library")
    src = here / "bvh_builder.cpp"
    os.utime(so, (1_000_000, 1_000_000))  # far older than the source
    monkeypatch.setattr(native, "_HERE", str(here))
    monkeypatch.setattr(native, "_SO", str(so))
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert native._stale(str(so), str(src))
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler to rebuild with")
    assert native.native_available()
    assert so.read_bytes()[:4] == b"\x7fELF"
    assert not native._stale(str(so), str(src))
    assert not list(here.glob("*.tmp"))
