"""Triangle strategies: the per-platform choice, and agreement of the
three XLA strategies (threaded-BVH walk, cluster scan, brute force) on
every golden scene.

The brute-force scan tests every triangle, so it is the reference the
other two must reproduce: the same hit kinds, hit/miss masks and shadow
masks on every Whitted segment, and the same primary closest-hit
distances.
"""

import jax
import numpy as np
import pytest

from myraytracer_tpu.ops import tracer as tr
from myraytracer_tpu.scenes import golden

SCALE = 0.08  # test_golden.py's scale: 40x40-ish


def test_default_tri_method_cpu():
    assert tr.default_tri_method("cpu") == "bvh"
    # the test backend is the CPU, so "auto" resolves to the same choice
    assert tr.TraceConfig().resolved_method() == "bvh"


def test_default_tri_method_gpu_is_a_measured_strategy():
    assert tr.default_tri_method("gpu") in ("bvh", "cluster", "brute")


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_default_tri_method_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no triangle strategy"):
        tr.default_tri_method(platform)


def test_explicit_tri_method_overrides_platform():
    for m in ("bvh", "cluster", "brute"):
        assert tr.TraceConfig(tri_method=m).resolved_method() == m


@pytest.mark.parametrize("name", sorted(golden.GOLDEN_SCENES))
def test_strategies_agree_with_brute_force(name):
    sc = golden.GOLDEN_SCENES[name][0](scale=SCALE)
    data = sc.build()
    xs, ys = sc.camera.pixel_grid()
    o, d = sc.camera.primary_rays(xs.ravel(), ys.ravel())

    def run(method):
        cfg = tr.TraceConfig(tri_method=method)

        @jax.jit
        def go(o, d):
            topo = tr.trace_topology(data, o, d, cfg)
            tri_flat, cl_tris = tr._tri_caches(data, cfg)
            hit = (tr._closest_tris(data, o, d, None, cfg, tri_flat, cl_tris)
                   if data.n_tris else None)
            return topo, hit

        return jax.tree.map(np.asarray, go(o, d))

    want_topo, want_hit = run("brute")
    assert want_topo.hit.any()
    for method in ("bvh", "cluster"):
        topo, hit = run(method)
        for field in ("kind", "hit", "miss", "shadow"):
            np.testing.assert_array_equal(
                getattr(topo, field), getattr(want_topo, field),
                err_msg=f"{name} {method} {field}")
        # triangles hit at the same distance (shared edges, coplanar
        # duplicates) may resolve to either index
        assert (topo.idx != want_topo.idx).mean() <= 0.02, (name, method)
        if want_hit is not None:
            np.testing.assert_allclose(hit.t, want_hit.t, rtol=1e-6,
                                       err_msg=f"{name} {method} t")
            np.testing.assert_array_equal(hit.idx >= 0, want_hit.idx >= 0)
