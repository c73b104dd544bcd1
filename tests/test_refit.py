"""Acceleration-structure refit under vertex optimization (ops/refit.py).

The reference can build its BVH bounds once because its geometry is
static (mybvh.cpp:44, :375 — init-time only). Here ``vertex_pos`` is an
optimizable leaf, so bounds must be refit from the CURRENT vertices or
culling silently drops hits. These tests pin:

  * refit == build-time bounds bit-for-bit when vertices are unchanged
    (min/max are exact, association-free);
  * after moving vertices ~0.5 object radii, the cluster and BVH paths
    agree EXACTLY with the brute-force all-triangles scan (conservative
    culling restored), while the stale-bounds render provably differs
    (the bug this module fixes);
  * an InverseRenderer vertex fit against a displaced-geometry target
    converges (refit applied automatically every step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from myraytracer_tpu.inverse import InverseRenderer
from myraytracer_tpu.models.material import Material
from myraytracer_tpu.models.mesh import TriangleMesh, PHONG
from myraytracer_tpu.models.scene import Scene
from myraytracer_tpu.ops import tracer as tr
from myraytracer_tpu.ops.refit import refit_accel
from myraytracer_tpu.ops.traverse import intersect_tris_brute

from test_grad import central_rays


def mesh_scene(nu=10, nv=14, cluster_size=16, leaf_size=2):
    from myraytracer_tpu.scenes.shapes import uv_sphere

    s = Scene()
    s.set_camera(eye=(0, 0.6, 5), center=(0, 0, 0), up=(0, 1, 0), fovy=45,
                 width=32, height=32)
    s.add_light((2, 4, 4), (0.8, 0.8, 0.8))
    s.ambience = (0.2, 0.2, 0.2)
    v, f = uv_sphere(0.8, nu, nv, center=(0.0, 0.0, 0.0))
    s.add_mesh(TriangleMesh(v, f, material=Material(diffuse=(0.2, 0.5, 0.7)),
                            draw_mode=PHONG))
    data = s.build(cluster_size=cluster_size, leaf_size=leaf_size)
    return s, data


def displace(data, shift=(0.9, 0.35, -0.4), scale=1.35):
    """Move + stretch the mesh well past the build-time bounds."""
    vp = np.asarray(data.vertex_pos)
    c = vp.mean(axis=0, keepdims=True)
    vp2 = (vp - c) * scale + c + np.asarray(shift, np.float32)
    return dataclasses.replace(data, vertex_pos=jnp.asarray(vp2))


def test_refit_identity_when_unmoved():
    _, data = mesh_scene()
    r = refit_accel(data)
    np.testing.assert_array_equal(np.asarray(r.bvh_bbmin), np.asarray(data.bvh_bbmin))
    np.testing.assert_array_equal(np.asarray(r.bvh_bbmax), np.asarray(data.bvh_bbmax))
    np.testing.assert_array_equal(np.asarray(r.cl_bbmin), np.asarray(data.cl_bbmin))
    np.testing.assert_array_equal(np.asarray(r.cl_bbmax), np.asarray(data.cl_bbmax))
    np.testing.assert_array_equal(np.asarray(r.bvh_nodes_packed),
                                  np.asarray(data.bvh_nodes_packed))


def test_node_ranges_cover_leaves():
    _, data = mesh_scene()
    lo = np.asarray(data.bvh_lo)
    hi = np.asarray(data.bvh_hi)
    first = np.asarray(data.bvh_first)
    count = np.asarray(data.bvh_count)
    # root covers everything; leaves match their stored range
    assert lo[0] == 0 and hi[0] == data.n_tris
    leaf = count > 0
    np.testing.assert_array_equal(lo[leaf], first[leaf])
    np.testing.assert_array_equal(hi[leaf], first[leaf] + count[leaf])
    # cluster ranges partition [0, T)
    cf = np.asarray(data.cl_first)
    cc = np.asarray(data.cl_count)
    order = np.argsort(cf)
    assert cf[order][0] == 0
    np.testing.assert_array_equal((cf + cc)[order][:-1], cf[order][1:])
    assert (cf + cc)[order][-1] == data.n_tris


def test_refit_bounds_contain_moved_tris():
    _, data = mesh_scene()
    moved = displace(data)
    r = refit_accel(moved)
    vp = np.asarray(moved.vertex_pos)
    tv = np.asarray(moved.tri_vidx)
    tmin = np.minimum(np.minimum(vp[tv[:, 0]], vp[tv[:, 1]]), vp[tv[:, 2]])
    tmax = np.maximum(np.maximum(vp[tv[:, 0]], vp[tv[:, 1]]), vp[tv[:, 2]])
    lo = np.asarray(r.bvh_lo)
    hi = np.asarray(r.bvh_hi)
    bmin = np.asarray(r.bvh_bbmin)
    bmax = np.asarray(r.bvh_bbmax)
    for n in range(r.n_nodes):
        assert np.all(bmin[n] <= tmin[lo[n]:hi[n]].min(axis=0))
        assert np.all(bmax[n] >= tmax[lo[n]:hi[n]].max(axis=0))
    cf = np.asarray(r.cl_first)
    cc = np.asarray(r.cl_count)
    for k in range(cf.shape[0]):
        assert np.all(np.asarray(r.cl_bbmin)[k] <= tmin[cf[k]:cf[k] + cc[k]].min(axis=0))
        assert np.all(np.asarray(r.cl_bbmax)[k] >= tmax[cf[k]:cf[k] + cc[k]].max(axis=0))


def test_refit_restores_exact_hits_after_displacement():
    s, data = mesh_scene()
    moved = displace(data)

    # aim rays at the DISPLACED mesh so the stale bounds actually cull
    vp = np.asarray(moved.vertex_pos)
    c = vp.mean(axis=0)
    eye = np.asarray([0, 0.6, 5.0], np.float32)
    rng = np.random.default_rng(3)
    targets = vp[rng.integers(0, vp.shape[0], 200)] * 0.8 + c * 0.2
    d = targets - eye
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    o, d = jnp.asarray(o), jnp.asarray(d)

    ref = intersect_tris_brute(moved, o, d)
    assert int(jnp.sum(ref.idx >= 0)) > 100  # rays genuinely hit

    refit = refit_accel(moved)
    for method in ("cluster", "bvh"):
        if method == "cluster":
            from myraytracer_tpu.ops.cluster import intersect_clusters
            fn = lambda sc: intersect_clusters(sc, o, d)
        else:
            from myraytracer_tpu.ops.traverse import traverse_bvh
            fn = lambda sc: traverse_bvh(sc, o, d)

        stale = fn(moved)
        assert int(jnp.sum(stale.idx >= 0)) < int(jnp.sum(ref.idx >= 0)), (
            f"{method}: stale bounds should drop hits "
            "(negative control for the refit)")

        fixed = fn(refit)
        np.testing.assert_array_equal(np.asarray(fixed.idx), np.asarray(ref.idx))
        finite = np.asarray(ref.idx) >= 0
        np.testing.assert_allclose(np.asarray(fixed.t)[finite],
                                   np.asarray(ref.t)[finite], rtol=1e-6)


def plate_scene(n=8):
    """Flat-shaded grid plate facing the camera: tilting it changes the
    face normals, so interior pixels carry smooth diffuse gradients (the
    well-conditioned regime of fixed-topology differentiation)."""
    s = Scene()
    s.set_camera(eye=(0, 0, 4), center=(0, 0, 0), up=(0, 1, 0), fovy=45,
                 width=32, height=32)
    s.add_light((2, 3, 4), (0.9, 0.9, 0.9))
    s.ambience = (0.15, 0.15, 0.15)
    xs = np.linspace(-1.2, 1.2, n + 1, dtype=np.float32)
    V = np.stack(np.meshgrid(xs, xs, indexing="ij"), axis=-1).reshape(-1, 2)
    verts = np.concatenate([V, np.zeros((V.shape[0], 1), np.float32)], axis=1)
    faces = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            b, c, dd = a + 1, a + (n + 1), a + (n + 1) + 1
            faces += [[a, c, b], [b, c, dd]]  # +z-facing winding
    from myraytracer_tpu.models.mesh import FLAT

    s.add_mesh(TriangleMesh(verts, np.asarray(faces, np.int32),
                            material=Material(diffuse=(0.3, 0.55, 0.75)),
                            draw_mode=FLAT))
    return s, s.build(cluster_size=16, leaf_size=2)


def rot_shift(data, deg=25.0, shift=(0.0, 0.0, 0.6)):
    a = np.radians(deg)
    R = np.array([[1, 0, 0],
                  [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]], np.float32)
    vp = np.asarray(data.vertex_pos) @ R.T + np.asarray(shift, np.float32)
    return dataclasses.replace(data, vertex_pos=jnp.asarray(vp))


def test_inverse_vertex_fit_on_displaced_target(monkeypatch):
    """Fit vertex_pos toward a tilted+shifted plate target. The target
    tilt leaves the build-time (flat, axis-aligned) leaf/cluster boxes
    immediately, so the per-step refit is load-bearing: the same fit with
    stale bounds (negative control) stalls at ~2x the loss."""
    s, data = plate_scene()
    target_scene = rot_shift(data)
    o, d = central_rays(s.camera, n=400, margin=0.02, seed=5)
    cfg = tr.TraceConfig(tri_method="cluster")
    target = tr.trace(refit_accel(target_scene), o, d, cfg)

    inv = InverseRenderer(data, param_names=("vertex_pos",),
                          optimizer=optax.adam(3e-2), cfg=cfg)
    res = inv.fit(o, d, target, steps=200)
    assert res.losses[-1] < 0.30 * res.losses[0]

    # negative control: identical fit with refit disabled (stale bounds)
    import myraytracer_tpu.inverse as invmod

    monkeypatch.setattr(invmod, "refit_accel", lambda sc: sc)
    inv2 = InverseRenderer(data, param_names=("vertex_pos",),
                           optimizer=optax.adam(3e-2), cfg=cfg)
    res2 = inv2.fit(o, d, target, steps=200)
    assert res2.losses[-1] > 1.5 * res.losses[-1], (
        "stale bounds should measurably hurt the fit — if this fails the "
        "refit is no longer load-bearing for this scenario")


def test_sharded_vertex_fit_matches_unsharded():
    """vertex_pos fit under an 8-device mesh == the single-device fit.

    Composes the two round-4 correctness pieces: the per-step accel
    refit (this module) running INSIDE the shard_map step with the
    scene replicated, and the sharded driver's psum'd grads. Early
    steps must match to fp32 reduction order; later steps diverge
    CHAOTICALLY by design (fp-order noise in the psum'd vertex grads
    moves cull boundaries, which flips discrete hits), so the tail is
    held to convergence quality instead of equality."""
    from myraytracer_tpu.parallel import make_mesh

    s, data = plate_scene()
    target_scene = rot_shift(data, deg=12.0, shift=(0.0, 0.0, 0.3))
    o, d = central_rays(s.camera, n=400, margin=0.02, seed=7)
    cfg = tr.TraceConfig(tri_method="cluster")
    target = tr.trace(refit_accel(target_scene), o, d, cfg)

    inv1 = InverseRenderer(data, param_names=("vertex_pos",),
                           optimizer=optax.adam(3e-2), cfg=cfg)
    r1 = inv1.fit(o, d, target, steps=25)

    inv8 = InverseRenderer(data, param_names=("vertex_pos",),
                           optimizer=optax.adam(3e-2), cfg=cfg,
                           mesh=make_mesh(8))
    r8 = inv8.fit(o, d, target, steps=25)

    # step 0 is bit-comparable; by step 2 the chaos has kicked in
    np.testing.assert_allclose(r8.losses[:2], r1.losses[:2], rtol=2e-4,
                               atol=1e-7)
    assert r8.losses[-1] < 0.8 * r8.losses[0], "sharded fit must converge"
    assert r8.losses[-1] < 2.0 * r1.losses[-1], (
        "sharded fit quality must stay comparable to unsharded")
