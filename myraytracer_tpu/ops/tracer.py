"""Wavefront Whitted integrator.

The reference's deep per-ray call tree
(trace -> intersect_scene -> intersectBVH -> intersect_triangle ->
lighting, README.md:17) becomes a *wavefront*: every stage runs once over
the whole flat ray batch —

  intersect_scene : spheres / planes / cylinders tested against all rays
                    in one dense pass each; triangles through the
                    strategy default_tri_method() picks for the
                    platform (threaded-BVH walk, cluster scan or brute
                    force); closest hit = argmin over the kinds
  lighting        : Phong with shadow rays for ALL lights batched into
                    one [L*R] any-hit query
  trace           : primary hit + mirror chain folded into ONE
                    ``lax.scan`` over max_depth+1 wavefront bounces with
                    a live-weight mask — the GPU twin's iterative form
                    (mytracer_gpu.cu:237-312) plus the CPU's mirror>0
                    early-exit (mytracer.cpp:547) as a mask. The scan
                    (rather than a Python unroll) means the bounce body —
                    including both traversal call sites — is compiled
                    exactly once.

Blending follows the visible GPU integrator:
``color = (1-m) * local + m * reflected``, miss adds ``weight *
background`` (mytracer_gpu.cu:265, 292-296); the primary segment is the
scan's first iteration with weight 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from myraytracer_tpu.ops import intersect as isx
from myraytracer_tpu.ops import shade
from myraytracer_tpu.ops import traverse
from myraytracer_tpu.utils import knobs
from myraytracer_tpu.utils import vecmath as vm


#: triangle strategy that ``tri_method="auto"`` resolves to, per JAX
#: platform. The GPU entry is the fastest office 1080p forward+backward
#: of the three XLA strategies on one H100 (PERF.md, "tri_method on the
#: H100"); the CPU keeps the BVH walk the tests were written against.
AUTO_TRI_METHOD = {"cpu": "bvh", "gpu": "cluster"}


def default_tri_method(platform: Optional[str] = None) -> str:
    """The triangle strategy ``tri_method="auto"`` runs on ``platform``
    (default: JAX's default backend). Unknown platforms raise: no path
    has been measured there."""
    if platform is None:
        platform = jax.default_backend()
    try:
        return AUTO_TRI_METHOD[platform]
    except KeyError:
        raise ValueError(
            f"no triangle strategy chosen for platform {platform!r} "
            f"(known: {sorted(AUTO_TRI_METHOD)}); pass tri_method "
            f"explicitly") from None


class TraceConfig(NamedTuple):
    """Static knobs for the integrator."""

    #: triangle intersection strategy:
    #:   "auto"    -> default_tri_method() for the running platform
    #:   "bvh"     -> threaded-BVH lockstep walk (ops/traverse.py)
    #:   "cluster" -> cluster scan (ops/cluster.py)
    #:   "brute"   -> all-triangle scan (oracle / tiny scenes)
    tri_method: str = "auto"
    texture_filter: str = "nearest"  # "nearest" (parity) | "bilinear" (diff)
    #: cluster tri test as one [R,10]@[10,4M] matrix product per cluster
    #: instead of the elementwise solve. The contraction depth is only
    #: 10, so a matrix unit runs nearly empty; kept as an option, not yet
    #: measured on the H100 (ROADMAP 3.2).
    cluster_mxu: bool = False
    #: one triangle occlusion query per light (tighter per-light culling)
    #: vs a single [L*R] batched query; batched keeps the program smaller.
    shadow_per_light: bool = False

    def resolved_method(self) -> str:
        if self.tri_method == "auto":
            return default_tri_method()
        return self.tri_method


def _tri_caches(scene, cfg: TraceConfig):
    """Per-trace shared packed triangle data for the chosen method."""
    if not scene.n_tris:
        return None, None
    tri_flat = traverse.pack_tri_vertices(scene)
    cl_tris = None
    if cfg.resolved_method() == "cluster":
        from myraytracer_tpu.ops import cluster as _cl

        if cfg.cluster_mxu:
            cl_tris = _cl.pack_cluster_matrices(scene, tri_flat)
        else:
            cl_tris = _cl.pack_cluster_tris(scene, tri_flat)
    return tri_flat, cl_tris


#: jax.named_scope names of the integrator's layers; a profiler trace
#: attributes device time to them (tools/trace_table.scope_shares)
SCOPE_TRAVERSE = "traverse"   # triangle traversal, closest and any-hit
SCOPE_SHADE = "shade"         # hit re-solve and Phong lighting


def _closest_tris(scene, o, d, active, cfg, tri_flat, cl_tris,
                  t_max=None, any_hit=False):
    method = cfg.resolved_method()
    with jax.named_scope(SCOPE_TRAVERSE):
        if method == "bvh":
            return traverse.traverse_bvh(scene, o, d, t_max=t_max,
                                         any_hit=any_hit, active=active,
                                         tri_flat=tri_flat)
        if method == "cluster":
            from myraytracer_tpu.ops import cluster as cl

            return cl.intersect_clusters(scene, o, d, t_max=t_max,
                                         any_hit=any_hit, active=active,
                                         cl_tris=cl_tris)
        return traverse.intersect_tris_brute(scene, o, d, t_max=t_max)


def _closest_analytic(
    scene, o: jnp.ndarray, d: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest analytic (sphere/plane/cylinder) hit for a ray batch.

    Returns (kind [R] int32, idx [R] per-kind index, t [R]); kind =
    KIND_MISS / t = INF where no analytic primitive is hit. Evaluation
    order (sphere, plane, cylinder, strict <) matches the sequential
    merge the reference's ``intersect_scene`` performs over its object
    list, so exact ties resolve the same way.
    """
    R = o.shape[0]
    o_ng = jax.lax.stop_gradient(o)
    d_ng = jax.lax.stop_gradient(d)
    best_t = jnp.full((R,), isx.INF)
    kind = jnp.zeros((R,), jnp.int32)
    idx = jnp.zeros((R,), jnp.int32)

    if scene.n_spheres:
        t_all = isx.ray_sphere(
            o_ng[:, None, :], d_ng[:, None, :],
            jax.lax.stop_gradient(scene.sphere_center)[None],
            jax.lax.stop_gradient(scene.sphere_radius)[None],
        )  # [R, S]
        i_s = jnp.argmin(t_all, axis=1)
        t_s = jnp.take_along_axis(t_all, i_s[:, None], axis=1)[:, 0]
        better = t_s < best_t
        best_t = jnp.where(better, t_s, best_t)
        kind = jnp.where(better, shade.KIND_SPHERE, kind)
        idx = jnp.where(better, i_s.astype(jnp.int32), idx)

    if scene.n_planes:
        t_all = isx.ray_plane(
            o_ng[:, None, :], d_ng[:, None, :],
            jax.lax.stop_gradient(scene.plane_center)[None],
            jax.lax.stop_gradient(scene.plane_normal)[None],
        )
        i_p = jnp.argmin(t_all, axis=1)
        t_p = jnp.take_along_axis(t_all, i_p[:, None], axis=1)[:, 0]
        better = t_p < best_t
        best_t = jnp.where(better, t_p, best_t)
        kind = jnp.where(better, shade.KIND_PLANE, kind)
        idx = jnp.where(better, i_p.astype(jnp.int32), idx)

    if scene.n_cylinders:
        t_all = isx.ray_cylinder(
            o_ng[:, None, :], d_ng[:, None, :],
            jax.lax.stop_gradient(scene.cyl_center)[None],
            jax.lax.stop_gradient(scene.cyl_axis)[None],
            jax.lax.stop_gradient(scene.cyl_radius)[None],
            jax.lax.stop_gradient(scene.cyl_height)[None],
        )
        i_c = jnp.argmin(t_all, axis=1)
        t_c = jnp.take_along_axis(t_all, i_c[:, None], axis=1)[:, 0]
        better = t_c < best_t
        best_t = jnp.where(better, t_c, best_t)
        kind = jnp.where(better, shade.KIND_CYL, kind)
        idx = jnp.where(better, i_c.astype(jnp.int32), idx)
    return kind, idx, best_t


def intersect_scene(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    active: Optional[jnp.ndarray] = None,
    cfg: TraceConfig = TraceConfig(),
    tri_flat: Optional[jnp.ndarray] = None,
    cl_tris: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Closest hit over all primitive kinds.

    Returns integer (kind, idx) per ray — topology only; resolve with
    shade.resolve_hit for the differentiable interaction.
    """
    R = o.shape[0]
    o_ng = jax.lax.stop_gradient(o)
    d_ng = jax.lax.stop_gradient(d)

    kind, idx, best_t = _closest_analytic(scene, o_ng, d_ng)

    if scene.n_tris:
        tri = _closest_tris(scene, o_ng, d_ng, active, cfg, tri_flat, cl_tris)
        better = tri.t < best_t
        kind = jnp.where(better, shade.KIND_TRI, kind)
        idx = jnp.where(better, tri.idx, idx)

    if active is not None:
        kind = jnp.where(active, kind, shade.KIND_MISS)
    return kind, idx


def _analytic_occlusion(scene, of, df, distf) -> jnp.ndarray:
    """Any analytic primitive occludes the segment o -> o + dist*d?

    Flat [N] batch; each primitive kind is one dense [N, P] test
    (isShadow iff any t < dist, reference semantics mytracer.cpp:
    587-599). Returns [N] bool (all-False when the scene has no
    analytic primitives).
    """
    shadowed = jnp.zeros(of.shape[0], bool)
    if scene.n_spheres:
        t_all = isx.ray_sphere(
            of[:, None, :], df[:, None, :],
            jax.lax.stop_gradient(scene.sphere_center)[None],
            jax.lax.stop_gradient(scene.sphere_radius)[None],
        )
        shadowed |= jnp.any(t_all < distf[:, None], axis=1)
    if scene.n_planes:
        t_all = isx.ray_plane(
            of[:, None, :], df[:, None, :],
            jax.lax.stop_gradient(scene.plane_center)[None],
            jax.lax.stop_gradient(scene.plane_normal)[None],
        )
        shadowed |= jnp.any(t_all < distf[:, None], axis=1)
    if scene.n_cylinders:
        t_all = isx.ray_cylinder(
            of[:, None, :], df[:, None, :],
            jax.lax.stop_gradient(scene.cyl_center)[None],
            jax.lax.stop_gradient(scene.cyl_axis)[None],
            jax.lax.stop_gradient(scene.cyl_radius)[None],
            jax.lax.stop_gradient(scene.cyl_height)[None],
        )
        shadowed |= jnp.any(t_all < distf[:, None], axis=1)
    return shadowed


def occluded_batched(
    scene,
    point: jnp.ndarray,      # [R, 3]
    active: jnp.ndarray,     # [R] (rays that cast shadows)
    cfg: TraceConfig,
    tri_flat=None,
    cl_tris=None,
    facing: Optional[jnp.ndarray] = None,  # [L, R] light-facing mask
) -> jnp.ndarray:
    """Shadow predicates for ALL lights at once -> [L, R] bool.

    Semantics per light match the reference (isShadow = hit && 0 < t <
    light_distance, mytracer.cpp:587-599, origin offset 1e-4), but the
    L x R shadow rays run as ONE batched any-hit query.

    ``facing`` culls (light, ray) pairs whose Phong contribution is zero
    regardless of occlusion — n.l <= 0 zeroes both diffuse and the
    diffuse-gated specular (mytracer.cpp:510-534) — so their shadow rays
    never trace. Culled pairs report False (unshadowed); callers multiply
    by diff = 0 so the image is unchanged.
    """
    L = scene.n_lights
    R = point.shape[0]
    point = jax.lax.stop_gradient(point)
    lp = jax.lax.stop_gradient(scene.light_pos)          # [L, 3]

    l_vec = lp[:, None, :] - point[None, :, :]           # [L, R, 3]
    dist = vm.norm(l_vec)
    l_dir = vm.normalize(l_vec)
    o = point[None] + shade.EPS_OFFSET * l_dir
    if facing is not None:
        active = active[None] & jax.lax.stop_gradient(facing)  # [L, R]

    act2 = active if active.ndim == 2 else jnp.broadcast_to(
        active[None], (L, R))

    per_light = cfg.shadow_per_light and scene.n_tris > 0
    if per_light:
        # one compacted cluster query per light: each light's shadow
        # bundle is coherent on its own; the cross-light union is not
        shadowed_tri = []
        for li in range(L):
            tri = _closest_tris(
                scene, o[li], l_dir[li], act2[li], cfg, tri_flat, cl_tris,
                t_max=dist[li], any_hit=True,
            )
            shadowed_tri.append(tri.idx >= 0)

    # flat order of the L x R any-hit batch: "light"-major keeps each
    # light's cone of shadow rays contiguous; "ray"-major interleaves the
    # L lights of each pixel, so lights whose occluder sets overlap walk
    # the same nodes side by side (A/B knob, not yet measured on the
    # H100)
    ray_major = knobs.env_choice("MRT_SHADOW_ORDER", "light",
                             ("light", "ray")) == "ray"

    def flat(a):
        if ray_major:
            a = jnp.swapaxes(a, 0, 1)           # [R, L, ...]
        return a.reshape(L * R, *a.shape[2:])

    def unflat(a):
        if ray_major:
            return a.reshape(R, L).swapaxes(0, 1)
        return a.reshape(L, R)

    of = flat(o)
    df = flat(l_dir)
    distf = flat(dist)
    actf = flat(act2)

    shadowed = jnp.zeros((L * R,), bool)
    if per_light:
        shadowed |= flat(jnp.stack(shadowed_tri))
    shadowed |= _analytic_occlusion(scene, of, df, distf)
    if scene.n_tris and not per_light:
        still = actf & ~shadowed
        tri = _closest_tris(scene, of, df, still, cfg, tri_flat, cl_tris,
                            t_max=distf, any_hit=True)
        shadowed |= tri.idx >= 0
    return unflat(shadowed & actf)


def lighting(
    scene,
    hit: shade.Hit,
    view: jnp.ndarray,
    active: jnp.ndarray,
    cfg: TraceConfig = TraceConfig(),
    tri_flat=None,
    cl_tris=None,
) -> jnp.ndarray:
    """Phong local illumination with shadows (mytracer.cpp:568-608).

    ``view`` is the normalized direction from the point to the viewer.
    All lights are evaluated in one batched [L, R] computation.
    """
    color = scene.ambience[None, :] * hit.ambient
    L = scene.n_lights
    if L == 0:
        return color

    point, normal = hit.point, hit.normal
    lp = scene.light_pos                                  # [L, 3]
    l_dir = vm.normalize(lp[:, None, :] - point[None])    # [L, R, 3]
    diff = jnp.maximum(0.0, vm.dot(normal[None], l_dir))  # [L, R]

    r = vm.normalize(vm.mirror(l_dir, normal[None]))
    cos_rv = jnp.maximum(0.0, vm.dot(r, view[None]))
    gate = (diff > 0.0) & (cos_rv > 0.0)
    base = jnp.where(gate, cos_rv, 1.0)
    spec = jnp.where(gate, jnp.power(base, hit.shininess[None]), 0.0)

    cast = active & (hit.shadowable > 0.5)
    is_shadow = occluded_batched(scene, point, cast, cfg, tri_flat, cl_tris,
                                 facing=diff > 0.0)
    lit = (~is_shadow).astype(color.dtype)                # [L, R]

    contrib = scene.light_color[:, None, :] * lit[:, :, None] * (
        hit.diffuse[None] * diff[:, :, None]
        + hit.specular[None] * spec[:, :, None]
    )                                                     # [L, R, 3]
    return color + jnp.sum(contrib, axis=0)


def lighting_from_mask(
    scene,
    hit: shade.Hit,
    view: jnp.ndarray,
    is_shadow: jnp.ndarray,   # [L, R] bool (precomputed occlusion)
) -> jnp.ndarray:
    """Phong local illumination with a FIXED shadow mask.

    Identical math to :func:`lighting` but takes the occlusion result as
    an input instead of tracing shadow rays — the differentiable half of
    the fixed-hit-topology split (occlusion is stop-gradient by design,
    so reusing the recorded mask changes no gradients).
    """
    color = scene.ambience[None, :] * hit.ambient
    L = scene.n_lights
    if L == 0:
        return color

    point, normal = hit.point, hit.normal
    lp = scene.light_pos                                  # [L, 3]
    l_dir = vm.normalize(lp[:, None, :] - point[None])    # [L, R, 3]
    diff = jnp.maximum(0.0, vm.dot(normal[None], l_dir))  # [L, R]

    r = vm.normalize(vm.mirror(l_dir, normal[None]))
    cos_rv = jnp.maximum(0.0, vm.dot(r, view[None]))
    gate = (diff > 0.0) & (cos_rv > 0.0)
    base = jnp.where(gate, cos_rv, 1.0)
    spec = jnp.where(gate, jnp.power(base, hit.shininess[None]), 0.0)

    lit = (~is_shadow).astype(color.dtype)                # [L, R]
    contrib = scene.light_color[:, None, :] * lit[:, :, None] * (
        hit.diffuse[None] * diff[:, :, None]
        + hit.specular[None] * spec[:, :, None]
    )                                                     # [L, R, 3]
    return color + jnp.sum(contrib, axis=0)


class TraceTopo(NamedTuple):
    """Per-segment discrete trace topology (all non-differentiable).

    Shapes: [S, R] for kind/idx/hit/miss, [S, L, R] for shadow, where
    S = max_depth + 1 Whitted segments.
    """

    kind: jnp.ndarray
    idx: jnp.ndarray
    hit: jnp.ndarray
    miss: jnp.ndarray
    shadow: jnp.ndarray


class _Bounce(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    weight: jnp.ndarray
    color: jnp.ndarray


def trace(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    cfg: TraceConfig = TraceConfig(),
    geom: Optional[shade.ShadeGeom] = None,
) -> jnp.ndarray:
    """Whitted trace of a ray batch -> [R, 3] linear color (unclamped).

    One lax.scan over (max_depth + 1) wavefront segments: segment 0 is
    the primary hit (weight 1), segments 1..max_depth follow the mirror
    chain with ``weight *= m``; a miss adds ``weight * background`` and
    kills the ray (mytracer_gpu.cu:237-312).

    Pass ``geom`` (shade.pack_shade_geom) when tracing many tiles of the
    same scene: built inside a lax.map body, the pack's join gather is
    NOT loop-hoisted by XLA and re-runs per tile (measured 17 ms/frame
    on the office trace); built once outside, it's a loop-invariant
    input.
    """
    R = o.shape[0]
    tri_flat, cl_tris = _tri_caches(scene, cfg)
    if geom is None:
        geom = shade.pack_shade_geom(scene)

    def segment(carry: _Bounce) -> _Bounce:
        live = carry.weight > 0.0
        kind, idx = intersect_scene(scene, carry.o, carry.d, active=live,
                                    cfg=cfg, tri_flat=tri_flat,
                                    cl_tris=cl_tris)
        with jax.named_scope(SCOPE_SHADE):
            hit = shade.resolve_hit(scene, carry.o, carry.d, kind, idx,
                                    cfg.texture_filter, geom=geom)
            h = live & hit.valid
            miss = live & ~hit.valid
            local = lighting(scene, hit, -carry.d, h, cfg, tri_flat,
                             cl_tris)
        add = jnp.where(
            h[:, None],
            carry.weight[:, None] * (1.0 - hit.mirror[:, None]) * local,
            0.0,
        ) + jnp.where(
            miss[:, None],
            carry.weight[:, None] * scene.background[None, :],
            0.0,
        )

        refl = vm.reflect(carry.d, hit.normal)
        o2 = hit.point + shade.EPS_OFFSET * refl
        w2 = jnp.where(h, carry.weight * hit.mirror, 0.0)
        return _Bounce(
            o=jnp.where(h[:, None], o2, carry.o),
            d=jnp.where(h[:, None], refl, carry.d),
            weight=w2,
            color=carry.color + add,
        )

    def body(carry: _Bounce, _):
        # skip whole dead segments (once every weight hits 0, remaining
        # mirror-chain iterations are no-ops — the CPU reference's
        # mirror>0 early-exit, mytracer.cpp:547, at wavefront level)
        nxt = jax.lax.cond(
            jnp.any(carry.weight > 0.0), segment, lambda c: c, carry
        )
        return nxt, None

    init = _Bounce(
        o=o, d=d,
        weight=jnp.ones((R,), o.dtype),
        color=jnp.zeros((R, 3), o.dtype),
    )
    out, _ = jax.lax.scan(body, init, None, length=scene.n_segments)
    return out.color


def trace_topology(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    cfg: TraceConfig = TraceConfig(),
    geom: Optional[shade.ShadeGeom] = None,
) -> TraceTopo:
    """Gradient-free topology pass: the same Whitted scan as
    :func:`trace`, recording per segment WHICH primitive each ray hit,
    whether it was live/miss, and the shadow mask per light — everything
    discrete. :func:`trace_shade` replays the differentiable shading from
    this record without any traversal or occlusion queries, which is what
    lets the backward pass skip the expensive scans entirely.
    """
    R = o.shape[0]
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    scene = jax.tree.map(jax.lax.stop_gradient, scene)
    tri_flat, cl_tris = _tri_caches(scene, cfg)
    if geom is None:
        geom = shade.pack_shade_geom(scene)
    else:
        geom = jax.tree.map(jax.lax.stop_gradient, geom)
    L = max(scene.n_lights, 1)

    def segment(carry):
        live = carry.weight > 0.0
        kind, idx = intersect_scene(scene, carry.o, carry.d, active=live,
                                    cfg=cfg, tri_flat=tri_flat,
                                    cl_tris=cl_tris)
        with jax.named_scope(SCOPE_SHADE):
            hit = shade.resolve_hit(scene, carry.o, carry.d, kind, idx,
                                    cfg.texture_filter, need_colors=False,
                                    geom=geom)
        h = live & hit.valid
        miss = live & ~hit.valid

        cast = h & (hit.shadowable > 0.5)
        if scene.n_lights:
            l_dir = vm.normalize(
                scene.light_pos[:, None, :] - hit.point[None])
            facing = vm.dot(hit.normal[None], l_dir) > 0.0
            is_shadow = occluded_batched(scene, hit.point, cast, cfg,
                                         tri_flat, cl_tris, facing=facing)
        else:
            is_shadow = jnp.zeros((L, R), bool)

        refl = vm.reflect(carry.d, hit.normal)
        o2 = hit.point + shade.EPS_OFFSET * refl
        w2 = jnp.where(h, carry.weight * hit.mirror, 0.0)
        nxt = _Bounce(
            o=jnp.where(h[:, None], o2, carry.o),
            d=jnp.where(h[:, None], refl, carry.d),
            weight=w2,
            color=carry.color,
        )
        return nxt, (kind, idx, h, miss, is_shadow)

    def body(carry, _):
        def dead(c):
            return c, (
                jnp.full((R,), shade.KIND_MISS, jnp.int32),
                jnp.zeros((R,), jnp.int32),
                jnp.zeros((R,), bool),
                jnp.zeros((R,), bool),
                jnp.zeros((L, R), bool),
            )

        return jax.lax.cond(jnp.any(carry.weight > 0.0), segment, dead,
                            carry)

    init = _Bounce(o=o, d=d, weight=jnp.ones((R,), o.dtype),
                   color=jnp.zeros((R, 0), o.dtype))
    _, (kind, idx, h, miss, shadow) = jax.lax.scan(
        body, init, None, length=scene.n_segments)
    return TraceTopo(kind=kind, idx=idx, hit=h, miss=miss, shadow=shadow)


def trace_shade(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    topo: TraceTopo,
    cfg: TraceConfig = TraceConfig(),
    geom: shade.ShadeGeom | None = None,
) -> jnp.ndarray:
    """Differentiable shading replay of a recorded topology -> [R, 3].

    Re-resolves each segment's FIXED hit (differentiable t/normal/UV via
    shade.resolve_hit), shades with the recorded shadow mask, and chains
    mirror reflections — no traversal, no occlusion query, so its
    backward is cheap. trace_shade(scene, o, d, trace_topology(...))
    equals trace(scene, o, d) exactly (tests/test_two_phase.py).

    ``geom`` (the packed-row gather cache) can be shared across tiles of
    one render pass so its pack/unpack VJP scatters run once per pass.
    """
    if geom is None:
        geom = shade.pack_shade_geom(scene)

    def segment(args):
        carry, x = args
        kind, idx, h, miss, is_shadow = x
        with jax.named_scope(SCOPE_SHADE):
            hit = shade.resolve_hit(scene, carry.o, carry.d, kind, idx,
                                    cfg.texture_filter, geom=geom)
            local = lighting_from_mask(scene, hit, -carry.d, is_shadow)
        add = jnp.where(
            h[:, None],
            carry.weight[:, None] * (1.0 - hit.mirror[:, None]) * local,
            0.0,
        ) + jnp.where(
            miss[:, None],
            carry.weight[:, None] * scene.background[None, :],
            0.0,
        )

        refl = vm.reflect(carry.d, hit.normal)
        o2 = hit.point + shade.EPS_OFFSET * refl
        w2 = jnp.where(h, carry.weight * hit.mirror, 0.0)
        return _Bounce(
            o=jnp.where(h[:, None], o2, carry.o),
            d=jnp.where(h[:, None], refl, carry.d),
            weight=w2,
            color=carry.color + add,
        )

    def body(carry: _Bounce, x):
        # dead-segment skip from the recorded topology: segments where no
        # ray is live or missing (e.g. mirror chains in mirror-free
        # scenes) cost nothing in forward OR backward
        kind, idx, h, miss, is_shadow = x
        nxt = jax.lax.cond(jnp.any(h | miss), segment, lambda a: a[0],
                           (carry, x))
        return nxt, None

    R = o.shape[0]
    init = _Bounce(o=o, d=d, weight=jnp.ones((R,), o.dtype),
                   color=jnp.zeros((R, 3), o.dtype))
    out, _ = jax.lax.scan(body, init, topo)
    return out.color
