"""Batched ray-primitive intersection ops (pure JAX, branch-free).

Re-implements the math of the reference intersectors as masked vector
ops over whole ray batches — no per-ray control flow, every test is one
elementwise pass:

  * ray-sphere: solves the quadratic (missing framework ``Sphere``,
    required by the spheres/molecule/rings scenes — SURVEY.md §1.1)
  * ray-plane: myplane.cpp:22-49
  * ray-triangle: Cramer's-rule solve of mymesh.cpp:176-236 /
    mytracer_gpu.cu:442-546 via 3x3 determinants (myutils.cpp:33-51)
  * ray-AABB: slab method of mybvh.cpp:99-135 / mytracer_gpu.cu:548-596

Misses are encoded as ``t = INF`` instead of booleans-by-reference, which
turns closest-hit into a plain ``argmin``. Degenerate divisions are
guarded with ``where`` so no NaNs enter the autodiff graph.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from myraytracer_tpu.utils import vecmath as vm

#: shadow-acne epsilon used by every primitive (reference: 1e-5,
#: mymesh.cpp:203, myplane.cpp:41, mybvh.cpp:134)
EPS_HIT = 1e-5

#: parallel-ray guard for planes (myplane.cpp:30)
EPS_PARALLEL = 1e-9

#: degenerate-triangle determinant guard (mymesh.cpp:197)
EPS_DET = 1e-10

#: "no hit" distance (numpy scalar: module import must NOT touch the JAX
#: backend, or it pins the default platform before callers can choose)
INF = np.float32(3.0e38)


def ray_sphere(o, d, center, radius):
    """Closest ray-sphere hit distance; INF on miss.

    Shapes: o, d = [..., 3]; center = [..., 3]; radius = [...] broadcastable.
    Directions need not be normalized.
    """
    oc = o - center
    a = vm.dot(d, d)
    b = 2.0 * vm.dot(oc, d)
    c = vm.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = jnp.where(t0 > EPS_HIT, t0, t1)
    valid = (disc >= 0.0) & (t > EPS_HIT)
    return jnp.where(valid, t, INF)


def ray_plane(o, d, center, normal):
    """Ray-plane hit distance; INF on miss (math of myplane.cpp:22-49)."""
    cos_theta = vm.dot(normal, d)
    parallel = jnp.abs(cos_theta) < EPS_PARALLEL
    denom = jnp.where(parallel, 1.0, cos_theta)
    t = (vm.dot(normal, center) - vm.dot(normal, o)) / denom
    valid = (~parallel) & (t > EPS_HIT)
    return jnp.where(valid, t, INF)


def ray_triangle(o, d, p0, p1, p2):
    """Ray-triangle via Cramer's rule: returns (t, alpha, beta).

    Solves  o + t*d = alpha*p0 + beta*p1 + gamma*p2, gamma = 1-alpha-beta
    exactly as mymesh.cpp:187-206 (columns [p0-p2, p1-p2, -d | o-p2]).
    Miss -> t = INF. alpha/beta are returned for normal/UV interpolation
    and are differentiable w.r.t. vertex positions and the ray.
    """
    c1 = p0 - p2
    c2 = p1 - p2
    c3 = -d
    c4 = o - p2
    s = vm.det3(c1, c2, c3)
    inv_s = jnp.where(jnp.abs(s) > EPS_DET, 1.0 / jnp.where(jnp.abs(s) > EPS_DET, s, 1.0), 0.0)
    t = vm.det3(c1, c2, c4) * inv_s
    alpha = vm.det3(c4, c2, c3) * inv_s
    beta = vm.det3(c1, c4, c3) * inv_s
    gamma = 1.0 - alpha - beta
    inside = (
        (alpha >= 0.0) & (alpha <= 1.0)
        & (beta >= 0.0) & (beta <= 1.0)
        & (gamma >= 0.0) & (gamma <= 1.0)
    )
    valid = (jnp.abs(s) > EPS_DET) & (t > EPS_HIT) & inside
    return jnp.where(valid, t, INF), alpha, beta


def ray_cylinder(o, d, center, axis, radius, height):
    """Closest hit with a finite open (uncapped) cylinder; INF on miss.

    The course framework's Cylinder primitive is absent from the
    reference repo (SURVEY.md §1.1 lists it among the missing scaffold);
    this is the standard axis-projected quadratic: with a = d - (d.u)u
    and b = oc - (oc.u)u, solve |a t + b|^2 = r^2 and keep roots whose
    hit point lies within +-height/2 along the axis.
    """
    oc = o - center
    d_par = dot_last(d, axis)
    oc_par = dot_last(oc, axis)
    a_v = d - d_par[..., None] * axis
    b_v = oc - oc_par[..., None] * axis
    a = dot_last(a_v, a_v)
    b = 2.0 * dot_last(a_v, b_v)
    c = dot_last(b_v, b_v) - radius * radius
    degenerate = a < 1e-12  # ray parallel to the axis
    a_safe = jnp.where(degenerate, 1.0, a)
    disc = b * b - 4.0 * a_safe * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 0.5 / a_safe
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a

    def height_ok(t):
        y = oc_par + t * d_par
        return jnp.abs(y) <= height * 0.5

    ok0 = (t0 > EPS_HIT) & height_ok(t0)
    ok1 = (t1 > EPS_HIT) & height_ok(t1)
    t = jnp.where(ok0, t0, jnp.where(ok1, t1, INF))
    valid = (~degenerate) & (disc >= 0.0) & (ok0 | ok1)
    return jnp.where(valid, t, INF)


def dot_last(a, b):
    return jnp.sum(a * b, axis=-1)


def ray_aabb(o, inv_d, bbmin, bbmax):
    """Slab test: returns (hit, tmin).

    Branch-free form of mybvh.cpp:99-135: per-axis slab distances with
    min/max swap, hit iff slabs overlap and ``tmax > EPS_HIT``. ``tmin``
    feeds near-child ordering / best-t subtree culling. ``inv_d`` is the
    precomputed reciprocal direction (IEEE inf for zero components gives
    the correct +-inf slab behavior, same as the reference's raw division).
    """
    t0 = (bbmin - o) * inv_d
    t1 = (bbmax - o) * inv_d
    tsmall = jnp.minimum(t0, t1)
    tbig = jnp.maximum(t0, t1)
    tmin = jnp.max(tsmall, axis=-1)
    tmax = jnp.min(tbig, axis=-1)
    return (tmax >= tmin) & (tmax > EPS_HIT), tmin
