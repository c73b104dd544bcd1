"""Batched 3-vector math on ``[..., 3]`` float arrays.

Batched counterpart of the reference's scalar vec3/vec4 helper layer
(reference: myutils.{h,cpp}, myutils_gpu.h, mybvh.h:181-190).  Everything
here is shape-polymorphic over leading batch dimensions so a whole tile of
rays is one array op; nothing ever loops per ray.

All functions are jit/grad/vmap-safe pure JAX.
"""

from __future__ import annotations

import jax.numpy as jnp

#: epsilon used to guard normalization of near-zero vectors.
EPS_NORMALIZE = 1e-20


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise dot product of ``[..., 3]`` arrays -> ``[...]``."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Row-wise cross product of ``[..., 3]`` arrays."""
    return jnp.cross(a, b)


def norm_sq(a: jnp.ndarray) -> jnp.ndarray:
    """Squared Euclidean norm along the last axis."""
    return jnp.sum(a * a, axis=-1)


def norm(a: jnp.ndarray) -> jnp.ndarray:
    """Euclidean norm along the last axis."""
    return jnp.sqrt(norm_sq(a))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    """Safe row-wise normalization (zero vectors stay zero-ish)."""
    n2 = norm_sq(a)
    inv = jnp.where(n2 > EPS_NORMALIZE, jnp.reciprocal(jnp.sqrt(jnp.maximum(n2, EPS_NORMALIZE))), 0.0)
    return a * inv[..., None]


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflect incident direction ``d`` about normal ``n``.

    Matches the framework ``reflect(ray.direction_, normal)`` used for the
    mirror bounce (reference: mytracer.cpp:549, mytracer_gpu.cu:280):
    ``d - 2 (d.n) n``.
    """
    return d - 2.0 * dot(d, n)[..., None] * n


def mirror(l: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror a *light* vector about normal ``n``: ``2 (l.n) n - l``.

    This is the framework ``mirror()`` used in the specular term
    (reference: mytracer.cpp:527): reflected light direction pointing away
    from the surface.
    """
    return 2.0 * dot(l, n)[..., None] * n - l


def det2(a, b, c, d):
    """2x2 determinant (reference: myutils.cpp:21)."""
    return a * d - b * c


def det3(c1: jnp.ndarray, c2: jnp.ndarray, c3: jnp.ndarray) -> jnp.ndarray:
    """3x3 determinant from three column vectors ``[..., 3]``.

    Cofactor expansion along the first row, same formulation the reference
    uses for the Cramer's-rule triangle solve (myutils.cpp:33-51).
    """
    return (
        c1[..., 0] * det2(c2[..., 1], c3[..., 1], c2[..., 2], c3[..., 2])
        - c2[..., 0] * det2(c1[..., 1], c3[..., 1], c1[..., 2], c3[..., 2])
        + c3[..., 0] * det2(c1[..., 1], c2[..., 1], c1[..., 2], c2[..., 2])
    )


def vmin(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Component-wise min (reference: mybvh.h:181-184)."""
    return jnp.minimum(a, b)


def vmax(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Component-wise max (reference: mybvh.h:186-190)."""
    return jnp.maximum(a, b)
