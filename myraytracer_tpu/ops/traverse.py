"""Stackless vectorized BVH traversal (XLA path).

The reference traverses with an explicit per-thread ``int stack[64]`` and
near-child-first push ordering (mytracer_gpu.cu:340-424). That shape —
divergent stacks, data-dependent branching — does not vectorize over a
ray batch in XLA. Instead we walk the *threaded* BVH from ops/bvh.py:

  * each ray carries one node pointer; a step either descends into a hit
    subtree (``entry`` link, near child first thanks to the per-octant
    threading) or jumps over a culled subtree (``skip`` link);
  * the whole ray batch advances in lock-step inside one
    ``lax.while_loop``; finished rays idle with pointer -1;
  * subtrees are culled against the current best hit (``tmin <= t_best``)
    — an improvement over the reference AABB test which only checks
    ``tmax > eps`` (mybvh.cpp:134).

Memory-access design (gathers, not FLOPs, bound this walk):
  * ONE [R, 8] row-gather per step fetches a node's bbox + leaf record
    (``bvh_nodes_packed``; ints bitcast into the f32 rows) instead of six
    separate gathers;
  * ONE [R, 2] row-gather fetches both threading links;
  * leaf triangles are packed as [T, 9] rows (leaf-contiguous, the same
    physical reordering as the reference's SoA partition swaps,
    mybvh.cpp:497-503) and fetched with one row-gather per leaf slot,
    then tested densely. (A windowed vmap(dynamic_slice) fetch lowers
    to a sequential per-ray loop; row gathers are the fast path.)
  * several steps are unrolled inside each while-loop iteration to
    amortize the lockstep convergence check.

Traversal is *topology only*: it returns the winning triangle index and a
non-differentiable distance. Shading re-solves the hit differentiably
(ops/shade.py), which is what makes the whole pipeline autodiff-clean
(fixed-hit-topology reparameterization).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from myraytracer_tpu.ops import intersect as isx
from myraytracer_tpu.utils import knobs

#: traversal steps unrolled per while-loop iteration (env-tunable for
#: perf experiments; each unroll amortizes the lockstep convergence check
#: at the cost of compile time and stragglers). Not yet swept on the
#: H100 (ROADMAP 1.4).
STEPS_INNER = knobs.env_int("MRT_STEPS_INNER", 4, lo=1, hi=64)


class TriHit(NamedTuple):
    """Per-ray closest triangle: index (-1 = miss) and distance."""

    idx: jnp.ndarray   # [R] int32
    t: jnp.ndarray     # [R] float32 (INF on miss); NOT differentiable


class _State(NamedTuple):
    ptr: jnp.ndarray
    t: jnp.ndarray
    idx: jnp.ndarray
    steps: jnp.ndarray


def pack_tri_vertices(scene) -> jnp.ndarray:
    """[T, 16] packed triangle corners from the CURRENT vertex positions.

    Computed per render call (one regular [T]-gather) so traversal never
    reads stale geometry after vertex updates. Rows are padded 9 -> 16
    floats: lane-aligned row gathers are ~3x faster than odd widths.
    """
    vp = jax.lax.stop_gradient(scene.vertex_pos)
    tv = scene.tri_vidx
    packed = jnp.concatenate([vp[tv[:, 0]], vp[tv[:, 1]], vp[tv[:, 2]]], axis=1)
    return jnp.pad(packed, ((0, 0), (0, 7)))


def traverse_bvh(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    t_max: Optional[jnp.ndarray] = None,
    any_hit: bool = False,
    active: Optional[jnp.ndarray] = None,
    tri_flat: Optional[jnp.ndarray] = None,
    max_steps: Optional[int] = None,
    return_steps: bool = False,
) -> TriHit:
    """Closest (or any) ray-triangle hit through the threaded BVH.

    Args:
        scene: SceneData (uses bvh_*_packed / tri_vidx / vertex_pos).
        o, d: [R, 3] ray origins / directions.
        t_max: optional [R] upper bound — hits at or beyond it are ignored
            (used by shadow rays with the light distance).
        any_hit: if True, a ray retires as soon as any hit < t_max is
            found (shadow occlusion semantics: isShadow = hit && 0 < t <
            light_distance, mytracer.cpp:599).
        active: optional [R] bool mask; inactive rays never traverse.
        tri_flat: optional precomputed pack_tri_vertices(scene) to share
            across multiple traversals in one program.
    """
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    n_nodes = scene.n_nodes
    R = o.shape[0]
    L = scene.max_leaf

    if scene.n_tris == 0:
        return TriHit(jnp.full((R,), -1, jnp.int32), jnp.full((R,), isx.INF))

    if tri_flat is None:
        tri_flat = pack_tri_vertices(scene)
    tri_rows = tri_flat                          # [T, 16]
    nodes = jax.lax.stop_gradient(scene.bvh_nodes_packed)
    links = scene.bvh_links_packed

    inv_d = 1.0 / d  # IEEE inf on zero components == reference raw division
    octant = (
        (d[:, 0] < 0).astype(jnp.int32)
        + 2 * (d[:, 1] < 0).astype(jnp.int32)
        + 4 * (d[:, 2] < 0).astype(jnp.int32)
    )
    link_base = octant * n_nodes

    t0 = jnp.full((R,), isx.INF) if t_max is None else jnp.asarray(t_max)
    start = jnp.zeros((R,), jnp.int32)
    if active is not None:
        start = jnp.where(active, start, -1)

    n_tris = scene.n_tris

    def one_step(s: _State) -> _State:
        alive = s.ptr >= 0
        p = jnp.maximum(s.ptr, 0)

        row = nodes[p]                                  # [R, 8] single gather
        node_min = row[:, 0:3]
        node_max = row[:, 3:6]
        first = jax.lax.bitcast_convert_type(row[:, 6], jnp.int32)
        count = jax.lax.bitcast_convert_type(row[:, 7], jnp.int32)

        box_hit, tmin = isx.ray_aabb(o, inv_d, node_min, node_max)
        box_hit &= alive & (tmin <= s.t)
        is_leaf = count > 0
        leaf_work = box_hit & is_leaf

        # dense leaf test: one row-gather per slot + [R] dense batches
        base = jnp.where(leaf_work, first, 0)
        t_new, i_new = s.t, s.idx
        for k in range(L):
            ti = jnp.minimum(base + k, n_tris - 1)
            trow = tri_rows[ti]                          # [R, 9] row gather
            t_tri, _, _ = isx.ray_triangle(
                o, d, trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
            )
            ok = leaf_work & (k < count) & (t_tri < t_new)
            t_new = jnp.where(ok, t_tri, t_new)
            i_new = jnp.where(ok, base + k, i_new)

        lnk = links[link_base + p]                      # [R, 2] single gather
        nxt = jnp.where(box_hit & ~is_leaf, lnk[:, 0], lnk[:, 1])
        ptr = jnp.where(alive, nxt, -1)
        if any_hit:
            ptr = jnp.where(i_new >= 0, -1, ptr)
        return _State(ptr, t_new, i_new, s.steps)

    def cond(s: _State):
        keep = jnp.any(s.ptr >= 0)
        if max_steps is not None:
            keep &= s.steps < max_steps  # safety bound for probes only
        return keep

    def body(s: _State) -> _State:
        for _ in range(STEPS_INNER):
            s = one_step(s)
        return s._replace(steps=s.steps + STEPS_INNER)

    init = _State(ptr=start, t=t0, idx=jnp.full((R,), -1, jnp.int32),
                  steps=jnp.zeros((), jnp.int32))
    out = jax.lax.while_loop(cond, body, init)
    t_hit = jnp.where(out.idx >= 0, out.t, isx.INF)
    hit = TriHit(out.idx, jax.lax.stop_gradient(t_hit))
    if return_steps:
        return hit, out.steps
    return hit


def intersect_tris_brute(scene, o, d, t_max=None, chunk: int = 512) -> TriHit:
    """Brute-force closest triangle over ALL tris — the oracle for the BVH
    (and the M2 path for small scenes; SURVEY.md §7 build plan).

    Scans triangle blocks with a fori_loop so memory stays [R, chunk].
    """
    R = o.shape[0]
    T = scene.n_tris
    if T == 0:
        return TriHit(jnp.full((R,), -1, jnp.int32), jnp.full((R,), isx.INF))
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    vertex_pos = jax.lax.stop_gradient(scene.vertex_pos)

    n_chunks = (T + chunk - 1) // chunk
    Tpad = n_chunks * chunk
    vidx = jnp.pad(scene.tri_vidx, ((0, Tpad - T), (0, 0)))

    t0 = jnp.full((R,), isx.INF) if t_max is None else jnp.asarray(t_max)

    def body(c, carry):
        t_best, i_best = carry
        base = c * chunk
        ids = base + jnp.arange(chunk, dtype=jnp.int32)
        vi = jax.lax.dynamic_slice_in_dim(vidx, base, chunk, axis=0)
        p0 = vertex_pos[vi[:, 0]]
        p1 = vertex_pos[vi[:, 1]]
        p2 = vertex_pos[vi[:, 2]]
        # [R, chunk] batched triangle solve
        t_tri, _, _ = isx.ray_triangle(
            o[:, None, :], d[:, None, :], p0[None], p1[None], p2[None]
        )
        t_tri = jnp.where((ids < T)[None, :], t_tri, isx.INF)
        k = jnp.argmin(t_tri, axis=1)
        t_min = jnp.take_along_axis(t_tri, k[:, None], axis=1)[:, 0]
        better = t_min < t_best
        t_best = jnp.where(better, t_min, t_best)
        i_best = jnp.where(better, ids[k], i_best)
        return t_best, i_best

    t_best, i_best = jax.lax.fori_loop(
        0, n_chunks, body, (t0, jnp.full((R,), -1, jnp.int32))
    )
    t_hit = jnp.where(i_best >= 0, t_best, isx.INF)
    return TriHit(i_best, jax.lax.stop_gradient(t_hit))
