"""Sharded rendering + inverse-rendering training step (shard_map).

Forward: rays sharded over the mesh's ``rays`` axis, scene replicated —
zero cross-card communication (SURVEY.md §5.8). Backward: per-shard
scene-parameter gradients are ``psum``-reduced across the cards; XLA
overlaps the collective with remaining backward work.

The "training step" is inverse rendering: fit differentiable scene
parameters (vertex positions, normals, materials, lights, texels, sphere/
plane geometry) to a target image by gradient descent — the
differentiable-renderer counterpart of a NN train step, and the
BASELINE.json "fwd+bwd" benchmark shape.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from myraytracer_tpu.models.scene import SceneData
from myraytracer_tpu.ops import tracer as tr
from myraytracer_tpu.ops.refit import refit_accel
from myraytracer_tpu.parallel.mesh import RAY_AXIS


#: acceleration-structure float arrays: NOT scene parameters. Traversal
#: is stop-gradient by design, so their gradients are identically zero —
#: excluding them keeps the backward from materializing and all-reducing
#: dead cotangents for ~12k BVH nodes every step.
_ACCEL_PREFIXES = ("bvh_", "cl_")


def _float_field_names(scene: SceneData):
    out = []
    for f in dataclasses.fields(scene):
        if f.metadata.get("static"):
            continue
        if f.name.startswith(_ACCEL_PREFIXES):
            continue
        v = getattr(scene, f.name)
        if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.inexact):
            out.append(f.name)
    return tuple(out)


def split_params(scene: SceneData) -> Dict[str, jnp.ndarray]:
    """Extract the differentiable (float) leaves as a flat dict."""
    return {n: getattr(scene, n) for n in _float_field_names(scene)}


def merge_params(scene: SceneData, params: Dict[str, jnp.ndarray]) -> SceneData:
    """Rebuild a SceneData with updated float leaves."""
    return dataclasses.replace(scene, **params)


def _pad_rays(o, d, n_shards):
    R = o.shape[0]
    Rp = ((R + n_shards - 1) // n_shards) * n_shards
    if Rp != R:
        o = jnp.concatenate([o, jnp.broadcast_to(o[-1:], (Rp - R, 3))])
        d = jnp.concatenate([d, jnp.broadcast_to(d[-1:], (Rp - R, 3))])
    return o, d, R


@functools.lru_cache(maxsize=None)
def _sharded_trace_program(mesh, cfg, tile, quantum):
    """Cached jitted shard_map'ed tile-stream trace (rays sharded).

    Built once per (mesh, cfg, tile) — defining the closure inside the
    caller would hand jax.jit a fresh function object per call and
    re-trace every time.
    """
    from myraytracer_tpu.ops.render import _trace_tiled

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    def _fwd(scene, o, d):
        return _trace_tiled(scene, o, d, cfg, tile, quantum=quantum)

    return _fwd


def render_sharded(scene, camera, mesh, cfg: tr.TraceConfig = tr.TraceConfig()):
    """Forward render with rays sharded across ``mesh`` -> [H, W, 3].

    Rays are laid out in 2D screen blocks (ops/render.BLOCK) before
    sharding, so each chip receives whole coherent tiles and traces them
    with the same tiled driver — swept TILE size, loop-hoisted
    pack_shade_geom — as the single-chip path (ops/render.render): per-
    chip behavior (cluster culling, tiling, memory) is identical,
    communication stays zero.
    """
    from myraytracer_tpu.ops.render import BLOCK, TILE, block_rays

    H, W = camera.height, camera.width
    bh = bw = BLOCK
    Hp = ((H + bh - 1) // bh) * bh
    Wp = ((W + bw - 1) // bw) * bw
    o, d = block_rays(camera)
    # shards are whole numbers of screen blocks so every chip's tile
    # stream sees the same coherent 2D footprints as the single-chip path
    o, d, R = _pad_rays(o, d, mesh.devices.size * bh * bw)
    tile_eff = max(bh * bw, (TILE // (bh * bw)) * (bh * bw))
    _fwd = _sharded_trace_program(mesh, cfg, tile_eff, bh * bw)
    color = _fwd(scene, o, d)[:R]
    img = (
        color.reshape(Hp // bh, Wp // bw, bh, bw, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(Hp, Wp, 3)[:H, :W]
    )
    return jnp.minimum(img, 1.0)


def render_aa_sharded(scene, camera, mesh,
                      cfg: tr.TraceConfig = tr.TraceConfig(),
                      subp: int | None = None,
                      threshold: float | None = None,
                      budget_frac: float = 0.10):
    """render_sharded + the adaptive-supersampling pass -> [H, W, 3].

    The reference GPU path ALWAYS runs its AA kernel after pass 1
    (mytracer_gpu.cu:83-109), so the at-scale driver must too. The
    deviation selection is a per-image (global) computation: it runs
    replicated (ops/render._aa_rays); only the K*subp^2 supersample rays
    are sharded over the mesh. Matches the single-chip render_aa to fp32
    rounding (tests/test_parallel.py).
    """
    from myraytracer_tpu.ops import render as R

    subp = R.AA_SUBP if subp is None else subp
    threshold = R.AA_THRESHOLD if threshold is None else threshold
    img1 = render_sharded(scene, camera, mesh, cfg)

    n_shards = mesh.devices.size
    s2 = subp * subp
    tile_eff = max(s2, (R.TILE // s2) * s2)

    top_idx, sel, o, d = _aa_select_program(subp, threshold, budget_frac)(
        camera, img1)
    o, d, Rr = _pad_rays(o, d, n_shards * s2)
    colors = _sharded_trace_program(mesh, cfg, tile_eff, s2)(
        scene, o, d)[:Rr]
    return _aa_apply_program(subp)(camera, img1, top_idx, sel, colors)


@functools.lru_cache(maxsize=None)
def _aa_select_program(subp, threshold, budget_frac):
    from myraytracer_tpu.ops import render as R

    @jax.jit
    def select(camera, img1):
        return R._aa_rays(camera, img1, subp, threshold, budget_frac)

    return select


@functools.lru_cache(maxsize=None)
def _aa_apply_program(subp):
    from myraytracer_tpu.ops import render as R

    @jax.jit
    def apply_(camera, img1, top_idx, sel, colors):
        return R._aa_apply(camera, img1, top_idx, sel, colors, subp)

    return apply_


def make_train_step(mesh, cfg: tr.TraceConfig = tr.TraceConfig(), lr: float = 1e-3,
                    tile: int | None = None):
    """Build a jitted sharded inverse-rendering SGD step.

    Returns step(scene, o, d, target, w) -> (scene', loss): rays and
    target pixels sharded over ``mesh``; loss is the global mean squared
    error of the unclamped linear image; scene updates are replicated.

    Each shard runs the SAME driver as the single-chip benchmark path
    (ops/render._loss_grad_tiled): swept LOSS_TILE remat tiles, the
    loop-hoisted pack_shade_geom, per-step accel refit, and the two-phase
    topology/shading-replay backward — the expensive traversal/occlusion
    scans run once per step, never in the backward. The one cross-chip
    collective is the psum of loss + scene-param grads.
    """
    from myraytracer_tpu.ops.render import LOSS_TILE, _loss_grad_tiled

    tile = LOSS_TILE if tile is None else tile

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def step(scene, o, d, target, w):
        # per-shard loss + grads through the full single-chip driver
        # (includes the vertex_pos accel refit, ops/refit.py)
        loss, grads = _loss_grad_tiled(scene, o, d, target, w, cfg, tile)
        # the one cross-chip collective: all-reduce scene-param grads
        loss = jax.lax.psum(loss, RAY_AXIS)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, RAY_AXIS), grads)
        n_total = jax.lax.psum(jnp.sum(w), RAY_AXIS) * 3
        params = split_params(scene)
        new_params = jax.tree.map(lambda p, g: p - lr * g / n_total, params, grads)
        return merge_params(scene, new_params), loss / n_total

    def step_checked(scene, o, d, target, w):
        # mat_mirror is in the optimized set: once a step moves mirror
        # above 0, a statically-trimmed chain (live_depth=1) would drop
        # the reflected term from d(loss)/d(mirror). The restore decision
        # runs HERE, at the jit boundary, from the concrete values — free
        # while mirror stays 0, one recompile when it first grows
        # (ops/render.restore_mirror_chain).
        from myraytracer_tpu.ops.render import restore_mirror_chain

        return step(restore_mirror_chain(scene), o, d, target, w)

    # AOT hook, same contract as ops/render._MirrorAwareJit: callers
    # (tools/weak_scaling.py) lower()/compile() for per-device
    # cost_analysis, with the mirror-restore applied to the concrete
    # scene exactly as a live call would
    from myraytracer_tpu.ops.render import restore_mirror_chain as _rmc

    step_checked.lower = lambda scene, *a, **kw: step.lower(
        _rmc(scene), *a, **kw)
    return step_checked


def train_step_sharded(scene, o, d, target, mesh, lr: float = 1e-3,
                       cfg: tr.TraceConfig = tr.TraceConfig()):
    """Convenience wrapper around :func:`make_train_step`; the step
    program is built once per (mesh, lr, cfg) and reused."""
    R0 = o.shape[0]
    o, d, R = _pad_rays(o, d, mesh.devices.size)
    w = jnp.concatenate([jnp.ones((R0,), o.dtype), jnp.zeros((o.shape[0] - R0,), o.dtype)])
    if target.shape[0] != o.shape[0]:
        pad = o.shape[0] - target.shape[0]
        target = jnp.concatenate([target, jnp.zeros((pad, 3), target.dtype)])
    return _train_step_program(mesh, cfg, lr)(scene, o, d, target, w)


#: cached builder: a fresh make_train_step per call would hand jax.jit a
#: new function each time and recompile every step
_train_step_program = functools.lru_cache(maxsize=None)(make_train_step)
