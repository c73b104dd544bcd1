"""Render drivers: tiled primary pass + adaptive supersampling.

Replaces the reference's kernel pair (compute_image_device +
adaptive_supersampling_device, mytracer_gpu.cu:119-229) with two
wavefront passes:

  pass 1  one ray per pixel, traced in fixed-size flat tiles via
          ``lax.map`` (bounds live memory the way the 16x16 CUDA grid
          bounds threadblocks);
  pass 2  the reference's adaptivity rule — 4-neighborhood squared-color
          deviation > threshold (mytracer_gpu.cu:195-198) — but made
          static-shape: the K most-deviating pixels are *compacted* with
          top_k, supersampled with a stratified subp x subp grid
          (mytracer_gpu.cu:202-221), and scattered back. K is a static
          budget; pixels below threshold inside the budget keep their
          pass-1 color, so the result equals the reference rule whenever
          the budget covers all above-threshold pixels.

Everything is jit-compiled once per (scene shapes, camera size, config).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from myraytracer_tpu.models.camera import Camera
from myraytracer_tpu.ops import shade
from myraytracer_tpu.utils import knobs
from myraytracer_tpu.ops import tracer as tr

#: reference supersampling constants (mytracer_gpu.cu:83-84)
AA_SUBP = 4
AA_THRESHOLD = 0.02

#: default rays per tile for the primary pass (16 screen blocks); not
#: yet swept on the H100 (ROADMAP 1.4).
TILE = knobs.env_int("MRT_TILE", 1 << 14, lo=1024)


def _fit_tile(R: int, tile: int, quantum: int) -> int:
    """Nudge ``tile`` to a nearby size that divides R exactly.

    The office 1080p batch is 2040 screen blocks; at the swept
    TILE=16384 (16 blocks) the stream needs 127.5 tiles, so the ray
    array is padded to 128 and un-padded after — a whole-image [R,3]
    pad+slice pair. A tile of 15 blocks divides exactly: no pad, no slice, and no half-wasted
    final kernel launch. Searches downward in whole quanta (screen
    blocks) and accepts the first exact divisor within 75% of the
    request; otherwise keeps the requested size (padding stays correct).
    """
    want = max(1, tile // quantum)
    nq = R // quantum
    if nq == 0 or R % quantum:
        return tile
    for k in range(min(want, nq), 0, -1):
        if nq % k == 0:
            return k * quantum if 4 * k >= 3 * want else tile
    return tile


def _trace_tiled(scene, o, d, cfg: tr.TraceConfig, tile: int,
                 quantum: int = 1) -> jnp.ndarray:
    """Trace a flat [R, 3] ray batch in fixed-size tiles."""
    R = o.shape[0]
    if R <= tile:
        return tr.trace(scene, o, d, cfg)
    tile = _fit_tile(R, tile, quantum)
    n_tiles = (R + tile - 1) // tile
    pad = n_tiles * tile - R
    o_t = jnp.pad(o, ((0, pad), (0, 0))).reshape(n_tiles, tile, 3)
    d_pad = jnp.pad(d, ((0, pad), (0, 0)))
    # padded rays get the last real direction so they trace cheaply/validly
    if pad:
        d_pad = d_pad.at[R:].set(d[-1])
    d_t = d_pad.reshape(n_tiles, tile, 3)
    # packed shade rows built ONCE, outside the tile loop (see tr.trace)
    geom = shade.pack_shade_geom(scene)
    colors = jax.lax.map(lambda od: tr.trace(scene, od[0], od[1], cfg, geom),
                         (o_t, d_t))
    return colors.reshape(n_tiles * tile, 3)[:R]


#: 2D pixel-block edge for the primary pass: each trace tile covers a
#: compact BLOCK x BLOCK screen region. Spatially coherent tiles are what
#: let the cluster tracer's tile-level cond-skip cull whole triangle
#: clusters and keep the BVH walk's lockstep short (cf. the reference's
#: 16x16 CUDA thread blocks, mytracer_gpu.cu:59-61). Not yet swept on
#: the H100 (ROADMAP 1.4).
BLOCK = knobs.env_int("MRT_BLOCK", 32, lo=8, power_of_two=True)

#: rays per loss/grad remat tile (whole screen blocks): balances per-tile
#: fixed costs (dense [T,48] cotangent carry adds, scatter launches)
#: against remat working-set growth. Not yet swept on the H100
#: (ROADMAP 1.4).
LOSS_TILE = knobs.env_int("MRT_LOSS_TILE", 23040, lo=1024)


@jax.jit
def block_rays(camera: Camera):
    """Primary rays through the pixel grid padded to whole BLOCK x BLOCK
    screen blocks, in block order (the rays of one block contiguous).

    One jitted function for :func:`render` and the sharded forward, so
    both compute every ray with the same arithmetic: a ray one ulp apart
    can flip its hit where it grazes an edge shared by two triangles.
    """
    bh = bw = BLOCK
    Hp = ((camera.height + bh - 1) // bh) * bh
    Wp = ((camera.width + bw - 1) // bw) * bw
    ys, xs = jnp.meshgrid(
        jnp.arange(Hp, dtype=jnp.float32), jnp.arange(Wp, dtype=jnp.float32),
        indexing="ij",
    )

    def to_blocks(a):
        return a.reshape(Hp // bh, bh, Wp // bw, bw).transpose(0, 2, 1, 3).reshape(-1)

    return camera.primary_rays(to_blocks(xs), to_blocks(ys))


@functools.partial(jax.jit, static_argnames=("cfg", "tile", "clamp"))
def render(
    scene,
    camera: Camera,
    cfg: tr.TraceConfig = tr.TraceConfig(),
    tile: int = TILE,
    clamp: bool = True,
) -> jnp.ndarray:
    """Primary 1-spp render -> [H, W, 3].

    Colors are clamped to <= 1 per pixel like the reference kernel
    (min(color, 1), mytracer_gpu.cu:155) unless ``clamp=False`` (the
    differentiable path prefers the unclamped linear image).
    """
    H, W = camera.height, camera.width
    bh = bw = BLOCK
    Hp = ((H + bh - 1) // bh) * bh
    Wp = ((W + bw - 1) // bw) * bw
    o, d = block_rays(camera)
    # trace tiles are whole numbers of screen blocks, so every tile
    # keeps the blocks' 2D coherence; larger tiles shrink the number of
    # sequential lax.map iterations
    tile_eff = max(bh * bw, (tile // (bh * bw)) * (bh * bw))
    color = _trace_tiled(scene, o, d, cfg, tile_eff, quantum=bh * bw)
    img = (
        color.reshape(Hp // bh, Wp // bw, bh, bw, 3)
        .transpose(0, 2, 1, 3, 4)
        .reshape(Hp, Wp, 3)[:H, :W]
    )
    if clamp:
        img = jnp.minimum(img, 1.0)
    return img


#: two-phase backward (topology pass + checkpointed shading replay) —
#: the backward never re-runs traversal/occlusion scans; set
#: MRT_TWO_PHASE=0 to fall back to full-remat of the whole trace
TWO_PHASE = knobs.env_bool01("MRT_TWO_PHASE", True)


def _loss_grad_tiled(scene, o, d, target, w, cfg, tile):
    """Shared core: remat-tiled SSE loss + scene-param grads.

    A ``lax.scan`` over fixed-size ray tiles. Default (two-phase): each
    tile first runs the gradient-free topology pass (traversal, shadow
    queries — the expensive scans), then a ``jax.checkpoint``-ed
    differentiable shading replay of that fixed topology
    (tracer.trace_shade). The backward rematerializes only the cheap
    shading, with the recorded topology (~ints/bools per ray/segment)
    as saved residuals — the expensive scans run exactly once.
    Fallback (MRT_TWO_PHASE=0): checkpoint the whole trace per tile, so
    the backward re-runs traversal during rematerialization. ``w`` masks
    padded rays.
    """
    from myraytracer_tpu.ops.refit import refit_accel
    from myraytracer_tpu.parallel.shard_render import merge_params, split_params

    # callers optimizing vertex_pos hand in scenes whose build-time BVH /
    # cluster bounds may be stale; one dense refit pass (ops/refit.py,
    # ~log2(T) elementwise mins over [T,3] + two gathers) keeps culling
    # conservative at negligible cost next to a single ray tile
    scene = refit_accel(scene)
    R = o.shape[0]
    tile = min(tile, R)  # don't pad small batches up to a whole tile
    tile = _fit_tile(R, tile, 1024)  # exact-divide when a near tile exists
    n_tiles = max(1, (R + tile - 1) // tile)
    pad = n_tiles * tile - R
    o_t = jnp.pad(o, ((0, pad), (0, 0))).reshape(n_tiles, tile, 3)
    d_pad = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    d_t = d_pad.reshape(n_tiles, tile, 3)
    t_t = jnp.pad(target, ((0, pad), (0, 0))).reshape(n_tiles, tile, 3)
    w_t = jnp.pad(w, (0, pad)).reshape(n_tiles, tile)

    params = split_params(scene)

    if TWO_PHASE:
        # topology pass hoisted OUTSIDE value_and_grad: the expensive
        # traversal/occlusion scans run exactly once, and their stacked
        # results (~ints/bools per ray/segment) feed the loss as plain
        # inputs the AD transform cannot re-run.
        topo_geom = shade.pack_shade_geom(scene)  # loop-invariant pack
        topo_all = jax.lax.map(
            lambda x: tr.trace_topology(scene, x[0], x[1], cfg, topo_geom),
            (o_t, d_t))

        def shade_loss(p, geom, topo, ot, dt, tt, wt):
            c = tr.trace_shade(merge_params(scene, p), ot, dt, topo, cfg,
                               geom=geom)
            return jnp.sum(wt[:, None] * (c - tt) ** 2)

        if knobs.env_bool01("MRT_REPLAY_CKPT", True):
            # prevent_cse=False lets XLA CSE the rematerialized shading
            # INTO saved residuals, recreating the no-checkpoint residual
            # traffic; the barriers stay on by default (the A/B is not
            # yet measured on the H100, ROADMAP 1.5).
            prevent = knobs.env_bool01("MRT_CKPT_PREVENT_CSE", True)
            shade_loss = jax.checkpoint(shade_loss, prevent_cse=prevent)

        def loss_fn(p):
            # packed gather rows built ONCE per pass (shade.ShadeGeom):
            # every tile's backward accumulates into the packed cotangent
            # and the vertex/material scatter VJPs run a single time
            from myraytracer_tpu.ops import shade as _shade

            geom = _shade.pack_shade_geom(merge_params(scene, p))

            def body(acc, xs):
                ot, dt, tt, wt, topo = xs
                return acc + shade_loss(p, geom, topo, ot, dt, tt, wt), None

            total, _ = jax.lax.scan(body, jnp.float32(0.0),
                                    (o_t, d_t, t_t, w_t, topo_all))
            return total
    else:
        def loss_fn(p):
            def body(acc, xs):
                ot, dt, tt, wt = xs
                c = tr.trace(merge_params(scene, p), ot, dt, cfg)
                return acc + jnp.sum(wt[:, None] * (c - tt) ** 2), None

            total, _ = jax.lax.scan(jax.checkpoint(body), jnp.float32(0.0),
                                    (o_t, d_t, t_t, w_t))
            return total

    return jax.value_and_grad(loss_fn)(params)


def restore_mirror_chain(scene):
    """Un-trim live_depth when the scene's CURRENT mirror values need it.

    Scene.build statically trims mirror-free scenes to one Whitted
    segment (live_depth=1, models/scene.py). If a caller then moves
    ``mat_mirror`` above 0 (an optimizer discovering reflection), the
    trimmed program silently drops the reflected radiance AND its
    gradient. This helper makes the restore decision *statically at the
    jit boundary* from the concrete mat_mirror values:

      * any mirror > 0  -> live_depth := max_depth + 1 (full chain);
      * all mirrors == 0 -> unchanged. This loses nothing: with every
        weight provably 0 after segment 0, dead segments contribute
        exactly 0 to both the value and every gradient, so the trimmed
        and full programs are mathematically identical — while the full
        program's checkpointed backward pays for them (dead lax.cond
        branches are not free under remat).

    Inside a trace (mat_mirror a Tracer) values are unknowable: the
    scene is returned unchanged, matching the documented contract that
    traced callers manage live_depth themselves (InverseRenderer does).
    """
    import dataclasses as _dc

    if not (scene.live_depth and scene.live_depth <= scene.max_depth):
        return scene
    mm = scene.mat_mirror
    if isinstance(mm, jax.core.Tracer):
        return scene
    import numpy as _np

    if float(_np.max(_np.asarray(mm))) > 0.0:
        return _dc.replace(scene, live_depth=scene.max_depth + 1)
    return scene


class _MirrorAwareJit:
    """jit wrapper applying :func:`restore_mirror_chain` to the scene
    argument before dispatch — including through ``.lower()`` (AOT)."""

    def __init__(self, fn, static_argnames):
        self._jit = jax.jit(fn, static_argnames=static_argnames)
        functools.update_wrapper(self, fn)

    def __call__(self, scene, *args, **kwargs):
        return self._jit(restore_mirror_chain(scene), *args, **kwargs)

    def lower(self, scene, *args, **kwargs):
        return self._jit.lower(restore_mirror_chain(scene), *args, **kwargs)


def _render_loss_grad(
    scene,
    o: jnp.ndarray,
    d: jnp.ndarray,
    target: jnp.ndarray,
    cfg: tr.TraceConfig = tr.TraceConfig(),
    tile: int = LOSS_TILE,
):
    """SSE loss + scene-param grads for arbitrary ray batches.

    Returns (loss, grads) where grads is the float-leaf dict of
    parallel.shard_render.split_params. For whole-image losses prefer
    :func:`render_loss_grad_image` (block-coherent tiles).
    """
    w = jnp.ones((o.shape[0],), o.dtype)
    return _loss_grad_tiled(scene, o, d, target, w, cfg, tile)


def _render_loss_grad_image(
    scene,
    camera: Camera,
    target_img: jnp.ndarray,
    cfg: tr.TraceConfig = tr.TraceConfig(),
    tile: int = LOSS_TILE,
):
    """Whole-image SSE loss + grads with 2D-block-coherent ray tiles.

    The fwd+bwd benchmark path (BASELINE.md "Rays/sec/chip fwd+bwd"):
    rays and target pixels are reordered into BLOCK x BLOCK screen tiles
    so the cluster tracer's coherence culling works in the rematerialized
    forward passes too.
    """
    H, W = camera.height, camera.width
    bh = bw = BLOCK
    Hp = ((H + bh - 1) // bh) * bh
    Wp = ((W + bw - 1) // bw) * bw
    ys, xs = jnp.meshgrid(
        jnp.arange(Hp, dtype=jnp.float32), jnp.arange(Wp, dtype=jnp.float32),
        indexing="ij",
    )

    def to_blocks(a):
        lead = a.shape[2:]
        return a.reshape((Hp // bh, bh, Wp // bw, bw) + lead).transpose(
            (0, 2, 1, 3) + tuple(range(4, 4 + len(lead)))
        ).reshape((-1,) + lead)

    o, d = camera.primary_rays(to_blocks(xs), to_blocks(ys))
    tgt = jnp.pad(jnp.asarray(target_img), ((0, Hp - H), (0, Wp - W), (0, 0)))
    w = jnp.zeros((Hp, Wp), o.dtype).at[:H, :W].set(1.0)
    # loss tiles are whole numbers of screen blocks; sizes above one
    # block trade remat-scan iterations for live memory (and rely on
    # per-subgroup culling to keep the union tight)
    tile_eff = max(bh * bw, (tile // (bh * bw)) * (bh * bw))
    return _loss_grad_tiled(
        scene, o, d, to_blocks(tgt), to_blocks(w), cfg, tile_eff
    )


render_loss_grad = _MirrorAwareJit(_render_loss_grad, ("cfg", "tile"))
render_loss_grad_image = _MirrorAwareJit(_render_loss_grad_image,
                                         ("cfg", "tile"))


def _deviation(img: jnp.ndarray) -> jnp.ndarray:
    """Sum of squared color distance to the 4-neighborhood.

    Parity with mytracer_gpu.cu:195-196; the 1-pixel border never
    supersamples (the reference kernel returns early there, :183-188).
    """
    c = img
    d = jnp.zeros(img.shape[:2], img.dtype)
    d = d.at[:, :-1].add(jnp.sum((c[:, :-1] - c[:, 1:]) ** 2, axis=-1))
    d = d.at[:, 1:].add(jnp.sum((c[:, 1:] - c[:, :-1]) ** 2, axis=-1))
    d = d.at[:-1, :].add(jnp.sum((c[:-1] - c[1:]) ** 2, axis=-1))
    d = d.at[1:, :].add(jnp.sum((c[1:] - c[:-1]) ** 2, axis=-1))
    border = jnp.zeros_like(d, dtype=bool)
    border = border.at[0, :].set(True).at[-1, :].set(True)
    border = border.at[:, 0].set(True).at[:, -1].set(True)
    return jnp.where(border, 0.0, d)


@functools.partial(
    jax.jit, static_argnames=("cfg", "tile", "subp", "budget_frac")
)
def _aa_refine(
    scene,
    camera: Camera,
    img1: jnp.ndarray,
    cfg: tr.TraceConfig = tr.TraceConfig(),
    tile: int = TILE,
    subp: int = AA_SUBP,
    threshold: float = AA_THRESHOLD,
    budget_frac: float = 0.10,
) -> jnp.ndarray:
    """Adaptive-supersampling second pass over a finished pass-1 image.

    Compiled SEPARATELY from the primary render so the two programs
    share nothing: pass 1 reuses the exact program the forward benchmark
    already compiled, and this refine program only carries the (much
    smaller) supersample trace — round 3's fused render_aa recompiled
    the whole pass-1 pipeline inside the AA jit (24.7 s compile).
    """
    top_idx, sel, o, d = _aa_rays(camera, img1, subp, threshold,
                                  budget_frac)
    colors = _trace_tiled(scene, o, d, cfg, tile)
    return _aa_apply(camera, img1, top_idx, sel, colors, subp)


def _aa_rays(camera, img1, subp, threshold, budget_frac):
    """Deviation selection + supersample ray batch for the AA pass.

    Returns (top_idx [K], sel [K], o [K*subp^2, 3], d [K*subp^2, 3]) in
    2D-block screen order. Shared by the single-chip and sharded AA
    drivers — the selection is a per-image (global) computation, so the
    sharded path runs it replicated and shards only the rays.
    """
    H, W = camera.height, camera.width
    dev = _deviation(img1).ravel()
    K = max(1, int(H * W * budget_frac))
    K = min(K, H * W)
    top_dev, top_idx = jax.lax.top_k(dev, K)
    sel = top_dev > threshold  # [K]

    # top_k orders by deviation — screen-scattered, which defeats the
    # cluster tracer's tile coherence. Re-sort the selected pixels into
    # 2D-block screen order before tracing.
    pxi = top_idx % W
    pyi = top_idx // W
    bkey = ((pyi // BLOCK) * ((W + BLOCK - 1) // BLOCK) + pxi // BLOCK)
    bkey = bkey * (BLOCK * BLOCK) + (pyi % BLOCK) * BLOCK + (pxi % BLOCK)
    ordk = jnp.argsort(bkey)
    top_idx = top_idx[ordk]
    sel = sel[ordk]

    px = (top_idx % W).astype(jnp.float32)
    py = (top_idx // W).astype(jnp.float32)

    # stratified subp x subp offsets at cell centers (mytracer_gpu.cu:202-209)
    steps = (jnp.arange(subp, dtype=jnp.float32) / subp) - 0.5 + 1.0 / (2.0 * subp)
    ox, oy = jnp.meshgrid(steps, steps, indexing="ij")
    offs = jnp.stack([ox.ravel(), oy.ravel()], axis=1)  # [subp^2, 2]

    xs = (px[:, None] + offs[None, :, 0]).ravel()
    ys = (py[:, None] + offs[None, :, 1]).ravel()
    o, d = camera.primary_rays(xs, ys)
    # budget slots whose pixel did NOT exceed the threshold keep their
    # pass-1 color anyway — replace their rays with a guaranteed-miss
    # probe (origin far outside every AABB, axis direction) so the
    # tracer's cluster culling skips them at zero dense-solve cost
    # (typical goldens flag 2-6% of pixels while the static budget must
    # be sized for the worst frame)
    sel_ray = jnp.repeat(sel, subp * subp)
    o = jnp.where(sel_ray[:, None], o, jnp.float32(3e18))
    d = jnp.where(sel_ray[:, None], d,
                  jnp.array([1.0, 0.0, 0.0], o.dtype)[None])
    return top_idx, sel, o, d


def _aa_apply(camera, img1, top_idx, sel, colors, subp):
    """Average the supersample colors and scatter them into img1."""
    H, W = camera.height, camera.width
    K = top_idx.shape[0]
    avg = jnp.minimum(colors.reshape(K, subp * subp, 3).mean(axis=1), 1.0)
    flat = img1.reshape(-1, 3)
    new = jnp.where(sel[:, None], avg, flat[top_idx])
    return flat.at[top_idx].set(new).reshape(H, W, 3)


def render_aa(
    scene,
    camera: Camera,
    cfg: tr.TraceConfig = tr.TraceConfig(),
    tile: int = TILE,
    subp: int = AA_SUBP,
    threshold: float = AA_THRESHOLD,
    budget_frac: float = 0.10,
) -> jnp.ndarray:
    """Render + adaptive supersampling second pass -> [H, W, 3] in [0,1].

    Two separately-jitted passes (primary render + :func:`_aa_refine`);
    results are identical to the old fused form. ``budget_frac`` is the
    static compaction budget as a fraction of the image; above-threshold
    pixels beyond the budget (ordered by deviation) would keep their
    pass-1 color.
    """
    img1 = render(scene, camera, cfg, tile, clamp=True)
    return _aa_refine(scene, camera, img1, cfg, tile, subp, threshold,
                      budget_frac)
