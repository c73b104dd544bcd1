"""On-card smoke test of the main path: the office scene at 1920x1080.

Runs, in one process on one GPU, the flagship workload through the entry
points a user calls — ``scene_08_office(tess=10, resolution=(1920,
1080))`` — and checks each result by the repo's own means:

  1 device    JAX platform is "gpu"; card, versions, flags, compile
              cache; native BVH builder loaded; scene build time
  2 forward   render(): compile time, median of 3, and 256 sampled
              pixels against the fp64 scalar oracle (tests/oracle.py)
  3 fwd+bwd   render_loss_grad_image(): compile time, median of 3,
              finite gradients, directional finite differences along
              random directions in mat_diffuse and light_color
  4 AA        render_aa() with the bench budget; median of 3; pixels the
              AA pass did not select equal the plain render exactly
  5 CLI       `cli render --backend gpu` of two goldens at reference
              resolution, PNG pixels against the oracle
  6 fit       InverseRenderer.fit_pixels for 5 steps (loss decreases),
              checkpoint save / restore / one step in each
  7 trace     jax.profiler trace of two forwards: top device ops,
              traverse / shade shares, device idle share

Usage:
  python chip_smoke.py                   phases 1-7 (one GPU)
  python chip_smoke.py --tri-method bvh,cluster,brute
                                         phases 1-3 once per strategy
  python chip_smoke.py --four-cards      the sharded path on four GPUs
                                         against one card, and nothing else

Timings wait for the device with ``jax.block_until_ready`` and print on
earlier lines beside the card's name and power limit. Any failed check
raises, so the script exits non-zero and prints no result line. The last
line of a passing run is exactly

  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = (1920, 1080)
TESS = 10
ORACLE_ATOL = 4e-3      # tests/test_golden.py: fp32 render vs fp64 oracle
MIRROR_ATOL = 6e-3      # tests/test_golden.py, the mirror-chain golden
FD_RTOL, FD_ATOL = 0.08, 2e-3   # tests/test_grad.py: fp32 central FD


def card() -> str:
    """`name, power.limit` of the card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Report:
    """Prints one line per measurement with the card beside it."""

    def __init__(self, card_line: str):
        self.card = card_line

    def __call__(self, phase: str, msg: str) -> None:
        print(f"[{phase}] {msg} | {self.card}", flush=True)


def timed(fn, n: int = 3):
    """(first-call seconds incl. compile, median of n warm calls, out)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, statistics.median(times), times, out


def fmt_times(times) -> str:
    return "[" + ", ".join(f"{t:.4f}" for t in times) + "]"


def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def fd_check(loss_at, params, field: str, eps: float, grad, seed: int):
    """Central difference of ``loss_at`` along a random unit direction in
    ``params[field]`` against the analytic directional derivative."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    v = rng.normal(size=np.shape(params[field])).astype(np.float32)
    v /= np.linalg.norm(v)

    def at(t):
        p = dict(params)
        p[field] = params[field] + t * jnp.asarray(v)
        return float(loss_at(p))

    fd = (at(eps) - at(-eps)) / (2 * eps)
    analytic = float(jnp.vdot(grad, v))
    np.testing.assert_allclose(analytic, fd, rtol=FD_RTOL, atol=FD_ATOL,
                               err_msg=f"d loss / d {field}")
    return analytic, fd


# ---------------------------------------------------------------- phases
def phase_device(say):
    import jax

    from myraytracer_tpu.runtime.native import native_available
    from myraytracer_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    print(f"[device] nvidia-smi: {say.card}")
    print(f"[device] jax {jax.__version__}, device_kind {dev.device_kind!r}, "
          f"{len(jax.devices())} device(s), "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}, "
          f"compile cache {cache}", flush=True)
    if not native_available():
        raise AssertionError("the native BVH builder did not load")


def build_office(say, resolution=RES):
    from myraytracer_tpu.scenes.golden import scene_08_office

    sc = scene_08_office(tess=TESS, resolution=resolution)
    t0 = time.perf_counter()
    scene = sc.build()
    say("device", f"set-up: office tess {TESS} {resolution[0]}x"
        f"{resolution[1]} built in {time.perf_counter() - t0:.3f} s "
        f"({scene.n_tris} tris, {scene.n_nodes} BVH nodes, "
        f"{scene.n_lights} live light(s))")
    return sc, scene


def phase_forward(say, sc, scene, cfg, check=True):
    from oracle import check_pixels

    from myraytracer_tpu.ops.render import render

    first, med, times, img = timed(lambda: render(scene, sc.camera, cfg))
    img = np.asarray(img)
    say("forward", f"tri_method {cfg.resolved_method()}: compile+first "
        f"{first:.2f} s, median {med:.4f} s of {fmt_times(times)}, "
        f"{sc.camera.width * sc.camera.height / med / 1e6:.2f} Mray/s")
    if img.shape != (sc.camera.height, sc.camera.width, 3) or not (
            np.isfinite(img).all()):
        raise AssertionError(f"forward image {img.shape} not finite/shaped")
    if check:
        n, skipped, worst = check_pixels(img, scene, sc.camera, 256, 0,
                                         ORACLE_ATOL)
        print(f"[forward] fp64 oracle: {n} pixels within atol "
              f"{ORACLE_ATOL} (fp32 vs fp64; max err {worst:.2e}), "
              f"{skipped} tie/ill-conditioned pixels skipped", flush=True)
    return img


def darker_target(sc, scene, cfg):
    """The render with mat_diffuse scaled by 0.8: a target that differs
    from the render only in shading, never in which surface rays hit."""
    from myraytracer_tpu.ops.render import render

    return render(dataclasses.replace(scene, mat_diffuse=scene.mat_diffuse
                                      * 0.8), sc.camera, cfg)


def phase_fwd_bwd(say, sc, scene, cfg, check=True):
    from myraytracer_tpu.ops.render import render_loss_grad_image
    from myraytracer_tpu.parallel.shard_render import merge_params, split_params

    target = darker_target(sc, scene, cfg)
    first, med, times, (loss, grads) = timed(
        lambda: render_loss_grad_image(scene, sc.camera, target, cfg))
    say("fwd+bwd", f"tri_method {cfg.resolved_method()}: compile+first "
        f"{first:.2f} s, median {med:.4f} s of {fmt_times(times)}, "
        f"{sc.camera.width * sc.camera.height / med / 1e6:.2f} Mray/s, "
        f"loss {float(loss):.4f}")
    bad = [k for k, g in grads.items() if not np.isfinite(np.asarray(g)).all()]
    if bad or not math.isfinite(float(loss)):
        raise AssertionError(f"non-finite loss/gradients: {bad}")
    if not check:
        return target
    params = split_params(scene)

    def loss_at(p):
        return render_loss_grad_image(merge_params(scene, p), sc.camera,
                                      target, cfg)[0]

    for field, seed in (("mat_diffuse", 3), ("light_color", 4)):
        an, fd = fd_check(loss_at, params, field, 1e-2, grads[field], seed)
        print(f"[fwd+bwd] d loss/d {field} along a random direction: "
              f"analytic {an:.6g}, central FD {fd:.6g} (rtol {FD_RTOL}, "
              f"atol {FD_ATOL}: fp32 loss, scatter-add order varies on the "
              f"GPU)", flush=True)
    return target


def phase_aa(say, sc, scene, img1):
    import jax
    import jax.numpy as jnp

    from myraytracer_tpu.ops import render as R

    dev = np.asarray(R._deviation(jnp.asarray(img1)))
    frac = float((dev > R.AA_THRESHOLD).mean())
    # bench.py's budget: measured above-threshold fraction x 1.1
    budget = max(0.01, math.ceil(frac * 1.1 / 0.0025) * 0.0025)
    first, med, times, aa = timed(
        lambda: R.render_aa(scene, sc.camera, budget_frac=budget))
    aa = np.asarray(aa)
    say("aa", f"render_aa budget {budget} (above-threshold {frac:.4f}): "
        f"compile+first {first:.2f} s, median {med:.4f} s of "
        f"{fmt_times(times)}")
    top_idx, sel, _, _ = jax.jit(
        R._aa_rays, static_argnums=(2, 3, 4))(
        sc.camera, jnp.asarray(img1), R.AA_SUBP, R.AA_THRESHOLD, budget)
    picked = np.zeros(img1.shape[0] * img1.shape[1], bool)
    picked[np.asarray(top_idx)[np.asarray(sel)]] = True
    picked = picked.reshape(img1.shape[:2])
    if not np.array_equal(aa[~picked], img1[~picked]):
        n = int((aa[~picked] != img1[~picked]).any(-1).sum())
        raise AssertionError(f"{n} unselected pixels differ from the render")
    covered = int(picked.sum()) == int((dev > R.AA_THRESHOLD).sum())
    print(f"[aa] {int(picked.sum())} pixels refined; unselected pixels "
          f"equal the plain render exactly; budget covers every "
          f"above-threshold pixel: {covered}", flush=True)


def phase_cli(say, tmp):
    from oracle import check_pixels

    from myraytracer_tpu import cli
    from myraytracer_tpu.scenes.golden import GOLDEN_SCENES
    from myraytracer_tpu.utils.image import read_png

    for name, n, atol in (("o_03_mirror", 6, MIRROR_ATOL),
                          ("o_10_pokemon", 20, ORACLE_ATOL)):
        out = os.path.join(tmp, f"{name}.png")
        t0 = time.perf_counter()
        rc = cli.main(["render", "--golden", name, "--backend", "gpu",
                       "--out", out])
        if rc != 0:
            raise AssertionError(f"cli render {name} returned {rc}")
        wall = time.perf_counter() - t0
        sc = GOLDEN_SCENES[name][0](scale=1.0)
        img = read_png(out)
        checked, skipped, worst = check_pixels(img, sc.build(), sc.camera,
                                               n, 1, atol, quantized=True)
        say("cli", f"{name} {img.shape[1]}x{img.shape[0]}: cli wall "
            f"{wall:.2f} s incl. build+compile; {checked} PNG pixels within "
            f"atol {atol} + one 8-bit step of the fp64 oracle (max err "
            f"{worst:.2e}), {skipped} skipped")


def phase_fit(say, sc, scene, target, tmp):
    import jax.numpy as jnp
    import optax

    from myraytracer_tpu.inverse import InverseRenderer

    cam = sc.camera
    xs, ys = cam.pixel_grid()
    xs, ys = xs.ravel(), ys.ravel()
    tgt = jnp.asarray(target).reshape(-1, 3)

    def make():
        return InverseRenderer(scene, param_names=("mat_diffuse",
                                                   "light_color"),
                               optimizer=optax.adam(2e-2), camera=cam)

    inv = make()
    t0 = time.perf_counter()
    res = inv.fit_pixels(xs, ys, tgt, steps=5)
    wall = time.perf_counter() - t0
    losses = res.losses
    say("fit", f"fit_pixels {cam.width}x{cam.height} over mat_diffuse,"
        f"light_color: 5 steps in {wall:.2f} s incl. compile, losses "
        f"{[round(x, 6) for x in losses]}, peak_bytes_in_use {peak_bytes()}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fit loss did not decrease: {losses}")
    ck = os.path.join(tmp, "fit.npz")
    inv.save_checkpoint(ck)
    inv2 = make()
    inv2.restore_checkpoint(ck)
    l1 = inv.fit_pixels(xs, ys, tgt, steps=1).losses[0]
    l2 = inv2.fit_pixels(xs, ys, tgt, steps=1).losses[0]
    np.testing.assert_allclose(l2, l1, rtol=1e-6,
                               err_msg="resumed step loss")
    print(f"[fit] checkpoint resume: next-step loss {l1:.8f} (saved) vs "
          f"{l2:.8f} (restored), step_count {inv2.step_count}", flush=True)


def phase_trace(say, sc, scene, cfg, tmp):
    """Two traced forwards: top ops and idle share of the program as it
    runs, then the traverse / shade split of the same program compiled
    without command buffers. Inside a command buffer (a CUDA graph) every
    kernel reports its HLO op as "command_buffer", so only the unbatched
    compile can attribute kernels to named scopes."""
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_table as tt

    from myraytracer_tpu.ops import tracer as tr
    from myraytracer_tpu.ops.render import render
    from myraytracer_tpu.utils.profiling import profile_trace

    def trace_ops(fn, name):
        jax.block_until_ready(fn())
        log = os.path.join(tmp, name)
        with profile_trace(log):
            for _ in range(2):
                jax.block_until_ready(fn())
        ops = tt.load_ops(log)
        if not ops:
            raise AssertionError("the trace holds no GPU device ops")
        return ops

    ops = trace_ops(lambda: render(scene, sc.camera, cfg), "trace")
    tt.print_table(ops, runs=2, top=10)
    idle = tt.idle_share(ops)
    say("trace", f"forward (tri_method {cfg.resolved_method()}): device op "
        f"time {sum(o.dur_ns for o in ops) / 2e6:.3f} ms per run, idle "
        f"share " + ", ".join(f"{v:.4f}" for v in idle.values()))
    lowered = render.lower(scene, sc.camera, cfg)
    flat = lowered.compile(
        compiler_options={"xla_gpu_enable_command_buffer": ""})
    ops = trace_ops(lambda: flat(scene, sc.camera), "trace_flat")
    shares = tt.scope_shares(ops, tt.hlo_scopes(flat.as_text()),
                             (tr.SCOPE_TRAVERSE, tr.SCOPE_SHADE))
    say("trace", "device op time by scope, compiled without command "
        "buffers: " + ", ".join(f"{k} {v:.1%}" for k, v in shares.items())
        + f" (idle share there "
        + ", ".join(f"{v:.4f}" for v in tt.idle_share(ops).values()) + ")")


def four_cards(say, sizes=(RES, (1919, 1079))):
    """render_sharded and train_step_sharded on make_mesh(4) against one
    card, at 1920x1080 and at the ragged 1919x1079 (a pixel count that
    is no multiple of 4)."""
    import jax

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_table as tt

    from myraytracer_tpu.ops.render import render
    from myraytracer_tpu.ops.tracer import TraceConfig
    from myraytracer_tpu.parallel import (make_mesh, render_sharded,
                                          train_step_sharded)
    from myraytracer_tpu.utils.profiling import profile_trace

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, JAX sees "
                             f"{len(jax.devices())}")
    mesh4, mesh1 = make_mesh(4), make_mesh(1)
    for res in sizes:
        sc, scene = build_office(say, res)
        cam = sc.camera
        t1 = timed(lambda: render(scene, cam))
        t4 = timed(lambda: render_sharded(scene, cam, mesh4))
        err = np.abs(np.asarray(t4[3], np.float64) - np.asarray(t1[3]))
        say("4cards", f"{res[0]}x{res[1]} forward: 1 card median "
            f"{t1[1]:.4f} s of {fmt_times(t1[2])}, 4 cards median "
            f"{t4[1]:.4f} s of {fmt_times(t4[2])}; sharded vs single max "
            f"abs difference {err.max():.3e}, "
            f"{int((err.max(-1) > 1e-5).sum())} pixels over atol 1e-5")
        np.testing.assert_allclose(np.asarray(t4[3]), np.asarray(t1[3]),
                                   atol=1e-5, err_msg="render_sharded")
        xs, ys = cam.pixel_grid()
        o, d = cam.primary_rays(xs.ravel(), ys.ravel())
        target = darker_target(sc, scene, TraceConfig()).reshape(-1, 3)
        s1 = timed(lambda: train_step_sharded(scene, o, d, target, mesh1))
        s4 = timed(lambda: train_step_sharded(scene, o, d, target, mesh4))
        l1, l4 = float(s1[3][1]), float(s4[3][1])
        say("4cards", f"{res[0]}x{res[1]} train step: 1 card median "
            f"{s1[1]:.4f} s of {fmt_times(s1[2])}, 4 cards median "
            f"{s4[1]:.4f} s of {fmt_times(s4[2])}; loss {l4:.8f} vs "
            f"{l1:.8f} (rtol 1e-5)")
        np.testing.assert_allclose(l4, l1, rtol=1e-5,
                                   err_msg="sharded train-step loss")
        for what, fn in (
                ("forward", lambda: render_sharded(scene, cam, mesh4)),
                ("train step", lambda: train_step_sharded(scene, o, d, target,
                                                          mesh4))):
            say("4cards", f"{res[0]}x{res[1]} traced {what}: "
                + per_card_trace(tt, profile_trace, fn))


def per_card_trace(tt, profile_trace, fn) -> str:
    """One traced call of ``fn``: each card's compute time (device ops
    other than collectives), its collective time and its idle share.
    A card's all-reduce kernel also spans its wait for the slowest
    shard, so the shortest collective bounds the collective itself and
    the spread of compute times is the load imbalance."""
    import jax

    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp):
            jax.block_until_ready(fn())
        ops = tt.load_ops(tmp)
    if not ops:
        raise AssertionError("the four-card trace holds no GPU device ops")
    coll = [op for op in ops if any(k in op.name.lower() for k in (
        "all-reduce", "allreduce", "nccl", "all_reduce"))]
    idle = tt.idle_share(ops)
    parts = []
    for dev in sorted(idle):
        mine = [op for op in ops if op.device == dev]
        c = [op for op in coll if op.device == dev]
        compute = tt.busy_ns([op for op in mine if op not in c])
        parts.append(f"{dev} compute {compute / 1e6:.3f} ms, collective "
                     f"{sum(op.dur_ns for op in c) / 1e6:.3f} ms, idle share "
                     f"{idle[dev]:.4f}")
    names = sorted({op.name for op in coll}) or ["none"]
    return "; ".join(parts) + f" (collective kernels: {names})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on make_mesh(4)")
    ap.add_argument("--tri-method", default=None,
                    help="comma-separated triangle strategies: run phases "
                    "1-3 once per strategy (timing), nothing else")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's default device is "
              f"{dev.platform!r} ({dev.device_kind})", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    say = Report(card())
    phase_device(say)
    from myraytracer_tpu.ops.tracer import TraceConfig

    if args.four_cards:
        four_cards(say)
    elif args.tri_method:
        sc, scene = build_office(say)
        for m in args.tri_method.split(","):
            cfg = TraceConfig(tri_method=m)
            phase_forward(say, sc, scene, cfg, check=True)
            phase_fwd_bwd(say, sc, scene, cfg, check=False)
    else:
        cfg = TraceConfig()
        sc, scene = build_office(say)
        img = phase_forward(say, sc, scene, cfg)
        target = phase_fwd_bwd(say, sc, scene, cfg)
        phase_aa(say, sc, scene, img)
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(say, tmp)
            phase_fit(say, sc, scene, target, tmp)
            phase_trace(say, sc, scene, cfg, tmp)
        print(f"[device] peak_bytes_in_use {peak_bytes()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
