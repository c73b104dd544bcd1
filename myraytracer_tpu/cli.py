"""Command-line interface.

The reference has no CLI (backend choice was compile-time CUDA_ENABLED,
SURVEY.md §5.6); this provides the idiomatic equivalent:

    python -m myraytracer_tpu render --scene office.sce --out img.png
    python -m myraytracer_tpu render --golden o_08_office --scale 0.5
    python -m myraytracer_tpu bench

Backend selection: --backend gpu (fails unless JAX finds a GPU) | cpu
(default: whatever JAX picks).
"""

from __future__ import annotations

import argparse
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="myraytracer_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene file or golden scene")
    src = r.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="path to a .sce scene file")
    src.add_argument("--golden", help="golden scene name (e.g. o_08_office)")
    r.add_argument("--out", default="render.png")
    r.add_argument("--scale", type=float, default=1.0,
                   help="resolution scale for golden scenes")
    r.add_argument("--backend", choices=["cpu", "gpu"], default=None)
    r.add_argument("--aa", action="store_true", help="adaptive supersampling")
    r.add_argument("--no-bvh", action="store_true", help="brute-force triangles")

    b = sub.add_parser("bench", help="run the headline benchmark")
    b.add_argument("--small", action="store_true")

    f = sub.add_parser(
        "fit", help="inverse rendering: fit scene parameters to a target "
                    "image (gradient descent through the renderer)")
    fsrc = f.add_mutually_exclusive_group(required=True)
    fsrc.add_argument("--scene", help="path to a .sce scene file")
    fsrc.add_argument("--golden", help="golden scene name")
    f.add_argument("--target", required=True, help="target PNG to match "
                   "(must be the scene's resolution)")
    f.add_argument("--params", default="mat_diffuse,light_color",
                   help="comma-separated float leaves to optimize (e.g. "
                   "mat_diffuse,light_pos,vertex_pos,cam_eye,cam_fovy)")
    f.add_argument("--steps", type=int, default=200)
    f.add_argument("--lr", type=float, default=5e-2)
    f.add_argument("--scale", type=float, default=1.0)
    f.add_argument("--backend", choices=["cpu", "gpu"], default=None)
    f.add_argument("--out", default="fitted.png",
                   help="render of the fitted scene")
    f.add_argument("--checkpoint", help=".npz checkpoint file to save "
                   "(and resume from, if it exists)")
    return ap


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    backend = getattr(args, "backend", None)
    if backend is not None:
        import jax

        if backend == "cpu":
            jax.config.update("jax_platforms", "cpu")
        elif jax.default_backend() != backend:
            print(f"--backend {backend}: JAX found no {backend} device "
                  f"(default backend: {jax.default_backend()})",
                  file=sys.stderr)
            return 2

    if args.cmd == "bench":
        import os

        if args.small:
            os.environ["BENCH_SMALL"] = "1"
        sys.path.insert(0, ".")
        import bench

        bench.main()
        return 0

    import numpy as np

    from myraytracer_tpu.ops import tracer as tr
    from myraytracer_tpu.utils.compile_cache import enable_compile_cache
    from myraytracer_tpu.ops.render import render, render_aa
    from myraytracer_tpu.utils.image import write_png

    if args.scene:
        from myraytracer_tpu.models.sceneio import read_scene

        sc = read_scene(args.scene)
    else:
        from myraytracer_tpu.scenes.golden import GOLDEN_SCENES

        if args.golden not in GOLDEN_SCENES:
            matches = [k for k in GOLDEN_SCENES if args.golden in k]
            if len(matches) != 1:
                print(f"unknown golden scene {args.golden!r}; "
                      f"choose from {sorted(GOLDEN_SCENES)}", file=sys.stderr)
                return 2
            args.golden = matches[0]
        sc = GOLDEN_SCENES[args.golden][0](scale=args.scale)

    enable_compile_cache()
    if args.cmd == "fit":
        import os

        import optax

        from myraytracer_tpu.inverse import InverseRenderer
        from myraytracer_tpu.utils.image import read_png

        target = read_png(args.target)
        cam = sc.camera
        if target.shape[:2] != (cam.height, cam.width):
            print(f"target is {target.shape[1]}x{target.shape[0]} but the "
                  f"scene renders {cam.width}x{cam.height}", file=sys.stderr)
            return 2
        params = tuple(p for p in args.params.split(",") if p)
        inv = InverseRenderer(sc.build(), param_names=params,
                              optimizer=optax.adam(args.lr), camera=cam)
        if args.checkpoint and os.path.isfile(args.checkpoint):
            inv.restore_checkpoint(args.checkpoint)
            print(f"resumed from {args.checkpoint} at step {inv.step_count}")
        xs, ys = cam.pixel_grid()
        t0 = time.time()
        res = inv.fit_pixels(xs.ravel(), ys.ravel(),
                             target.reshape(-1, 3), steps=args.steps,
                             log_every=max(1, args.steps // 10))
        dt = time.time() - t0
        if args.checkpoint:
            inv.save_checkpoint(args.checkpoint)
        img = np.asarray(render(res.scene, res.camera or cam))
        write_png(args.out, img)
        print(f"fit {','.join(params)} for {args.steps} steps in {dt:.1f}s: "
              f"loss {float(res.losses[0]):.6f} -> "
              f"{float(res.losses[-1]):.6f} -> {args.out}")
        return 0

    t0 = time.time()
    data = sc.build()
    t1 = time.time()
    cfg = tr.TraceConfig(tri_method="brute" if args.no_bvh else "auto")
    fn = render_aa if args.aa else render
    img = np.asarray(fn(data, sc.camera, cfg=cfg))
    t2 = time.time()
    write_png(args.out, img)
    n_rays = sc.camera.width * sc.camera.height
    print(f"{sc.camera.width}x{sc.camera.height} | {data.n_tris} tris, "
          f"{data.n_spheres} spheres, {data.n_planes} planes | "
          f"build {t1-t0:.2f}s render {t2-t1:.2f}s "
          f"({n_rays/(t2-t1)/1e6:.2f} Mray/s) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
