"""Inverse-rendering demo: recover scene parameters from a target image.

Builds a small scene, renders a target with the "true" parameters, then
perturbs the sphere's diffuse color and the light position and optimizes
them back with the differentiable renderer
(fixed-hit-topology gradients; the capability the C++/CUDA reference has
no counterpart for).

Run on the default device (the GPU where JAX finds one):
                       python examples/inverse_demo.py
Force the CPU (~1 min): python examples/inverse_demo.py --cpu
Outputs: /tmp/inverse_target.png, /tmp/inverse_init.png,
/tmp/inverse_fit.png and a printed loss curve.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_scene(res: int):
    from myraytracer_tpu import Material, Scene

    s = Scene()
    s.set_camera(eye=(0, 1.2, 5.2), center=(0, 0.2, 0), up=(0, 1, 0),
                 fovy=42, width=res, height=res)
    s.add_light((2.5, 4.5, 4.0), (0.8, 0.8, 0.78))
    s.ambience = (0.25, 0.25, 0.25)
    s.background = (0.02, 0.02, 0.05)
    s.add_sphere((-0.2, 0.1, 0.3), 0.85, Material(
        diffuse=(0.7, 0.12, 0.08), specular=(0.4, 0.4, 0.4),
        shininess=40, mirror=0.15))
    s.add_plane((0, -0.75, 0), (0, 1, 0), Material(
        diffuse=(0.45, 0.45, 0.5), specular=(0.1, 0.1, 0.1), shininess=5))
    return s


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the default device")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from myraytracer_tpu.inverse import InverseRenderer
    from myraytracer_tpu.ops import tracer as tr
    from myraytracer_tpu.ops.render import render
    from myraytracer_tpu.utils.image import write_png

    sc = build_scene(args.res)
    true_scene = sc.build()
    target_img = np.asarray(render(true_scene, sc.camera, clamp=False))
    write_png("/tmp/inverse_target.png", np.clip(target_img, 0, 1))

    # perturb: wrong material colors and a displaced light — the classic
    # inverse-rendering setting where fixed-hit-topology gradients are
    # exact. (Recovering large geometric displacements needs silhouette
    # gradients this estimator deliberately doesn't model — the
    # documented caveat of tests/test_grad.py.)
    start = dataclasses.replace(
        true_scene,
        mat_diffuse=true_scene.mat_diffuse.at[0].set(
            jnp.asarray([0.1, 0.5, 0.6])),
        light_pos=true_scene.light_pos + jnp.asarray([[-1.0, 0.5, 0.0]]),
    )
    init_img = np.asarray(render(start, sc.camera))
    write_png("/tmp/inverse_init.png", init_img)

    xs, ys = sc.camera.pixel_grid()
    o, d = sc.camera.primary_rays(xs.ravel(), ys.ravel())
    target = jnp.asarray(target_img.reshape(-1, 3))

    inv = InverseRenderer(
        start, param_names=("mat_diffuse", "light_pos"),
        cfg=tr.TraceConfig())
    res = inv.fit(o, d, target, steps=args.steps, log_every=20)

    fit_img = np.asarray(render(res.scene, sc.camera))
    write_png("/tmp/inverse_fit.png", fit_img)

    true_c = np.asarray(true_scene.mat_diffuse[0])
    fit_c = np.asarray(res.params["mat_diffuse"][0])
    true_p = np.asarray(true_scene.light_pos[0])
    fit_p = np.asarray(res.params["light_pos"][0])
    print(f"loss: {res.losses[0]:.5f} -> {res.losses[-1]:.6f}")
    print(f"sphere diffuse: true {true_c.round(3)} fit {fit_c.round(3)}")
    print(f"light position: true {true_p.round(3)} fit {fit_p.round(3)}")
    err = float(np.abs(np.clip(fit_img, 0, 1) - np.clip(target_img, 0, 1)).mean())
    print(f"mean image error after fit: {err:.4f}")
    if res.losses[-1] > res.losses[0] * 0.05:
        print("WARNING: fit did not converge to <5% of the initial loss",
              file=sys.stderr)

    # ---- stage 2: camera pose recovery -------------------------------
    # Perturb the camera eye and recover it from the SAME target — the
    # most common inverse-rendering task, enabled by the differentiable
    # camera (models/camera.py): eye/center/up/fovy are optimizable
    # leaves, primary rays carry their gradients.
    import optax

    wrong_cam = dataclasses.replace(
        sc.camera, eye=sc.camera.eye + np.asarray([0.25, -0.2, 0.1],
                                                  np.float32))
    inv_cam = InverseRenderer(
        true_scene, param_names=("cam_eye",),
        optimizer=optax.adam(2e-2), camera=wrong_cam,
        cfg=tr.TraceConfig())
    res_cam = inv_cam.fit_pixels(xs.ravel(), ys.ravel(), target,
                                 steps=max(60, args.steps // 2),
                                 log_every=20)
    true_eye = np.asarray(sc.camera.eye)
    fit_eye = np.asarray(res_cam.params["cam_eye"])
    print(f"pose loss: {res_cam.losses[0]:.5f} -> {res_cam.losses[-1]:.6f}")
    print(f"camera eye: true {true_eye.round(3)} "
          f"start {np.asarray(wrong_cam.eye).round(3)} fit {fit_eye.round(3)}")
    if float(np.abs(fit_eye - true_eye).max()) > 0.05:
        print("WARNING: camera pose did not recover to within 0.05",
              file=sys.stderr)

    # ---- stage 3: zoom (fovy) recovery -------------------------------
    # A 10% fovy perturbation optimizes back through the same pixel
    # loss: fovy is a traced Camera leaf (round 4), so intrinsics are
    # recoverable alongside pose.
    wrong_fovy_cam = dataclasses.replace(
        sc.camera, fovy=sc.camera.fovy * np.float32(1.10))
    inv_fovy = InverseRenderer(
        true_scene, param_names=("cam_fovy",),
        optimizer=optax.adam(1e-1), camera=wrong_fovy_cam,
        cfg=tr.TraceConfig())
    res_fovy = inv_fovy.fit_pixels(xs.ravel(), ys.ravel(), target,
                                   steps=max(120, args.steps),
                                   log_every=40)
    true_fovy = float(sc.camera.fovy)
    fit_fovy = float(res_fovy.params["cam_fovy"])
    print(f"zoom loss: {res_fovy.losses[0]:.5f} -> {res_fovy.losses[-1]:.6f}")
    print(f"fovy: true {true_fovy:.2f} start {float(wrong_fovy_cam.fovy):.2f}"
          f" fit {fit_fovy:.2f}")
    if abs(fit_fovy - true_fovy) > 0.3:
        print("WARNING: fovy did not recover to within 0.3 deg",
              file=sys.stderr)


if __name__ == "__main__":
    main()
