"""Inverse-rendering optimizer + checkpoint/resume + profiling metrics."""

import dataclasses

import jax
import numpy as np
import optax
import pytest

from myraytracer_tpu.inverse import InverseRenderer
from myraytracer_tpu.ops import tracer as tr
from myraytracer_tpu.utils.profiling import Timer, render_metrics, scene_footprint_bytes

from test_grad import grad_scene, central_rays


@pytest.fixture(scope="module")
def setup():
    s = grad_scene()
    data = s.build()
    o, d = central_rays(s.camera, n=120, margin=0.2, seed=9)
    target = tr.trace(data, o, d)
    return s, data, o, d, target


@pytest.mark.slow
def test_recovers_materials(setup):
    s, data, o, d, target = setup
    wrong = dataclasses.replace(
        data,
        mat_diffuse=data.mat_diffuse * 0.4,
        light_color=data.light_color * 2.0,
    )
    inv = InverseRenderer(wrong, param_names=("mat_diffuse", "light_color"),
                          optimizer=optax.adam(5e-2))
    res = inv.fit(o, d, target, steps=150)
    assert res.losses[-1] < res.losses[0] * 0.02
    np.testing.assert_allclose(
        np.asarray(res.scene.light_color), np.asarray(data.light_color), atol=0.15)


@pytest.mark.slow
def test_mirror_recoverable_from_zero(setup):
    """A mirror-free start scene has live_depth=1 (models/scene.py), which
    would statically kill d(image)/d(mirror); InverseRenderer must restore
    the full chain when mat_mirror is optimized."""
    s, data, o, d, _ = setup
    target = tr.trace(data, o, d)  # data has mirror=0.3 on the sphere
    flat = dataclasses.replace(
        data, mat_mirror=np.zeros_like(np.asarray(data.mat_mirror)),
        live_depth=1)
    assert flat.n_segments == 1
    inv = InverseRenderer(flat, param_names=("mat_mirror",),
                          optimizer=optax.adam(3e-2))
    assert inv.base_scene.n_segments == data.max_depth + 1
    res = inv.fit(o, d, target, steps=60)
    assert res.losses[-1] < res.losses[0] * 0.5
    assert float(np.max(np.asarray(res.scene.mat_mirror))) > 0.05


def test_rejects_bad_param_name(setup):
    _, data, *_ = setup
    with pytest.raises(ValueError):
        InverseRenderer(data, param_names=("tri_vidx",))


@pytest.mark.slow
def test_checkpoint_roundtrip(tmp_path, setup):
    s, data, o, d, target = setup
    wrong = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.5)
    inv = InverseRenderer(wrong, param_names=("mat_diffuse",),
                          optimizer=optax.adam(3e-2))
    inv.fit(o, d, target, steps=10)
    ck = str(tmp_path / "ckpt")
    inv.save_checkpoint(ck)

    inv2 = InverseRenderer(wrong, param_names=("mat_diffuse",),
                           optimizer=optax.adam(3e-2))
    inv2.restore_checkpoint(ck)
    assert inv2.step_count == 10
    np.testing.assert_allclose(
        np.asarray(inv2.params["mat_diffuse"]),
        np.asarray(inv.params["mat_diffuse"]))

    # resuming continues to make progress
    r1 = inv.fit(o, d, target, steps=5)
    r2 = inv2.fit(o, d, target, steps=5)
    np.testing.assert_allclose(r1.losses, r2.losses, rtol=1e-4)


def test_npz_checkpoint_resume(tmp_path, setup):
    """Save after 3 steps, restore into a fresh renderer: parameters,
    optimizer state and step count come back, and the next steps match."""
    s, data, o, d, target = setup
    o, d, target = o[:24], d[:24], target[:24]
    wrong = dataclasses.replace(data, light_color=data.light_color * 0.5)

    def make():
        return InverseRenderer(wrong, param_names=("light_color",),
                               optimizer=optax.adam(3e-2))

    inv = make()
    inv.fit(o, d, target, steps=3)
    ck = str(tmp_path / "fit.npz")
    inv.save_checkpoint(ck)
    inv2 = make()
    inv2.restore_checkpoint(ck)
    assert inv2.step_count == 3
    for a, b in zip(jax.tree.leaves((inv.params, inv.opt_state)),
                    jax.tree.leaves((inv2.params, inv2.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r1 = inv.fit(o, d, target, steps=2)
    r2 = inv2.fit(o, d, target, steps=2)
    np.testing.assert_allclose(r2.losses, r1.losses, rtol=1e-6)
    assert inv2.step_count == 5


def test_npz_checkpoint_rejects_other_parameters(tmp_path, setup):
    _, data, o, d, target = setup
    inv = InverseRenderer(data, param_names=("light_color",))
    ck = str(tmp_path / "fit.npz")
    inv.save_checkpoint(ck)
    other = InverseRenderer(data, param_names=("mat_diffuse",))
    with pytest.raises(ValueError, match="does not match"):
        other.restore_checkpoint(ck)


@pytest.mark.slow
def test_sharded_fit_matches_unsharded(setup):
    """InverseRenderer(mesh=...) must reproduce the single-device fit:
    same losses (1e-5) and same recovered parameters."""
    from myraytracer_tpu.parallel import make_mesh

    s, data, o, d, target = setup
    wrong = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.4)

    inv1 = InverseRenderer(wrong, param_names=("mat_diffuse",),
                           optimizer=optax.adam(3e-2))
    r1 = inv1.fit(o, d, target, steps=20)

    inv8 = InverseRenderer(wrong, param_names=("mat_diffuse",),
                           optimizer=optax.adam(3e-2), mesh=make_mesh(8))
    r8 = inv8.fit(o, d, target, steps=20)

    np.testing.assert_allclose(r8.losses, r1.losses, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(r8.params["mat_diffuse"]),
        np.asarray(r1.params["mat_diffuse"]), rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_camera_pose_recovery(setup):
    """Perturbed camera pose optimizes back to reproduce the target —
    the differentiable-camera capstone."""
    s, data, *_ = setup
    cam = s.camera
    xs, ys = cam.pixel_grid()
    xs, ys = xs.ravel(), ys.ravel()
    o, d = cam.primary_rays(xs, ys)
    target = tr.trace(data, o, d)

    wrong_cam = dataclasses.replace(
        cam, eye=cam.eye + np.asarray([0.06, -0.05, 0.04], np.float32))
    inv = InverseRenderer(data, param_names=("cam_eye",),
                          optimizer=optax.adam(1e-2), camera=wrong_cam)
    res = inv.fit_pixels(xs, ys, target, steps=60)
    assert res.losses[-1] < res.losses[0] * 0.05
    np.testing.assert_allclose(
        np.asarray(res.camera.eye), np.asarray(cam.eye), atol=0.02)

    # fit(o, d) is refused in camera mode: rays must be regenerated
    with pytest.raises(ValueError):
        inv.fit(o, d, target, steps=1)


@pytest.mark.slow
def test_camera_fovy_recovery(setup):
    """A 10% zoom (fovy) perturbation optimizes back to the true value —
    the differentiable-intrinsics capstone."""
    s, data, *_ = setup
    cam = s.camera
    xs, ys = cam.pixel_grid()
    xs, ys = xs.ravel(), ys.ravel()
    o, d = cam.primary_rays(xs, ys)
    target = tr.trace(data, o, d)

    wrong_cam = dataclasses.replace(
        cam, fovy=cam.fovy * np.float32(1.10))
    # fovy is a DEGREES-scale parameter (a 10% zoom error is ~4.5 deg):
    # adam needs a degrees-scale lr to traverse it in 80 steps (5e-2
    # covered only ~65% of the loss; 0.2 converges to ratio 5e-5)
    inv = InverseRenderer(data, param_names=("cam_fovy",),
                          optimizer=optax.adam(0.2), camera=wrong_cam)
    res = inv.fit_pixels(xs, ys, target, steps=80)
    assert res.losses[-1] < res.losses[0] * 0.05
    np.testing.assert_allclose(
        float(res.camera.fovy), float(cam.fovy), atol=0.2)


def test_fit_smoke_sharded_and_camera(setup):
    """Fast-lane smoke: a few sharded steps and a few camera-pose steps
    both run, reduce the loss, and stay finite (thorough agreement /
    convergence checks are in the slow tier)."""
    from myraytracer_tpu.parallel import make_mesh

    s, data, o, d, target = setup
    wrong = dataclasses.replace(data, mat_diffuse=data.mat_diffuse * 0.4)
    inv = InverseRenderer(wrong, param_names=("mat_diffuse",),
                          optimizer=optax.adam(5e-2), mesh=make_mesh(8))
    res = inv.fit(o, d, target, steps=5)
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]

    cam = s.camera
    wrong_cam = dataclasses.replace(
        cam, eye=cam.eye + np.asarray([0.08, -0.06, 0.0], np.float32))
    rng = np.random.default_rng(21)
    xs = rng.uniform(cam.width * 0.25, cam.width * 0.75, 128).astype(np.float32)
    ys = rng.uniform(cam.height * 0.25, cam.height * 0.75, 128).astype(np.float32)
    o2, d2 = cam.primary_rays(xs, ys)
    tgt = tr.trace(data, o2, d2)
    inv2 = InverseRenderer(data, param_names=("cam_eye",),
                           optimizer=optax.adam(1e-2), camera=wrong_cam)
    res2 = inv2.fit_pixels(xs, ys, tgt, steps=8)
    assert np.isfinite(res2.losses).all() and min(res2.losses) < res2.losses[0]


def test_camera_params_require_camera(setup):
    _, data, *_ = setup
    with pytest.raises(ValueError):
        InverseRenderer(data, param_names=("cam_eye",))


def test_timer_and_metrics(setup):
    s, data, o, d, _ = setup
    out, secs = Timer.timed(tr.trace, data, o, d)
    assert secs > 0 and np.isfinite(np.asarray(out)).all()
    m = render_metrics(data, s.camera.width, s.camera.height, render_s=secs)
    assert m["rays"] == s.camera.width * s.camera.height
    assert m["rays_per_s"] > 0
    assert m["scene_bytes"] == scene_footprint_bytes(data) > 0
    assert m["bvh_nodes"] == data.n_nodes
