"""Inverse rendering: fit scene parameters to target images.

The differentiable-path capstone (BASELINE.json north star): pixel
gradients flow back to vertex positions, normals, materials, lights,
texels — and the camera pose — so scene parameters can be optimized
against a reference image.

  InverseRenderer   optax-based optimization loop over a chosen subset of
                    the scene's float leaves (plus optional camera pose
                    leaves ``cam_eye``/``cam_center``/``cam_up``), with
                    optional multi-chip sharding over a ``jax.sharding``
                    mesh (rays sharded, scene replicated, one grad psum
                    per step — parallel/shard_render's recipe) and .npz
                    checkpoint/resume — the checkpoint/resume subsystem
                    the reference lacks (SURVEY.md §5.4).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from myraytracer_tpu.ops import tracer as tr
from myraytracer_tpu.ops.refit import refit_accel
from myraytracer_tpu.parallel.shard_render import merge_params, split_params

#: camera leaves exposed as optimizable parameters when a camera is
#: attached: full pose (eye/center/up) plus the intrinsic zoom (fovy,
#: a traced leaf of models/camera.Camera since round 4).
CAMERA_PARAMS = ("cam_eye", "cam_center", "cam_up", "cam_fovy")

_CAM_FIELD = {"cam_eye": "eye", "cam_center": "center", "cam_up": "up",
              "cam_fovy": "fovy"}


def camera_with(camera, params: Dict[str, jnp.ndarray]):
    """Camera with any ``cam_*`` leaves of ``params`` substituted."""
    kw = {f: params[n] for n, f in _CAM_FIELD.items() if n in params}
    return dataclasses.replace(camera, **kw) if kw else camera


def _scene_leaves(params: Dict[str, jnp.ndarray]) -> Dict[str, jnp.ndarray]:
    return {k: v for k, v in params.items() if k not in _CAM_FIELD}


@dataclasses.dataclass
class FitResult:
    scene: object
    losses: list
    params: Dict[str, jnp.ndarray]
    camera: object = None


class InverseRenderer:
    """Optimize selected scene parameters against target pixel colors.

    Args:
        scene: built SceneData (topology fixed during optimization).
        param_names: which float leaves to optimize (default: all scene
            float leaves, plus the camera pose leaves when ``camera`` is
            given).
        optimizer: any optax GradientTransformation (default adam(1e-2)).
        cfg: TraceConfig; bilinear texturing recommended when optimizing
            texels or UV-affecting geometry.
        mesh: optional ``jax.sharding.Mesh`` with a ``rays`` axis
            (parallel.make_mesh). When given, each step shard_maps the
            ray batch over the mesh, psums the scene-parameter gradients
            (the one cross-chip collective) and applies the optax update
            replicated — numerically the single-device fit up to fp32
            reduction order (tests/test_inverse.py pins 1e-5 agreement).
        camera: optional models.camera.Camera. Attaching one exposes
            ``cam_eye``/``cam_center``/``cam_up`` as optimizable leaves;
            use :meth:`fit_pixels` so rays are regenerated from the
            current pose every step.
    """

    def __init__(
        self,
        scene,
        param_names: Optional[Sequence[str]] = None,
        optimizer: Optional[optax.GradientTransformation] = None,
        cfg: tr.TraceConfig = tr.TraceConfig(texture_filter="bilinear"),
        mesh=None,
        camera=None,
    ) -> None:
        self.base_scene = scene
        self.camera = camera
        self.mesh = mesh
        all_params = split_params(scene)
        if camera is not None:
            for n in CAMERA_PARAMS:
                all_params[n] = jnp.asarray(getattr(camera, _CAM_FIELD[n]))
        if param_names is None:
            param_names = tuple(all_params)
        if "mat_mirror" in param_names and scene.n_segments < scene.max_depth + 1:
            # live_depth statically trims provably-dead mirror segments
            # (models/scene.py), but under optimization mirror can GROW
            # from 0 — the trimmed program would give a one-sided
            # d(image)/d(mirror) that can never discover reflection.
            # Restore the full mirror chain for the fit.
            scene = dataclasses.replace(scene, live_depth=scene.max_depth + 1)
            self.base_scene = scene
        unknown = set(param_names) - set(all_params)
        if unknown:
            raise ValueError(f"not differentiable leaves: {sorted(unknown)}")
        self.param_names = tuple(param_names)
        self._use_camera = any(n in _CAM_FIELD for n in self.param_names)
        if self._use_camera and camera is None:
            raise ValueError("camera params selected but no camera attached")
        self.params = {n: all_params[n] for n in self.param_names}
        self.optimizer = optimizer or optax.adam(1e-2)
        self.opt_state = self.optimizer.init(self.params)
        self.cfg = cfg
        self.step_count = 0
        self._step_fns = {}

    def scene_with(self, params) -> object:
        return merge_params(self.base_scene, _scene_leaves(dict(params)))

    def fitted_camera(self):
        """Camera at the current parameter values (pose-recovery output)."""
        if self.camera is None:
            return None
        return camera_with(self.camera, self.params)

    def _build_step(self, pixel_mode: bool = False):
        cfg = self.cfg
        optimizer = self.optimizer
        base = self.base_scene
        camera = self.camera
        use_cam = self._use_camera or pixel_mode
        # geometry optimization moves vertices past the build-time BVH /
        # cluster bounds — refit them from the CURRENT vertex_pos every
        # step so culling stays conservative (ops/refit.py)
        need_refit = "vertex_pos" in self.param_names

        def scene_at(p):
            s = merge_params(base, _scene_leaves(p))
            return refit_accel(s) if need_refit else s

        def rays_of(p, a, b):
            # pixel mode regenerates rays from the CURRENT pose so
            # gradients flow into cam_* leaves; ray mode passes (o, d)
            if use_cam:
                return camera_with(camera, p).primary_rays(a, b)
            return a, b

        if self.mesh is None:
            @jax.jit
            def step(params, opt_state, a, b, target):
                def loss_fn(p):
                    o, d = rays_of(p, a, b)
                    c = tr.trace(scene_at(p), o, d, cfg)
                    return jnp.mean((c - target) ** 2)

                loss, grads = jax.value_and_grad(loss_fn)(params)
                updates, opt_state = optimizer.update(grads, opt_state,
                                                      params)
                params = optax.apply_updates(params, updates)
                return params, opt_state, loss

            return step

        from jax.sharding import PartitionSpec as P

        from myraytracer_tpu.parallel.mesh import RAY_AXIS

        @jax.jit
        @functools.partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                      P(RAY_AXIS)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        def step_sharded(params, opt_state, a, b, target, w):
            def loss_fn(p):
                o, d = rays_of(p, a, b)
                c = tr.trace(scene_at(p), o, d, cfg)
                # w masks rays padded up to the shard count
                return jnp.sum(w[:, None] * (c - target) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            # the one cross-chip collective: all-reduce param grads + loss
            loss = jax.lax.psum(loss, RAY_AXIS)
            grads = jax.tree.map(lambda g: jax.lax.psum(g, RAY_AXIS), grads)
            n = jax.lax.psum(jnp.sum(w), RAY_AXIS) * 3.0
            loss = loss / n
            grads = jax.tree.map(lambda g: g / n, grads)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return step_sharded

    def _run(self, a, b, target, steps, log_every,
             pixel_mode: bool = False) -> FitResult:
        # the step program is built per input mode: pixel mode
        # regenerates rays from the (possibly optimized) camera each
        # step, ray mode consumes (o, d) directly. Cached so repeated
        # fits reuse the compiled step.
        if pixel_mode not in self._step_fns:
            self._step_fns[pixel_mode] = self._build_step(pixel_mode)
        self._step_fn = self._step_fns[pixel_mode]
        losses = []
        if self.mesh is not None:
            n_shards = self.mesh.devices.size
            R = a.shape[0]
            Rp = ((R + n_shards - 1) // n_shards) * n_shards
            w = jnp.zeros((Rp,), jnp.float32).at[:R].set(1.0)

            def pad(x):
                if x.shape[0] == Rp:
                    return x
                reps = jnp.broadcast_to(x[-1:], (Rp - R,) + x.shape[1:])
                return jnp.concatenate([x, reps])

            args = (pad(a), pad(b), pad(target), w)
        else:
            args = (a, b, target)
        for i in range(steps):
            self.params, self.opt_state, loss = self._step_fn(
                self.params, self.opt_state, *args
            )
            self.step_count += 1
            losses.append(float(loss))
            if log_every and i % log_every == 0:
                print(f"step {self.step_count}: loss={losses[-1]:.6f}")
        return FitResult(self.scene_with(self.params), losses, self.params,
                         camera=self.fitted_camera())

    def fit(self, o, d, target, steps: int = 100,
            log_every: int = 0) -> FitResult:
        """Run the optimizer for `steps` iterations against target colors
        [R, 3] for fixed rays (o, d)."""
        if self._use_camera:
            raise ValueError(
                "camera params are being optimized: rays must be "
                "regenerated from the current pose each step — use "
                "fit_pixels(xs, ys, target) instead of fit(o, d, target)")
        return self._run(o, d, target, steps, log_every)

    def fit_pixels(self, xs, ys, target, steps: int = 100,
                   log_every: int = 0) -> FitResult:
        """Like :meth:`fit` but parameterized by pixel coordinates; rays
        are regenerated from the current camera pose every step so
        gradients flow into ``cam_*`` leaves."""
        if self.camera is None:
            raise ValueError("fit_pixels requires a camera")
        return self._run(jnp.asarray(xs, jnp.float32),
                         jnp.asarray(ys, jnp.float32), target, steps,
                         log_every, pixel_mode=True)

    # --- checkpoint / resume (.npz) ---------------------------------------
    def _state(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "step_count": np.asarray(self.step_count, np.int64)}

    def save_checkpoint(self, path: str) -> None:
        """Write params, optimizer state and step count to one ``.npz``
        file, one array per pytree leaf keyed by its tree path. The file
        is written beside ``path`` and renamed over it, so a crash never
        leaves a torn checkpoint."""
        leaves = jax.tree_util.tree_flatten_with_path(self._state())[0]
        arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def restore_checkpoint(self, path: str) -> None:
        """Load a :meth:`save_checkpoint` file into this renderer. Its
        leaves must match this renderer's parameters and optimizer state
        by tree path, shape and dtype."""
        leaves, treedef = jax.tree_util.tree_flatten_with_path(self._state())
        with np.load(path, allow_pickle=False) as z:
            want = {jax.tree_util.keystr(k) for k, _ in leaves}
            if set(z.files) != want:
                raise ValueError(
                    f"checkpoint {path} does not match this renderer: "
                    f"missing {sorted(want - set(z.files))}, "
                    f"unexpected {sorted(set(z.files) - want)}")
            vals = []
            for k, ref in leaves:
                v = z[jax.tree_util.keystr(k)]
                if v.shape != np.shape(ref) or v.dtype != np.asarray(ref).dtype:
                    raise ValueError(
                        f"checkpoint leaf {jax.tree_util.keystr(k)}: "
                        f"{v.dtype}{list(v.shape)} != "
                        f"{np.asarray(ref).dtype}{list(np.shape(ref))}")
                vals.append(v)
        state = jax.tree_util.tree_unflatten(treedef, vals)
        self.params = jax.tree.map(jnp.asarray, state["params"])
        self.opt_state = jax.tree.map(jnp.asarray, state["opt_state"])
        self.step_count = int(state["step_count"])
