"""Pinhole camera with fractional-pixel primary rays.

Re-provides the missing framework ``Camera`` inferred from reference call
sites: ``camera.primary_ray(x, y)`` with a *double* overload so the
adaptive-supersampling kernel can shoot sub-pixel rays
(mytracer_gpu.cu:141, 208-209; SURVEY.md §1.1).

Batched design: instead of one ray per call, :meth:`primary_rays`
produces a whole ``[..., 3]`` batch of origins/directions from arrays of
fractional pixel coordinates, so ray generation is one fused elementwise pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp

from myraytracer_tpu.utils import vecmath as vm


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Right-handed look-at pinhole camera.

    Integer pixel coordinates address pixel *centers*; fractional offsets
    in [-0.5, 0.5] supersample inside a pixel, matching the reference's
    ``primary_ray(double, double)`` contract.
    x runs left->right, y runs top->bottom (image row 0 is the top).
    """

    eye: jnp.ndarray          # [3]
    center: jnp.ndarray       # [3] look-at point
    up: jnp.ndarray           # [3]
    #: full vertical FOV in degrees. A traced (differentiable) leaf, NOT
    #: static: it only feeds tan(fovy/2), so making it data costs nothing
    #: and lets inverse rendering recover zoom alongside pose (the
    #: reference's Camera carries fovy as a scene-file input,
    #: mytracer.cpp:88 / SURVEY.md §1.1).
    fovy: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.float32(45.0))
    width: int = dataclasses.field(metadata=dict(static=True), default=512)
    height: int = dataclasses.field(metadata=dict(static=True), default=512)

    @staticmethod
    def make(eye, center, up, fovy: float, width: int, height: int) -> "Camera":
        f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
        return Camera(f32(eye), f32(center), f32(up), f32(fovy), int(width), int(height))

    def _basis(self) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        view = vm.normalize(self.center - self.eye)
        right = vm.normalize(vm.cross(view, self.up))
        up = vm.cross(right, view)
        return view, right, up

    def primary_rays(self, xs: jnp.ndarray, ys: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched primary rays through fractional pixel coords.

        Args:
            xs, ys: arrays of identical shape ``[...]`` with pixel
                coordinates (column, row); integer values hit pixel centers.
        Returns:
            (origins, directions): ``[..., 3]`` arrays; directions are
            normalized. Origins broadcast the eye point.
        """
        view, right, up = self._basis()
        tan_half = jnp.tan(jnp.asarray(self.fovy) * (math.pi / 360.0))
        aspect = self.width / self.height
        # NDC in [-1, 1]; pixel center (x=0) maps to the center of the
        # leftmost pixel column: u = ((x + 0.5)/W)*2 - 1.
        u = ((xs + 0.5) / self.width) * 2.0 - 1.0
        v = 1.0 - ((ys + 0.5) / self.height) * 2.0
        d = (
            view
            + (u * tan_half * aspect)[..., None] * right
            + (v * tan_half)[..., None] * up
        )
        d = vm.normalize(d)
        o = jnp.broadcast_to(self.eye, d.shape)
        return o, d

    def pixel_grid(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Integer pixel-center coordinate grids, each ``[H, W]`` float32."""
        ys, xs = jnp.meshgrid(
            jnp.arange(self.height, dtype=jnp.float32),
            jnp.arange(self.width, dtype=jnp.float32),
            indexing="ij",
        )
        return xs, ys
