"""myraytracer_tpu — a differentiable Whitted-style ray tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
hvkwak/my-raytracer (C++/CUDA): Phong shading, shadows, recursive mirror
reflections, triangle meshes (flat/Phong), spheres, planes, textures,
median-split BVH acceleration, and adaptive supersampling — built as a
wavefront renderer over SoA ray/geometry buffers with a stackless threaded
BVH traversal, differentiable end-to-end, and sharded over device
meshes for multi-card scaling.

Layout:
    models/    scene data model: camera, materials, lights, meshes, scenes
    ops/       compute path: intersection, BVH, traversal, shading, render
    parallel/  device-mesh sharding of the render/grad pipeline
    utils/     vec math, PNG image IO, profiling
    runtime/   native (C++) host runtime: fast BVH build via ctypes
    scenes/    procedural authoring of the 10 reference scenes
"""

__version__ = "0.1.0"

from myraytracer_tpu.models.camera import Camera
from myraytracer_tpu.models.material import Material
from myraytracer_tpu.models.light import Light
from myraytracer_tpu.models.scene import Scene, SceneData
from myraytracer_tpu.ops.refit import refit_accel
from myraytracer_tpu.ops.render import render, render_aa

__all__ = [
    "Camera",
    "Material",
    "Light",
    "Scene",
    "SceneData",
    "render",
    "render_aa",
    "refit_accel",
]
