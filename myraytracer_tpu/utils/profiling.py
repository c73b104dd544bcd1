"""Profiling & timing: the counterpart of the reference's tooling.

The reference brackets kernels with gettimeofday (common/common.h:66-72)
and wraps Nsight Compute with a curated metric list (my-ncu.sh). Here:

  * Timer                  wall-clock bracket with block_until_ready
  * profile_trace          context manager around jax.profiler — traces
                           open in XProf / TensorBoard (the ncu analogue)
  * render_metrics         per-render metrics dict (rays/s, build time,
                           memory estimate) for structured logging
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional

import jax


@dataclasses.dataclass
class Timer:
    """Wall-clock bracket; ensures device work is finished."""

    name: str = ""
    elapsed: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    @staticmethod
    def timed(fn, *args, sync: bool = True, **kwargs):
        """Run fn, waiting for device completion; returns (result, seconds)."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            out = jax.block_until_ready(out)
        return out, time.perf_counter() - t0


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace context — reduce with tools/trace_table.py or
    view with XProf/TensorBoard.

    Replaces my-ncu.sh's role: per-kernel device time and the device
    idle share come from the captured trace (tools/trace_table.py).
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def scene_footprint_bytes(scene) -> int:
    """Device-memory footprint of the packed scene (per replica)."""
    total = 0
    for leaf in jax.tree.leaves(scene):
        if hasattr(leaf, "nbytes"):
            total += leaf.nbytes
    return total


def render_metrics(
    scene,
    width: int,
    height: int,
    render_s: float,
    build_s: Optional[float] = None,
    spp: float = 1.0,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Structured per-render metrics (SURVEY.md §5.5)."""
    n_rays = int(width * height * spp)
    m = {
        "resolution": f"{width}x{height}",
        "spp": spp,
        "rays": n_rays,
        "render_s": round(render_s, 4),
        "rays_per_s": round(n_rays / render_s, 1) if render_s > 0 else None,
        "n_tris": scene.n_tris,
        "n_spheres": scene.n_spheres,
        "n_planes": scene.n_planes,
        "n_cylinders": scene.n_cylinders,
        "n_lights": scene.n_lights,
        "bvh_nodes": scene.n_nodes,
        "max_depth": scene.max_depth,
        "scene_bytes": scene_footprint_bytes(scene),
        "device": str(jax.devices()[0]),
    }
    if build_s is not None:
        m["build_s"] = round(build_s, 4)
    if extra:
        m.update(extra)
    return m
