"""Device-mesh construction for ray-parallel rendering.

The only parallelism a Whitted renderer needs across cards is data
parallelism over rays/pixels (SURVEY.md §2.1): scene + BVH are replicated
into every card's memory, ray tiles are sharded on a 1-D mesh, the forward
pass needs zero communication, and only scene-parameter gradients
all-reduce (psum) in the backward — the multi-card counterpart of the
reference's single-GPU launch (cudaSetDevice(0), mytracer_gpu.cu:34-38).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: the single mesh axis rays are sharded over
RAY_AXIS = "rays"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the first ``n_devices`` (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAY_AXIS,))


def ray_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a flat ray/pixel-major array: leading axis split."""
    return NamedSharding(mesh, P(RAY_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
