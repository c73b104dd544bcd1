"""Multi-host (multi-process) execution: one global mesh over every host.

The reference is a single-process, single-GPU renderer
(cudaSetDevice(0), /root/reference/mytracer_gpu.cu:34-38). This system's
scaling axis (SURVEY.md §5.8, BASELINE.md "1 chip -> 1 host -> N>=2
hosts") is pure ray data parallelism: scene + BVH replicated into every
card's memory, ray tiles sharded over ONE global mesh spanning every
process's devices, zero forward communication, and a single psum of the
scene-parameter gradients per training step. XLA lowers that psum to
the collective library of the platform, so no host-specific code is
needed beyond building the mesh in process-major device order
(jax.devices() already enumerates devices that way).

Launch (one process per host; also works one process per chip):

  MRT_COORDINATOR=host0:8476 MRT_NUM_PROCESSES=4 MRT_PROCESS_ID=$i \
      python your_script.py

with your script calling :func:`initialize_from_env` before first JAX
use. Where a cluster manager (e.g. SLURM) is present,
`jax.distributed.initialize()` auto-discovers all three values, so
`initialize_from_env` with no env set still does the right thing when
MRT_DISTRIBUTED=1 requests it.

Tested without a pod by tools/multihost_dryrun.py: 2 processes x 4
virtual CPU devices each (Gloo collectives), asserting the sharded
train step's loss equals the single-process value — the driver runs it
through __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from myraytracer_tpu.parallel.mesh import RAY_AXIS


def initialize_from_env(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or MRT_* env vars.

    Returns True when multi-process mode was initialized, False when the
    session stays single-process (no coordinator configured). Must run
    before the first JAX backend touch.

    Env: MRT_COORDINATOR=host:port, MRT_NUM_PROCESSES, MRT_PROCESS_ID;
    or MRT_DISTRIBUTED=1 alone to use JAX's cluster auto-detection
    (e.g. SLURM).
    """
    coordinator = coordinator or os.environ.get("MRT_COORDINATOR")
    if num_processes is None:
        v = os.environ.get("MRT_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("MRT_PROCESS_ID")
        process_id = int(v) if v is not None else None

    if coordinator:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    if os.environ.get("MRT_DISTRIBUTED") == "1":
        jax.distributed.initialize()  # pod/SLURM auto-detection
        return True
    return False


def global_ray_mesh() -> Mesh:
    """1-D ray mesh over ALL devices of ALL processes.

    jax.devices() enumerates devices process-major, so contiguous ray
    shards live on one host's cards and the grad psum's cross-host hop
    reduces per-host partials (the collective library picks that
    decomposition for this device order).
    """
    return Mesh(np.asarray(jax.devices()), (RAY_AXIS,))


def make_global(mesh: Mesh, x, spec: P):
    """Build a global jax.Array from identical process-local data.

    Every process passes the SAME full-size numpy/jax array (scene
    construction is deterministic, ray grids are functions of the
    camera); each process materializes only its addressable shards.
    """
    x = np.asarray(x)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def shard_rays_global(mesh: Mesh, *arrays):
    """Shard ray-major arrays (leading axis) over the global mesh.

    Arrays must already be padded to a multiple of the global device
    count (parallel.shard_render._pad_rays).
    """
    return tuple(make_global(mesh, a, P(RAY_AXIS)) for a in arrays)


def replicate_global(mesh: Mesh, tree):
    """Replicate every leaf of a pytree onto all devices of the mesh."""
    return jax.tree.map(lambda x: make_global(mesh, x, P()), tree)
