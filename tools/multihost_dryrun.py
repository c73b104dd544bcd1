"""Multi-process (multi-host stand-in) dryrun for the sharded train step.

Validates SURVEY.md §5.8's missing axis without a cluster: the parent spawns
N_PROC processes, each with N_LOCAL virtual CPU devices
(xla_force_host_platform_device_count), wired together by
jax.distributed.initialize + Gloo CPU collectives — the same program
structure as one process per multi-card host. Every process builds the
same scene, shards the global ray batch over the global 1-D mesh
(parallel.distributed), runs ONE sharded inverse-rendering train step
(fwd + bwd + grad psum + SGD), and process 0 reports the loss. The
parent asserts it equals the single-process value.

Run directly:             python tools/multihost_dryrun.py
As the driver dryrun:     __graft_entry__.dryrun_multichip calls run().
Child entry (internal):   python tools/multihost_dryrun.py --child <pid>
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_PROC = 2
N_LOCAL = 4


def toy_scene():
    """The dryrun scene (same as __graft_entry__'s single-process one)."""
    from myraytracer_tpu.models.material import Material
    from myraytracer_tpu.models.mesh import PHONG, TriangleMesh
    from myraytracer_tpu.models.scene import Scene
    from myraytracer_tpu.scenes.shapes import uv_sphere

    s = Scene()
    s.set_camera(eye=(0, 1, 5), center=(0, 0, 0), up=(0, 1, 0), fovy=45,
                 width=16, height=16)
    s.add_light((2, 4, 4), (0.8, 0.8, 0.8))
    s.add_sphere((0.8, 0, 0), 0.7, Material(diffuse=(0.7, 0, 0), mirror=0.2))
    v, f = uv_sphere(0.5, 6, 8, center=(-0.9, 0, 0))
    s.add_mesh(TriangleMesh(v, f, material=Material(diffuse=(0, 0.5, 0.5)),
                            draw_mode=PHONG))
    s.add_plane((0, -0.8, 0), (0, 1, 0), Material(diffuse=(0.5, 0.5, 0.5)))
    s.max_depth = 2
    return s


def _step_inputs():
    """Deterministic (scene, o, d, target, w) every process rebuilds."""
    import numpy as np

    s = toy_scene()
    scene = s.build()
    xs, ys = s.camera.pixel_grid()
    o, d = s.camera.primary_rays(xs.ravel(), ys.ravel())
    o = np.asarray(o)
    d = np.asarray(d)
    target = np.zeros((o.shape[0], 3), np.float32)
    w = np.ones((o.shape[0],), np.float32)
    return scene, o, d, target, w


def single_process_loss() -> float:
    """Reference value on this process's local (virtual) devices."""
    import jax.numpy as jnp

    from myraytracer_tpu.parallel import make_mesh, train_step_sharded

    scene, o, d, target, _ = _step_inputs()
    _, loss = train_step_sharded(scene, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(target), make_mesh(), lr=0.5)
    return float(loss)


def child_main(process_id: int) -> None:
    # env (coordinator, device count, platform) is set by the parent
    import jax

    jax.config.update("jax_platforms", "cpu")
    from myraytracer_tpu.parallel.distributed import (
        global_ray_mesh, initialize_from_env, replicate_global,
        shard_rays_global)

    assert initialize_from_env(), "child must run with MRT_COORDINATOR set"
    assert jax.process_count() == N_PROC, jax.process_count()
    assert jax.local_device_count() == N_LOCAL, jax.local_device_count()
    assert jax.device_count() == N_PROC * N_LOCAL

    from myraytracer_tpu.parallel.shard_render import make_train_step

    scene, o, d, target, w = _step_inputs()
    mesh = global_ray_mesh()
    scene_g = replicate_global(mesh, scene)
    o_g, d_g, t_g, w_g = shard_rays_global(mesh, o, d, target, w)
    _, loss = make_train_step(mesh, lr=0.5)(scene_g, o_g, d_g, t_g, w_g)
    if jax.process_index() == 0:
        print(f"MHLOSS {float(loss):.8f}", flush=True)


def run(timeout_s: float = 600.0) -> float:
    """Spawn the 2-process dryrun; return the multi-process loss."""
    with socket.socket() as s:  # free port on localhost
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env_base = {
        k: v for k, v in os.environ.items()
        if not k.startswith(("MRT_COORDINATOR", "MRT_NUM_PROCESSES",
                             "MRT_PROCESS_ID", "XLA_FLAGS", "JAX_PLATFORMS"))
    }
    procs = []
    for pid in range(N_PROC):
        env = dict(
            env_base,
            MRT_COORDINATOR=f"localhost:{port}",
            MRT_NUM_PROCESSES=str(N_PROC),
            MRT_PROCESS_ID=str(pid),
            XLA_FLAGS=f"--xla_force_host_platform_device_count={N_LOCAL}",
            JAX_PLATFORMS="cpu",
            PYTHONPATH=REPO + os.pathsep + env_base.get("PYTHONPATH", ""),
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(pid)],
            env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout_s)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError("multihost dryrun timed out; partial output:\n"
                           + "\n".join(outs))
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost child {p.args[-1]} failed "
                f"(rc={p.returncode}):\n{out}")
    for out in outs:
        for line in out.splitlines():
            if line.startswith("MHLOSS "):
                return float(line.split()[1])
    raise RuntimeError("no MHLOSS line in child output:\n" + "\n".join(outs))


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child_main(int(sys.argv[2]))
        return
    mh = run()
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{N_PROC * N_LOCAL}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    sp = single_process_loss()
    print(f"multi-process loss={mh:.8f} single-process loss={sp:.8f}")
    assert abs(mh - sp) <= 1e-5 * max(1.0, abs(sp)), (mh, sp)
    print("multihost dryrun OK")


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
