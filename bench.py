"""Headline benchmark: Office 1920x1080 @1spp, forward + backward, on a GPU.

Prints JSON result lines to stdout, one at a time, each a complete
superset of the previous — **the last complete JSON line wins**. The
first line is flushed as soon as the first forward measurement exists:

  {"metric": "office_1080p_fwd_bwd_rays_per_s", "value": N,
   "unit": "rays/s/chip", "vs_baseline": N, "platform": "gpu",
   "device_kind": "...", "device_count": N, ...extras}

While only the forward has been measured, `value` carries the forward
throughput and `"stage": "fwd"` marks it provisional; once fwd+bwd is
measured the final line reports the real headline metric
(`"stage": "fwd_bwd"`).

vs_baseline is measured against the reference renderer's published
Office number — 5.3 s for 1920x1080 @1spp (/root/reference/README.md:10,
BASELINE.md) i.e. ~0.391 Mray/s — which is *forward only*; the final
line holds forward+backward against it.

The benchmark measures the GPU only: it exits with an error when JAX's
default device is anything else. Every timing waits for the device with
``jax.block_until_ready``.

Env knobs:
  BENCH_TESS        office tessellation level (default 10)
  BENCH_SMALL       set to 1 for a fast smoke run (480x270)
  BENCH_RES         explicit "WxH" resolution override (testing)
  BENCH_FWD_ONLY    set to 1 to skip the fwd+bwd program
  BENCH_NO_AA       set to 1 to skip the AA-included stage
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

BASELINE_S = 5.3  # reference office 1920x1080 (README.md:10)

def _emit(result: dict) -> None:
    """Write the current best result as one flushed JSON line."""
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()


def _resolution() -> tuple[int, int]:
    if os.environ.get("BENCH_RES"):
        w, h = os.environ["BENCH_RES"].split("x")
        return int(w), int(h)
    if os.environ.get("BENCH_SMALL") == "1":
        return 480, 270
    return 1920, 1080


def device_fields() -> dict:
    """The device every result line is tagged with. Raises unless JAX's
    default device is a GPU: a CPU number must never be read as one."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; JAX's default device is "
            f"{dev.platform!r} ({dev.device_kind})")
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def main() -> None:
    t_start = time.perf_counter()
    tess = int(os.environ.get("BENCH_TESS", "10"))
    width, height = _resolution()

    import jax

    device = device_fields()
    import jax.numpy as jnp

    from myraytracer_tpu.ops.render import render, render_loss_grad_image
    from myraytracer_tpu.scenes.golden import scene_08_office
    from myraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sc = scene_08_office(tess=tess, resolution=(width, height))
    t0 = time.perf_counter()
    scene = sc.build()
    build_s = time.perf_counter() - t0
    sys.stderr.write(f"bench: scene built in {build_s:.1f}s "
                     f"({int(scene.n_tris)} tris)\n")
    sys.stderr.flush()

    n_rays = width * height
    target = jnp.zeros((height, width, 3), jnp.float32)
    baseline_rays_per_s = (1920 * 1080) / BASELINE_S

    sync = jax.block_until_ready

    result = {
        "metric": "office_1080p_fwd_bwd_rays_per_s",
        "value": 0.0,
        "unit": "rays/s/chip",
        "vs_baseline": 0.0,
        "stage": "compiling",
        "resolution": f"{width}x{height}",
        "n_tris": int(scene.n_tris),
        "bvh_nodes": int(scene.n_nodes),
        "scene_build_s": round(build_s, 3),
        **device,
    }
    _emit(result)  # a parseable line exists from the first moment

    # ---- forward: compile, then emit a line after EVERY timed run ----
    t0 = time.perf_counter()
    img = render(scene, sc.camera)
    sync(img)
    fwd_compile_s = time.perf_counter() - t0
    result["fwd_compile_s"] = round(fwd_compile_s, 1)
    sys.stderr.write(f"bench: fwd compiled+ran in {fwd_compile_s:.1f}s\n")
    sys.stderr.flush()

    fwd_times = []
    for i in range(3):
        t0 = time.perf_counter()
        img = render(scene, sc.camera)
        sync(img)
        fwd_times.append(time.perf_counter() - t0)
        fwd_s = min(fwd_times)
        # provisional: value = forward throughput until fwd+bwd exists
        result.update(
            stage="fwd",
            value=round(n_rays / fwd_s, 1),
            vs_baseline=round((n_rays / fwd_s) / baseline_rays_per_s, 3),
            fwd_rays_per_s=round(n_rays / fwd_s, 1),
            fwd_s=round(fwd_s, 4),
        )
        _emit(result)

    # steady-state (pipelined) throughput: N dispatches, one sync, so
    # the host's dispatch of one call overlaps the device's previous
    # one. The headline `value` stays the single-call wall time.
    NPIPE = 5

    def pipelined(fn, sync_last):
        # min over batches: a loaded host can starve the async dispatch
        # queue and make one batch read dispatch gaps, not device time
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            out = None
            for _ in range(NPIPE):
                out = fn()
            sync_last(out)
            dt = (time.perf_counter() - t0) / NPIPE
            best = dt if best is None else min(best, dt)
        return round(best, 4)

    result["fwd_s_pipelined"] = pipelined(
        lambda: render(scene, sc.camera), sync)
    _emit(result)

    if os.environ.get("BENCH_FWD_ONLY") == "1":
        return

    # ---- forward + backward (the headline metric) ----
    def run_fb():
        return render_loss_grad_image(scene, sc.camera, target)

    t0 = time.perf_counter()
    loss, grads = sync(run_fb())
    bwd_compile_s = time.perf_counter() - t0
    result["bwd_compile_s"] = round(bwd_compile_s, 1)
    sys.stderr.write(f"bench: fwd+bwd compiled+ran in {bwd_compile_s:.1f}s\n")
    sys.stderr.flush()

    fb_times = []
    for i in range(3):
        t0 = time.perf_counter()
        loss, grads = sync(run_fb())
        fb_times.append(time.perf_counter() - t0)
        fwd_bwd_s = min(fb_times)
        result.update(
            stage="fwd_bwd",
            value=round(n_rays / fwd_bwd_s, 1),
            vs_baseline=round(
                (n_rays / fwd_bwd_s) / baseline_rays_per_s, 3),
            fwd_bwd_s=round(fwd_bwd_s, 4),
            loss_finite=bool(np.isfinite(float(loss))),
            total_wall_s=round(time.perf_counter() - t_start, 1),
        )
        _emit(result)

    # pipelined fwd+bwd (see fwd_s_pipelined comment)
    result["fwd_bwd_s_pipelined"] = pipelined(run_fb, sync)
    _emit(result)

    # ---- AA-included forward (apples-to-apples vs the reference GPU) --
    # The reference's 5.31 s GPU number ALWAYS includes its adaptive-
    # supersampling second kernel (/root/reference/mytracer_gpu.cu:83-109),
    # so this stage measures render + the same AA rule (render_aa). The
    # compaction budget is SIZED FROM THE MEASURED pass-1 deviation at
    # this resolution (the golden budgets are calibrated for the 500x500
    # goldens; at 1080p only ~2.8%% of office pixels exceed the 0.02
    # threshold): budget = measured fraction x 1.3 margin, rounded up to
    # 0.005 — always >= the reference's exact above-threshold set, which
    # is what test_aa_budget.py enforces for the goldens.
    if os.environ.get("BENCH_NO_AA") != "1":
        import math

        from myraytracer_tpu.ops.render import AA_THRESHOLD, _deviation, render_aa

        img1 = render(scene, sc.camera)
        frac = float((jnp.asarray(_deviation(img1)) > AA_THRESHOLD).mean())
        # the deviation map is deterministic for a fixed scene+resolution,
        # so the margin only covers fp noise across runs — 10% is plenty
        aa_budget = max(0.01, math.ceil(frac * 1.1 / 0.0025) * 0.0025)
        result["aa_budget"] = aa_budget
        sys.stderr.write(
            f"bench: AA above-threshold frac {frac:.4f} -> budget {aa_budget}\n")
        baseline_aa_rays_per_s = (1920 * 1080) / 5.31  # README.md:11

        t0 = time.perf_counter()
        img = render_aa(scene, sc.camera, budget_frac=aa_budget)
        sync(img)
        result["aa_compile_s"] = round(time.perf_counter() - t0, 1)
        sys.stderr.write(
            f"bench: AA compiled+ran in {result['aa_compile_s']:.1f}s\n")
        sys.stderr.flush()
        aa_times = []
        for i in range(3):
            t0 = time.perf_counter()
            img = render_aa(scene, sc.camera, budget_frac=aa_budget)
            sync(img)
            aa_times.append(time.perf_counter() - t0)
            aa_s = min(aa_times)
            result.update(
                aa_s=round(aa_s, 4),
                aa_rays_per_s=round(n_rays / aa_s, 1),
                aa_vs_baseline=round(
                    (n_rays / aa_s) / baseline_aa_rays_per_s, 3),
                total_wall_s=round(time.perf_counter() - t_start, 1),
            )
            _emit(result)

        # pipelined render+AA (see fwd_s_pipelined comment)
        result["aa_s_pipelined"] = pipelined(
            lambda: render_aa(scene, sc.camera, budget_frac=aa_budget),
            sync)
        result["total_wall_s"] = round(time.perf_counter() - t_start, 1)
        _emit(result)


if __name__ == "__main__":
    main()
