"""Entry points refuse to run without a GPU, and the compile cache lives
where its one rule says.

chip_smoke.py and bench.py measure the card: on a machine without one
they exit non-zero and print no result, rather than timing the CPU. The
CLI's ``--backend gpu`` fails the same way.
"""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, **env):
    e = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_refuses_the_cpu():
    sys.path.insert(0, ROOT)
    try:
        import bench
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(RuntimeError, match="measures the GPU"):
        bench.device_fields()


def test_bench_script_exits_nonzero_without_gpu():
    proc = _run(["bench.py"], ROOT, BENCH_SMALL="1")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_cli_backend_gpu_fails_without_gpu(tmp_path):
    from myraytracer_tpu.cli import main

    assert main(["render", "--golden", "o_05_cube", "--scale", "0.08",
                 "--backend", "gpu", "--out", str(tmp_path / "r.png")]) == 2
    assert not (tmp_path / "r.png").exists()


_CACHE_PROBE = (
    "import jax; from myraytracer_tpu.utils.compile_cache import "
    "enable_compile_cache as e; print(e()); "
    "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_unset_uses_checkout_dir():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    outs = [subprocess.run([sys.executable, "-c", _CACHE_PROBE], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120).stdout.split() for _ in range(2)]
    want = os.path.join(ROOT, ".jax_cache")
    # the same fixed path in every process, and JAX is pointed at it
    assert outs[0] == outs[1] == [want, want]


def test_compile_cache_env_wins(tmp_path):
    proc = _run(["-c", _CACHE_PROBE], ROOT,
                JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert proc.stdout.split() == [str(tmp_path), str(tmp_path)]
