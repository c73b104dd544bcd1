"""MRT_* knob validation: bad values must fail loudly, not mis-tile.

An unchecked knob lets a bad MRT_CLUSTER_GROUP or MRT_LOSS_TILE
silently change perf or shapes. utils/knobs.py range-checks every
read; these tests pin that and
keep the registry in sync with the code's actual read sites.
"""

import os
import subprocess
import sys

import pytest

from myraytracer_tpu.utils import knobs


def test_env_int_accepts_default_and_set(monkeypatch):
    monkeypatch.delenv("MRT_TILE", raising=False)
    assert knobs.env_int("MRT_TILE", 16384, lo=1024) == 16384
    monkeypatch.setenv("MRT_TILE", "2048")
    assert knobs.env_int("MRT_TILE", 16384, lo=1024) == 2048


@pytest.mark.parametrize("val,kw", [
    ("abc", dict(lo=1024)),
    ("512", dict(lo=1024)),
    ("3000", dict(multiple_of=1024)),
    ("33", dict(power_of_two=True)),
])
def test_env_int_rejects(monkeypatch, val, kw):
    monkeypatch.setenv("MRT_TILE", val)
    with pytest.raises(ValueError, match="MRT_TILE"):
        knobs.env_int("MRT_TILE", 16384, **kw)


def test_env_float_rejects_range_and_parse(monkeypatch):
    monkeypatch.setenv("MRT_CLUSTER_KAPPA", "-1")
    with pytest.raises(ValueError, match="MRT_CLUSTER_KAPPA"):
        knobs.env_float("MRT_CLUSTER_KAPPA", 2e-4, lo=1e-8)
    monkeypatch.setenv("MRT_CLUSTER_KAPPA", "x")
    with pytest.raises(ValueError, match="not a number"):
        knobs.env_float("MRT_CLUSTER_KAPPA", 2e-4)


def test_env_choice_rejects_unknown(monkeypatch):
    monkeypatch.setenv("MRT_SHADOW_ORDER", "fast")
    with pytest.raises(ValueError, match="not one of"):
        knobs.env_choice("MRT_SHADOW_ORDER", "light", ("light", "ray"))


def test_registry_covers_all_read_sites():
    """Every MRT_* name read anywhere in the package is in REGISTRY."""
    import pathlib
    import re

    pkg = pathlib.Path(knobs.__file__).resolve().parents[1]
    names = set()
    for path in pkg.rglob("*.py"):
        if path.name == "knobs.py":
            continue
        for m in re.finditer(r"[\"'](MRT_[A-Z_0-9]+)[\"']", path.read_text()):
            names.add(m.group(1))
    missing = names - set(knobs.REGISTRY)
    assert not missing, f"knobs.REGISTRY missing entries for {sorted(missing)}"


def test_bad_knob_fails_at_import():
    """An invalid knob value aborts module import (shape-affecting knobs
    are read at import time), rather than silently mis-rendering."""
    env = dict(os.environ, MRT_CLUSTER_GROUP="o", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", "import myraytracer_tpu.ops.cluster"],
        capture_output=True, text=True, env=env)
    assert proc.returncode != 0
    assert "MRT_CLUSTER_GROUP" in proc.stderr
