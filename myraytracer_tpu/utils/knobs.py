"""Validated access to the MRT_* environment knobs.

Every performance/debug environment variable the framework reads goes
through these getters, which fail LOUDLY at first read (usually module
import) instead of silently changing program shapes or perf: a typo'd
``MRT_CLUSTER_GROUP=o`` or an out-of-range ``MRT_LOSS_TILE`` would
otherwise either crash deep inside tracing or quietly mis-tile the
render.

``REGISTRY`` doubles as the documentation table printed by
``python -m myraytracer_tpu.utils.knobs``; each entry records the
default, its constraint and where the value is used.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

#: name -> (default, constraint description, where it is used / swept)
REGISTRY = {
    "MRT_TILE": ("16384", "int >= 1024", "render tile rays; PERF round-3/4 sweeps"),
    "MRT_BLOCK": ("32", "int >= 8, power of two", "screen block side; PERF round-2 BLOCK sweep"),
    "MRT_LOSS_TILE": ("23040", "int >= 1024", "loss/grad remat tile; PERF round-2/4 sweeps"),
    "MRT_TWO_PHASE": ("1", "0|1", "topology+replay split for grads (render.py)"),
    "MRT_REPLAY_CKPT": ("1", "0|1", "checkpoint the shading replay; PERF round-4 A/B"),
    "MRT_CKPT_PREVENT_CSE": ("1", "0|1", "checkpoint CSE barriers; 0 measured 0.340 vs 0.244 (rejected)"),
    "MRT_SHADOW_ORDER": ("light", "light|ray", "shadow batch order; PERF round-3 sweep"),
    "MRT_CLUSTER_CUT": ("dp", "dp|subtree", "cluster cut algorithm; PERF round-4"),
    "MRT_CLUSTER_KAPPA": ("auto", "auto or float > 0", "DP cut per-cluster penalty (fraction of root SA)"),
    "MRT_CLUSTER_MERGE_SA": ("0.75", "float >= 0", "subtree-cut merge SA ratio (0 disables)"),
    "MRT_CLUSTER_GROUP": ("2", "int >= 1", "XLA cluster scan group size"),
    "MRT_CLUSTER_STORE_LIMIT": ("33554432", "int >= 1", "[R,K] phase-1 mask entry budget"),
    "MRT_NO_NATIVE": ("0", "0|1", "disable the C++ BVH builder"),
    "MRT_DISTRIBUTED": ("0", "0|1", "jax.distributed init at import (parallel/distributed.py)"),
    "MRT_COORDINATOR": ("", "host:port", "jax.distributed coordinator address"),
    "MRT_NUM_PROCESSES": ("", "int >= 1", "jax.distributed process count"),
    "MRT_PROCESS_ID": ("", "int >= 0", "jax.distributed process id"),
    "MRT_STEPS_INNER": ("4", "int in [1, 64]", "BVH walk steps per while iteration (traverse.py)"),
}


def _raw(name: str) -> Optional[str]:
    return os.environ.get(name)


def _fail(name: str, val: str, why: str) -> None:
    spec = REGISTRY.get(name)
    hint = f" (expected {spec[1]}; default {spec[0]})" if spec else ""
    raise ValueError(f"{name}={val!r}: {why}{hint}")


def env_int(name: str, default: int, lo: Optional[int] = None,
            hi: Optional[int] = None, multiple_of: Optional[int] = None,
            power_of_two: bool = False) -> int:
    raw = _raw(name)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        _fail(name, raw, "not an integer")
    if lo is not None and v < lo:
        _fail(name, raw, f"below minimum {lo}")
    if hi is not None and v > hi:
        _fail(name, raw, f"above maximum {hi}")
    if multiple_of is not None and v % multiple_of != 0:
        _fail(name, raw, f"not a multiple of {multiple_of}")
    if power_of_two and (v <= 0 or v & (v - 1)):
        _fail(name, raw, "not a power of two")
    return v


def env_float(name: str, default: float, lo: Optional[float] = None,
              hi: Optional[float] = None) -> float:
    raw = _raw(name)
    if raw is None:
        return default
    try:
        v = float(raw)
    except ValueError:
        _fail(name, raw, "not a number")
    if lo is not None and v < lo:
        _fail(name, raw, f"below minimum {lo}")
    if hi is not None and v > hi:
        _fail(name, raw, f"above maximum {hi}")
    return v


def env_choice(name: str, default: str, choices: Iterable[str]) -> str:
    raw = _raw(name)
    if raw is None:
        return default
    if raw not in tuple(choices):
        _fail(name, raw, f"not one of {sorted(choices)}")
    return raw


def env_bool01(name: str, default: bool) -> bool:
    return env_choice(name, "1" if default else "0", ("0", "1")) == "1"


def main() -> None:  # pragma: no cover - convenience printer
    width = max(len(k) for k in REGISTRY)
    for name, (default, spec, where) in sorted(REGISTRY.items()):
        cur = os.environ.get(name)
        mark = f"  [set: {cur}]" if cur is not None else ""
        print(f"{name:<{width}}  default={default:<10} {spec:<28} {where}{mark}")


if __name__ == "__main__":  # pragma: no cover
    main()
