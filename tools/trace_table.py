"""Device time per op, per named scope, and the device idle share, from a
``jax.profiler`` trace of a GPU run.

Capture a trace with ``myraytracer_tpu.utils.profiling.profile_trace``,
then point this at the dump dir:

  python tools/trace_table.py DUMP_DIR [--runs N] [--top K]

The newest ``*.xplane.pb`` under DUMP_DIR is read with
``jax.profiler.ProfileData``. Device planes are the ones named
``/device:GPU:<n>``; an op is an event on one of a device plane's
lines: the stream lines the profiler records kernels and copies on.

Definitions:
  busy       union of the op intervals on one device
  window     first op start to last op end on that device
  idle share 1 - busy / window
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re
from typing import Dict, Iterable, List, NamedTuple, Optional

DEVICE_PLANE = re.compile(r"^/device:GPU:\d+$")


class Op(NamedTuple):
    """One device event: a kernel or a copy."""

    device: str
    line: str
    name: str
    start_ns: float
    dur_ns: float
    hlo_op: str = ""


def load_ops(dump_dir: str) -> List[Op]:
    """Device ops of the newest trace under ``dump_dir``."""
    import jax

    paths = sorted(glob.glob(
        os.path.join(dump_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {dump_dir}")
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    ops = []
    for plane in pd.planes:
        if not DEVICE_PLANE.match(plane.name):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                ops.append(Op(plane.name, line.name, ev.name,
                              float(ev.start_ns), float(ev.duration_ns),
                              str(stats.get("hlo_op", ""))))
    return ops


def busy_ns(ops: Iterable[Op]) -> float:
    """Length of the union of the ops' intervals."""
    total, end = 0.0, None
    for a, b in sorted((o.start_ns, o.start_ns + o.dur_ns) for o in ops):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_share(ops: List[Op]) -> Dict[str, float]:
    """Per device: 1 - busy / (last op end - first op start)."""
    by_dev = collections.defaultdict(list)
    for o in ops:
        by_dev[o.device].append(o)
    out = {}
    for dev, evs in sorted(by_dev.items()):
        window = (max(o.start_ns + o.dur_ns for o in evs)
                  - min(o.start_ns for o in evs))
        out[dev] = 1.0 - busy_ns(evs) / window if window > 0 else 0.0
    return out


def op_table(ops: List[Op]):
    """(total ns, count) per op name, largest first."""
    dur = collections.defaultdict(float)
    cnt = collections.Counter()
    for o in ops:
        dur[o.name] += o.dur_ns
        cnt[o.name] += 1
    return sorted(((d, cnt[n], n) for n, d in dur.items()), reverse=True)


def hlo_scopes(hlo_text: str) -> Dict[str, str]:
    """Map each HLO instruction name of a compiled module's text
    (``compiled.as_text()``) to its ``op_name`` metadata, which carries
    the ``jax.named_scope`` path."""
    out = {}
    pat = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?'
                     r'metadata=\{[^}]*op_name="([^"]*)"')
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def scope_shares(ops: List[Op], scopes: Dict[str, str],
                 names: Iterable[str]) -> Dict[str, float]:
    """Share of summed op time whose HLO op sits under each named scope
    (matched as a ``/<name>/`` path component); ``"other"`` is the rest,
    ops that carry no HLO op (copies) included."""
    names = tuple(names)
    acc = collections.defaultdict(float)
    total = 0.0
    for o in ops:
        total += o.dur_ns
        path = "/" + scopes.get(o.hlo_op, "") + "/"
        hit = next((n for n in names if f"/{n}/" in path), "other")
        acc[hit] += o.dur_ns
    return {k: acc[k] / total for k in names + ("other",)} if total else {}


def print_table(ops: List[Op], runs: int = 1, top: int = 10,
                out=None) -> None:
    """The top ops (ms per run) and each device's idle share."""
    import sys

    out = out or sys.stdout
    total = sum(o.dur_ns for o in ops)
    print(f"device op time: {total / runs / 1e6:.3f} ms per run over "
          f"{len({o.device for o in ops})} device(s), {len(ops)} ops "
          f"({runs} runs traced)", file=out)
    print(f"{'ms/run':>9}  {'share':>6}  {'calls/run':>9}  op", file=out)
    for d, c, n in op_table(ops)[:top]:
        print(f"{d / runs / 1e6:9.3f}  {d / total:6.1%}  {c / runs:9.1f}  "
              f"{n[:90]}", file=out)
    for dev, share in idle_share(ops).items():
        print(f"idle share {dev}: {share:.4f}", file=out)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("dump_dir")
    ap.add_argument("--runs", type=int, default=1,
                    help="traced iterations (totals are divided by it)")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    ops = load_ops(args.dump_dir)
    if not ops:
        raise SystemExit(f"no GPU device ops in the trace under "
                         f"{args.dump_dir}")
    print_table(ops, args.runs, args.top)


if __name__ == "__main__":
    main()
