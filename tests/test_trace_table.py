"""tools/trace_table.py: the reduction from a GPU profiler trace to the
op table, the per-scope shares and the device idle share, checked on a
small synthetic trace whose answers are known by construction."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import trace_table as tt  # noqa: E402

GPU0, GPU1 = "/device:GPU:0", "/device:GPU:1"
STREAM = "Stream #13(Compute)"


def op(dev, name, start, dur, hlo=""):
    return tt.Op(dev, STREAM, name, float(start), float(dur), hlo)


#: GPU0: busy [0,10) + [5,15) overlap -> [0,15), then [20,30) and a copy
#: at [40,50): busy 35 of a 50 ns window. GPU1: one 10 ns kernel.
OPS = [
    op(GPU0, "fusion_a", 0, 10, "fusion.1"),
    op(GPU0, "fusion_b", 5, 10, "fusion.2"),
    op(GPU0, "fusion_a", 20, 10, "fusion.1"),
    op(GPU0, "MemcpyD2H", 40, 10),
    op(GPU1, "fusion_a", 100, 10, "fusion.1"),
]

HLO = """HloModule jit_render
%fused_computation.1 (p: f32[4]) -> f32[4] {
  ROOT %x = f32[4] negate(f32[4] %p)
}
ENTRY %main {
  %fusion.1 = f32[4]{0} fusion(f32[4]{0} %p0), kind=kLoop, calls=%fused_computation.1, metadata={op_name="jit(render)/while/body/traverse/select_n" source_file="t.py"}
  ROOT %fusion.2 = f32[4]{0} fusion(f32[4]{0} %p1), kind=kLoop, calls=%c, metadata={op_name="jit(render)/while/body/shade/mul"}
  %copy.3 = f32[4]{0} copy(f32[4]{0} %p2)
}
"""


def test_busy_is_the_union_of_intervals():
    assert tt.busy_ns(OPS[:4]) == 35.0
    assert tt.busy_ns([]) == 0.0


def test_idle_share_per_device():
    idle = tt.idle_share(OPS)
    assert idle[GPU0] == pytest.approx(1 - 35 / 50)
    assert idle[GPU1] == pytest.approx(0.0)


def test_op_table_sums_and_orders():
    table = tt.op_table(OPS)
    assert table[0] == (30.0, 3, "fusion_a")
    assert {n: (d, c) for d, c, n in table}["MemcpyD2H"] == (10.0, 1)


def test_hlo_scopes_parses_compiled_text():
    scopes = tt.hlo_scopes(HLO)
    assert scopes["fusion.1"] == "jit(render)/while/body/traverse/select_n"
    assert scopes["fusion.2"] == "jit(render)/while/body/shade/mul"
    assert "copy.3" not in scopes


def test_scope_shares_attribute_by_path_component():
    shares = tt.scope_shares(OPS, tt.hlo_scopes(HLO), ("traverse", "shade"))
    total = 10 + 10 + 10 + 10 + 10
    assert shares["traverse"] == pytest.approx(30 / total)
    assert shares["shade"] == pytest.approx(10 / total)
    assert shares["other"] == pytest.approx(10 / total)


def test_print_table_reports_idle(capsys):
    tt.print_table(OPS, runs=1, top=2)
    out = capsys.readouterr().out
    assert "fusion_a" in out and f"idle share {GPU0}: 0.3000" in out


def _recorded():
    import json

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "gpu_trace_ops.json")
    with open(path) as f:
        rec = json.load(f)
    return [tt.Op(rec["device"], rec["line"], n, s, d, h)
            for n, s, d, h in rec["ops"]]


def test_recorded_gpu_trace_reduction():
    """A small trace recorded on an H100 (tests/data/gpu_trace_ops.json):
    every op sits on the device's one stream line, busy time fits in the
    window, and the idle share and top op are pinned."""
    ops = _recorded()
    assert len(ops) == 1273
    assert {o.device for o in ops} == {GPU0}
    window = max(o.start_ns + o.dur_ns for o in ops) - min(
        o.start_ns for o in ops)
    assert 0 < tt.busy_ns(ops) <= sum(o.dur_ns for o in ops)
    assert tt.busy_ns(ops) <= window
    assert tt.idle_share(ops)[GPU0] == pytest.approx(0.6643, abs=1e-4)
    top_dur, top_calls, top_name = tt.op_table(ops)[0]
    assert top_name == "input_reduce_fusion_2" and top_calls == 60
    # kernels inside command buffers carry no per-kernel HLO op
    assert any(o.hlo_op == "command_buffer" for o in ops)
