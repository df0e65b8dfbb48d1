"""The trace reductions on a hand-made timeline: busy time as the union of
device intervals, the idle gaps named by the host event over their middle,
and device time inside a host span's extent on the device."""

from __future__ import annotations

import pytest

from portbench.harness.registry import ROOT, module
from portbench.harness.trace import WINDOW, Trace


def _trace():
    tr = Trace()
    k1, k2, k3 = (0, 100, "k1"), (50, 150, "k2"), (400, 500, "k1")
    tr.device = [k1, k2, k3]
    tr.host = [(0, 300, "forward_backward"), (10, 20, "cudaLaunchKernel"),
               (30, 40, "cudaLaunchKernel"), (300, 390, "optimizer"),
               (310, 320, "cudaLaunchKernel"), (260, 290, "aten::copy_")]
    tr.device_spans = [(0, 160, "forward_backward"), (390, 520, "optimizer")]
    tr.window_s = 600e-9
    return tr


def test_busy_and_gaps():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(250e-9)
    gaps = tr.idle_gaps()
    assert gaps[0] == ["aten::copy_", pytest.approx(250e-9)]
    assert tr.top_ops(1) == [["k1", pytest.approx(200e-9)]]
    assert tr.seconds_matching(["k1"]) == (pytest.approx(200e-9), 2)


def test_device_time_inside_a_span():
    tr = _trace()
    # k1 and k2 overlap: each is counted for its own time
    assert tr.seconds_in_span("forward_backward") == (pytest.approx(200e-9), 1)
    assert tr.seconds_in_span("optimizer") == (pytest.approx(100e-9), 1)
    assert tr.seconds_in_span("nothing") == (0.0, 0)
    # from the start of forward_backward's extent to the start of optimizer's
    assert tr.seconds_between("forward_backward", "optimizer") == (pytest.approx(200e-9), 1)
    assert tr.seconds_between("optimizer", "forward_backward") == (0.0, 0)


def test_a_marked_trace_keeps_what_lies_inside_its_window():
    tr = _trace()
    tr.host.append((40, 460, WINDOW))
    tr._clip()
    # k1 began before the window and the second k1 ended after it
    assert tr.device == [(50, 150, "k2")]
    assert tr.window_s == pytest.approx(420e-9)
    assert tr.busy_s() == pytest.approx(100e-9)


def test_train_idle_share_is_of_the_windows_step():
    """Device seconds per traced step over the window's seconds per step,
    not over the (slower) traced step."""
    class Run:
        spans = dict(driver="train", window_s=10.0, steps=20, traced_steps=2)
        trace = _trace()
    Run.trace.device = [(0, int(0.1e9), "k"), (int(1e9), int(1.1e9), "k")]
    Run.trace.window_s = 2.4  # the profiler's 1.2 s steps
    reader = module(ROOT / "metrics" / "idle_share.train.py")
    assert reader.read(Run) == pytest.approx(1 - 0.1 / 0.5)
