"""The yardstick's counts against a hand count, and the trace
reduction against a hand-made trace."""
import pytest
import torch

from bench import devtrace, reference, yardstick


def small():
    # path 0-1-2, edge 3-4 (given twice), vertex 5 alone, a self-loop
    src = torch.tensor([0, 1, 3, 4, 5])
    dst = torch.tensor([1, 2, 4, 3, 5])
    return reference.Graph(src, dst, 6)


def test_traversed_edges_by_hand():
    g = small()
    assert yardstick.traversed_edges(g, [0]) == 2
    assert yardstick.traversed_edges(g, [0, 2, 3]) == 2 + 2 + 1
    assert yardstick.traversed_edges(g, [5]) == 0


def test_call_bytes_by_hand():
    g = small()
    # one word a row (6 vertices); rows 0, 1, 2 non-zero; 4 lanes
    assert yardstick.call_bytes(g, [0]) == 4 * 1 * 6 + 4 * 1 + 4 * 3
    # components {0, 1, 2} and {3, 4}: 6 lanes, 5 words; read once
    assert yardstick.call_bytes(g, [0, 1, 3]) == 4 * 3 * 6 + 4 * 3 + 4 * 5


def test_packed_words_below_lanes():
    """A star of 0 and 1..3: 6 lanes; row 0 holds one word, rows 1..3 one
    each, so the packed layout is the cheaper (4 words)."""
    g = reference.Graph(torch.tensor([0, 0, 0]), torch.tensor([1, 2, 3]), 40)
    assert g.n_lanes == 6
    assert yardstick.call_bytes(g, [2]) == 4 * 40 + 4 + 4 * 4
    assert yardstick.least_seconds(10**12, "NVIDIA H100 80GB HBM3") == \
        10**12 / 3.35e12


def test_a_card_without_a_peak_is_refused():
    with pytest.raises(ValueError, match="no HBM peak"):
        yardstick.least_seconds(10**12, "NVIDIA H100 PCIe")


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def test_trace_reduction_by_hand():
    events = [
        ev("user_annotation", devtrace.SPAN, 0, 100),
        ev("user_annotation", devtrace.SPAN, 100, 50),
        ev("cpu_op", "aten::index", 0, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 4, 6),
        ev("cpu_op", "aten::item", 60, 40),
        ev("cuda_runtime", "cudaStreamSynchronize", 65, 30),
        ev("kernel", "gather", 10, 40, tid=7),
        ev("kernel", "gather", 40, 20, tid=8),        # overlaps the first
        ev("gpu_memcpy", "copy", 120, 10, tid=7),
        ev("kernel", "late", 400, 10, tid=7),         # after the calls
        ev("user_annotation", devtrace.SPAN, 500, 20),
        ev("gpu_user_annotation", devtrace.SPAN, 5, 300, tid=7),  # mirror
        ev("kernel", "between", 200, 50, tid=7),      # between two calls
    ]
    s = devtrace.reduce(events)
    assert abs(s.window_s - 170e-6) < 1e-12           # the three spans
    assert abs(s.busy_s - 60e-6) < 1e-12              # 10..60 and 120..130
    assert s.n_device_ops == 3
    assert s.device_ops[0] == ("gather", 60e-6)
    gaps = dict(s.idle_gaps)
    # 0..10 under aten::index's launch; 60..100 mostly under the sync;
    # 100..120, 130..150 and the third call under no op; 150..500 is no
    # call's
    assert abs(gaps["cudaStreamSynchronize"] - 40e-6) < 1e-12
    assert abs(gaps["cudaLaunchKernel"] - 10e-6) < 1e-12
    assert abs(gaps[devtrace.NO_OP] - 60e-6) < 1e-12
    assert devtrace.reduce([ev("kernel", "k", 0, 1)]) is None
