"""The metric arithmetic on hand-made samples, and the kernels' bytes and
operations against PERF.md's table (NVIDIA H100: 3.35 TB/s, 989 TFLOP/s bf16)."""

import math

import pytest

from benchmark.run import percentile
from benchmark.tracing import k2_cost, k3_cost, merged, roofline_seconds


def test_percentile():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert percentile(v, 50) == 3.0
    assert percentile(v, 0) == 1.0 and percentile(v, 100) == 5.0
    assert percentile(v, 90) == pytest.approx(4.6)
    assert percentile(list(range(1, 101)), 90) == pytest.approx(90.1)


def test_union_of_intervals():
    assert sum(e - s for s, e in merged([(0, 2), (1, 3), (5, 6)])) == 4
    assert merged([(0, 10), (2, 3)]) == [(0, 10)]
    assert merged([]) == []
    assert merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


def test_k3_bound_matches_the_table():
    # PERF.md's kernel table: (32, 16, 257, 88) bf16 -> 0.0277 ms, bytes; B=1 0.0009 ms
    b, f = k3_cost((32, 16, 257, 88), 257)
    assert roofline_seconds(b, f, "bfloat16") * 1e3 == pytest.approx(0.0277, abs=5e-5)
    assert b / 3.35e12 > f / 989e12  # bound by bytes
    b1, f1 = k3_cost((1, 16, 257, 88), 257)
    assert roofline_seconds(b1, f1, "bfloat16") * 1e3 == pytest.approx(0.0009, abs=5e-5)


def test_k2_bound_matches_the_table():
    # stage 0 (8, 256, 256, 64) -> 256 -> 64 bf16: 0.0401 ms, bytes; B=2 0.0100 ms;
    # the merge (8, 64, 64, 160) -> 320 -> 320: 0.0104 ms, operations
    b, f = k2_cost((8, 256, 256, 64), (64, 256), (256, 64))
    assert roofline_seconds(b, f, "bfloat16") * 1e3 == pytest.approx(0.0401, abs=5e-5)
    b, f = k2_cost((2, 256, 256, 64), (64, 256), (256, 64))
    assert roofline_seconds(b, f, "bfloat16") * 1e3 == pytest.approx(0.0100, abs=5e-5)
    b, f = k2_cost((8, 64, 64, 160), (160, 320), (320, 320))
    assert f / 989e12 > b / 3.35e12
    assert roofline_seconds(b, f, "bfloat16") * 1e3 == pytest.approx(0.0104, abs=5e-5)
    assert not math.isnan(b)
