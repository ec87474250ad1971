"""On the card: a short run of each cell prints a correct result, and a
checkout holding only the benchmark's files fails without printing one.

    python -m pytest benchmark/tests/test_bench_card.py -m cuda -q
"""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.run import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _run(cwd, cell: str, seconds: str = "3"):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed", "2147483999",
                           "--seconds", seconds, "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=1200)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_short_run_is_correct(cell):
    _card()
    p = _run(ROOT, cell)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result


@pytest.mark.cuda
def test_the_benchmark_alone_fails(tmp_path):
    _card()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in BENCH["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path, ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path, BENCH["workloads"][0]["name"], "1")
    assert p.returncode != 0 and not p.stdout.strip()
