"""The run's check that nothing of JAX or the JAX package is loaded."""

import ast
import json
from pathlib import Path

import pytest

from benchmark.run import HERE, Cell, forbidden_modules, run_cell


def test_top_level_names_compared_whole():
    assert forbidden_modules(["vlfm_tpu_torch", "vlfm_tpu_torch.ops.attention", "torch", "jaxtyping"]) == []
    assert forbidden_modules(["vlfm_tpu.x", "vlfm_tpu_torch"]) == ["vlfm_tpu.x"]
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib", "flax.linen"]) == ["flax.linen", "jax", "jax.numpy",
                                                                               "jaxlib"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert forbidden_modules(_imports(path)) == [], path


def test_reference_and_yardstick_import_nothing_of_the_port():
    """The plain reference, the weights, the traffic and the frozen copy
    never import the port (``vlfm_tpu_torch``)."""
    files = [HERE / f for f in ("reference.py", "stack.py", "weights.py", "traffic.py")]
    files += list((HERE / "frozen").rglob("*.py"))
    for path in files:
        bad = [m for m in _imports(path) if m.split(".")[0] == "vlfm_tpu_torch"]
        assert bad == [], (path, bad)
    assert len(files) > 50


def test_the_reference_runs_without_the_port():
    """Building and running the reference loads no module of the port."""
    import subprocess
    import sys

    code = (
        "import json, sys, torch\n"
        "from benchmark.tests.tiny import DATA\n"
        "from benchmark.reference import DispatchReference\n"
        "cfg = json.loads((DATA / 'tiny-hm3d.json').read_text())\n"
        "ref = DispatchReference(cfg, 3, 'cpu', 1)\n"
        "ref.cosines(torch.zeros(1, 48, 64, 3, dtype=torch.uint8))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('vlfm_tpu_torch', 'vlfm_tpu', 'jax')]\n"
        "assert not bad, bad\n"
    )
    root = HERE.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300,
                   env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})


LOADS_JAX_IN_CHECK = '''
import sys
import time
import types


class Driver:
    attempted = failed = 0

    def __init__(self, cell, seed, device):
        pass

    def decide(self):
        a = time.perf_counter()
        self.attempted += 1
        return 1, (a, time.perf_counter())

    def close_program(self):
        pass

    def check(self):
        sys.modules["jax"] = types.ModuleType("jax")  # as a reference that pulled JAX in would
        return {"answers_off": (0.0, 0.0)}
'''


def test_a_module_of_jax_loaded_by_the_check_fails_the_run(tmp_path, monkeypatch):
    """The look at ``sys.modules`` comes after the check, so it sees what
    building and running the reference loaded."""
    import sys

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    here = tmp_path / "benchmark"
    for d in ("configs", "workloads", "drivers", "metrics"):
        (here / d).mkdir(parents=True)
    (here / "configs" / "cfg-x.json").write_text(json.dumps({"name": "cfg-x"}))
    (here / "workloads" / "mix-x.json").write_text(json.dumps({"driver": "drv_jax"}))
    (here / "drivers" / "drv_jax.py").write_text(LOADS_JAX_IN_CHECK)
    (here / "metrics" / "setup_s.py").write_text("def read(ctx):\n    return ctx.setup_s\n")
    bench = {"configs": [{"name": "cfg-x", "file": "benchmark/configs/cfg-x.json"}],
             "workloads": [{"name": "cell-x", "config": "cfg-x", "traffic": "mix-x", "chips": 1}],
             "end_to_end": [{"name": "setup_s", "unit": "s"}], "per_layer": []}
    cell = Cell(bench, "cell-x", root=tmp_path, here=here)
    try:
        with pytest.raises(RuntimeError, match="jax"):
            run_cell(cell, seed=1, seconds=0.05, trace=False, device="cpu")
    finally:
        sys.modules.pop("jax", None)
