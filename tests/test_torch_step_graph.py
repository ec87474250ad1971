"""The fused dispatch's policy step on the CPU: the graph bookkeeping
(``runner/full_stack.StepGraphs``; a CPU state always runs eagerly), the
state written in place and returned as it was given, and the plain loops
that the sweep kernels (``csrc/sweeps.cu``) replace on the card. The card's
side is in ``tests/test_torch_cuda.py``."""

import math

import numpy as np
import pytest
import torch

from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops import bitpack as BP
from vlfm_tpu_torch.ops import flood as FL
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as ENV
from vlfm_tpu_torch.runner import packing as PK
from vlfm_tpu_torch.runner.episode_driver import observation, pack_outputs, step_keys
from vlfm_tpu_torch.runner.full_stack import FullStackPerception, StepGraphs, write_into
from vlfm_tpu_torch.utils import profiling as P

H, W, LANES = 48, 64, 2
CFG = TCONFIG.VLFMConfig(camera=TCONFIG.CameraConfig(height=H, width=W), max_frontiers=16, max_frontier_cells=256,
                         object_map_slots=8, object_map_points_per_slot=128, max_detections_per_frame=4)
SPEC = GridSpec2D(512, 20, 160)
FIELDS = ("reset", "depth", "heading", "xy", "rgb", "seeds", "steps")


def _leaves(state):
    out = []
    for v in state:
        out += _leaves(v) if isinstance(v, tuple) else [v]
    return out


@pytest.fixture(scope="module")
def stack():
    layout = PK.build_layout([("depth", "float32", (LANES, H, W)), ("rgb", "uint8", (LANES, H, W, 3)),
                              ("heading", "float32", (LANES,)), ("xy", "float32", (LANES, 2)),
                              ("seeds", "int32", (LANES,)), ("steps", "int32", (LANES,)), ("reset", "uint8", (LANES,))])
    return FullStackPerception(CFG, device="cpu"), layout


def _dispatches(n):
    """n dispatches' views of two lanes of ``open_room_plan``; lane 1 starts
    anew at dispatch 2."""
    envs = [ENV.FakeObjectNavEnv(ENV.open_room_plan(seed=s), ENV.EnvConfig(width=W, height=H)) for s in (0, 1)]
    obs = [e.reset() for e in envs]
    out = []
    for k in range(n):
        reset = (k == 0, k in (0, 2))
        if k == 2:
            obs[1] = envs[1].reset()
        out.append(dict(depth=np.stack([o["depth"] for o in obs]), rgb=np.stack([o["rgb"] for o in obs]),
                        heading=np.float32([o["heading"] for o in obs]), xy=np.stack([o["robot_xy"] for o in obs]),
                        seeds=np.int32([0, 1]), steps=np.int32([k, 0 if k == 2 else k]), reset=np.uint8(reset)))
        obs = [e.step(ENV.TURN_LEFT) for e in envs]
    return out


def _eager(perception, state, f):
    """The dispatch's work written out: perception, then the lane reset and
    ``itm.step`` (functional)."""
    f = {k: torch.as_tensor(v) for k, v in f.items()}
    cos, masks, valid = perception._perceive(f["rgb"], "toilet", (H, W))
    state = ITM.reset_lanes(state, f["reset"].to(torch.bool))
    obs = observation(f["depth"], f["xy"], f["heading"], CFG)
    action, info, state = ITM.step(state, obs, cos[:, :CFG.value_channels], masks, valid,
                                   step_keys(f["seeds"], f["steps"]), pointnav="greedy", spec=SPEC, cfg=CFG)
    return pack_outputs(action, info), state


def test_a_cpu_dispatch_runs_eagerly_returns_its_state_and_equals_the_step(stack):
    """Each packed dispatch counts ``step.eager`` and captures nothing; the
    state it returns is the object it was given, every tensor the same,
    after lane resets too; its outputs and state equal perception and the
    step called eagerly, bit for bit."""
    perception, layout = stack
    step = perception.make_fused_step("greedy", SPEC, CFG, "toilet", layout=layout)
    buf = np.zeros(layout.total, np.uint8)
    views = PK.pack_views(buf, layout)
    state = ITM.create_state(SPEC, CFG, batch=LANES, device="cpu")
    twin = ITM.create_state(SPEC, CFG, batch=LANES, device="cpu")
    given = _leaves(state)
    P.reset_counters()
    for f in _dispatches(4):
        for name in FIELDS:
            views[name][...] = f[name]
        out, back = step(state, None, torch.from_numpy(buf))
        assert back is state and all(a is b for a, b in zip(_leaves(back), given))
        want, twin = _eager(perception, twin, f)
        assert torch.equal(out, want)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(state), _leaves(twin)))
    counted = P.counters()
    assert counted["step.eager"] == 4
    assert "step.graph_captures" not in counted and "step.graph_replays" not in counted
    assert int(state.steps[1]) == 2  # lane 1 started anew at the third dispatch


def test_the_unpacked_dispatch_returns_its_state_too(stack):
    perception, _ = stack
    step = perception.make_fused_step("greedy", SPEC, CFG, "toilet")
    state = ITM.create_state(SPEC, CFG, batch=LANES, device="cpu")
    given = _leaves(state)
    for f in _dispatches(3):
        action, detected, goal, back = step(state, None, *(f[n] for n in FIELDS))
        assert back is state and all(a is b for a, b in zip(_leaves(back), given))
        assert action.shape == (LANES,) and detected.shape == (LANES,) and goal.shape == (LANES, 2)
    assert state.steps.tolist() == [3, 1] and bool(state.obstacle.explored.any())


def test_step_graphs_run_a_cpu_state_eagerly_each_call():
    calls = []

    def run(state, inputs):
        calls.append(inputs)
        return (inputs[0] + 1,)

    graphs = StepGraphs(run)
    state = (torch.zeros(2),)
    P.reset_counters()
    for k in range(3):
        assert torch.equal(graphs(state, (torch.full((2,), float(k)),))[0], torch.full((2,), k + 1.0))
    assert len(calls) == 3 and graphs.graphs == [] and P.counters() == {"step.eager": 3}


def test_write_into_copies_the_new_tensors_and_reads_before_it_writes():
    a, b, c = torch.arange(4.0), torch.arange(4.0) + 10, torch.zeros(3, dtype=torch.int32)
    state = ((a, b), c)
    new_c = torch.tensor([7, 8, 9], dtype=torch.int32)
    new = ((b, a[:4]), new_c)  # a's new value is b; b's is a view of a, which is written first
    write_into(state, new)
    assert a.tolist() == [10.0, 11.0, 12.0, 13.0] and b.tolist() == [0.0, 1.0, 2.0, 3.0]
    assert c.tolist() == [7, 8, 9] and state[1] is c
    same = torch.ones(2)
    write_into((same,), (same,))  # the same tensor: nothing to copy
    assert same.tolist() == [1.0, 1.0]


@pytest.mark.parametrize("max_iters,check,want", [(1024, 16, 1024), (48, 4, 48), (40, 8, 40), (50, 16, 64),
                                                  (1, 4, 4), (0, 16, 0), (-3, 16, 0)])
def test_sweep_cap_is_max_iters_rounded_up_to_a_whole_check(max_iters, check, want):
    assert FL.sweep_cap(max_iters, check) == want


@pytest.mark.parametrize("rows,row_bytes,buffers,want", [
    (1344, 4 * 42, 3, (168, 16 + 168 * 168 * 3)),  # the obstacle map's flood
    (336, 4 * 336, 2, (42, 16 + 42 * 1344 * 2)),   # the frontier labelling's coarse grid
    (8, 4, 3, (1, 28)),
    (3, 4, 3, (1, 28)),                            # fewer rows than CTAs: some hold none
])
def test_sweep_plan_gives_each_of_8_ctas_a_band(rows, row_bytes, buffers, want):
    assert FL.sweep_plan(rows, row_bytes, buffers) == want
    assert want[1] <= FL.SMEM_LIMIT


def test_sweep_plan_refuses_a_lane_too_large_for_8_ctas():
    with pytest.raises(ValueError, match="does not fit"):
        FL.sweep_plan(2368, 4 * 592, 2)  # the labelling of a 2048 px map


def test_the_sweep_wrappers_check_their_arguments_before_any_launch():
    m = torch.zeros((1, 8, 32), dtype=torch.bool)
    with pytest.raises(ValueError, match="differ"):
        FL.flood_cuda(m, m[:, :4], 16, wrap=True)
    with pytest.raises(TypeError):
        FL.flood_cuda(m.to(torch.int64), m.to(torch.int64), 16, wrap=True)
    with pytest.raises(TypeError):
        FL.label_cuda(m.to(torch.uint8), 8)
    with pytest.raises(ValueError, match="past int32"):
        FL.label_cuda(torch.zeros((1, 1, 1), dtype=torch.bool).expand(1, 65536, 32768), 8)


@pytest.mark.parametrize("cols", [64, 77])
def test_the_cpu_path_is_the_plain_loop_with_its_count(cols):
    """On the CPU the routed functions are the plain loops: the same bits
    and the same ``map.sweeps`` (a whole check at a time, all lanes)."""
    rng = np.random.default_rng(cols)
    mask = torch.from_numpy(rng.random((3, 40, cols)) < 0.7)
    seed = torch.zeros_like(mask)
    seed[:, 20, 10] = True
    runs = []
    for fn in (FL.flood_from_seed, FL.flood_from_seed_ref):
        P.reset_counters()
        runs.append((fn(mask, seed, 64), P.counters()["map.sweeps"]))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1] and runs[0][1] % 16 == 0
    labels = []
    for fn in (FL.label_components, FL.label_components_ref):
        P.reset_counters()
        labels.append((fn(mask, 12), P.counters()["map.sweeps"]))
    assert torch.equal(labels[0][0], labels[1][0]) and labels[0][1] == labels[1][1] <= 12
    if cols % 32 == 0:
        mp, sp = BP.pack_cols(mask), BP.pack_cols(seed)
        P.reset_counters()
        assert torch.equal(BP.unpack_cols(BP.flood_packed(mp, sp, 64), cols), runs[0][0])
        assert P.counters()["map.sweeps"] == runs[0][1]


def test_threefry_constants_are_fills_with_the_uploads_bits():
    """``uniform``'s bounds and the erf_inv coefficients are fills now (a
    graph captures a fill, not a pageable upload), each the f32 that
    ``torch.tensor`` rounds to."""
    for x in (0.0, -2.5, 3.7, 1 / 3, math.sqrt(2.0), *threefry._ERFINV_LT5, *threefry._ERFINV_GE5):
        assert threefry._f32(x, "cpu").view(torch.int32) == torch.tensor(x, dtype=torch.float32).view(torch.int32)
