"""Gate 2: vlfm_tpu_torch's episode drivers against vlfm_tpu's, closed loop,
on the CPU.

Oracle perception (the environment's cosine and target mask) and the greedy
controller, at tests/test_recycled_driver.py's small configuration, 40
steps at most. The port's ``run_episode`` on ``open_room_plan`` seeds 0-1
takes JAX's actions step for step (read through ``on_step``) and ends in
JAX's ``EpisodeResult`` (success, steps, collisions, the failure cause
equal; SPL, soft SPL and path length within 1e-6). Port only, as
tests/test_checkpoint_and_batched.py and tests/test_recycled_driver.py
hold JAX's: ``run_episodes_batched`` at B = 2 and ``run_episodes_recycled``
(4 seeds on 2 lanes) give the results of fresh single runs.
"""

import dataclasses

import numpy as np
import pytest

from tests.test_torch_step import one_torch_thread, port_config, port_spec  # noqa: F401
from vlfm_tpu.config import CameraConfig, VLFMConfig
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.runner import episode_driver as JED
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu_torch.runner import episode_driver as ED
from vlfm_tpu_torch.runner import fake_env as TENV

JCFG = VLFMConfig(camera=CameraConfig(height=96, width=128), max_frontiers=16, max_frontier_cells=256,
                  object_map_slots=8, object_map_points_per_slot=128)
JSPEC = JGrid(size=512, pixels_per_meter=20, pad=160)
CFG, SPEC = port_config(JCFG), port_spec(JSPEC)
MAX_STEPS = 40
SPL_ATOL = 1e-6


def _env(pkg, seed):
    return pkg.FakeObjectNavEnv(pkg.open_room_plan(seed=seed), pkg.EnvConfig(width=128, height=96, max_steps=48))


def _port_single(seed):
    actions = []
    result, stats = ED.run_episode(_env(TENV, seed), "greedy", SPEC, CFG, seed=seed, max_steps=MAX_STEPS,
                                   on_step=lambda env, o, info, state: actions.append(int(info.action[0])),
                                   device="cpu")
    return result, actions, stats


@pytest.fixture(scope="module")
def singles():
    """The port's fresh single runs of seeds 0-3."""
    return {s: _port_single(s) for s in range(4)}


def _assert_same_result(got, want):
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    for k in ("spl", "soft_spl", "path_length", "distance_to_goal"):
        assert abs(g.pop(k) - w.pop(k)) <= SPL_ATOL, k
    assert g == w


@pytest.mark.parametrize("seed", [0, 1])
def test_run_episode_takes_jaxs_actions_and_result(singles, seed):
    jactions = []
    jresult, _ = JED.run_episode(_env(JENV, seed), "greedy", JSPEC, JCFG, seed=seed, max_steps=MAX_STEPS,
                                 on_step=lambda env, o, info, state: jactions.append(int(info.action)))
    result, actions, stats = singles[seed]
    assert actions == jactions
    assert stats.env_steps == len(actions) == result.steps
    _assert_same_result(result, jresult)
    assert len(set(actions)) > 1  # the episode leaves the spin


def test_batched_runs_equal_single_runs(singles):
    results, stats = ED.run_episodes_batched([_env(TENV, s) for s in (0, 1)], "greedy", SPEC, CFG,
                                             max_steps=MAX_STEPS, seed=0, device="cpu")
    for s, rb in enumerate(results):
        rs = singles[s][0]
        assert (rb.success, rb.steps) == (rs.success, rs.steps)
        assert abs(rb.spl - rs.spl) < SPL_ATOL
    assert stats.env_steps == sum(r.steps for r in results)


def test_recycled_lanes_equal_fresh_runs(singles):
    recycled, stats = ED.run_episodes_recycled(lambda s: _env(TENV, s), [0, 1, 2, 3], lanes=2, pointnav="greedy",
                                               spec=SPEC, cfg=CFG, max_steps=MAX_STEPS, device="cpu")
    assert set(recycled) == {0, 1, 2, 3}
    for s, r in recycled.items():
        _assert_same_result(r, singles[s][0])
    assert stats.env_steps == sum(r.steps for r in recycled.values())


def test_step_inputs_pack_one_copy_per_step():
    """The driver's packed observations unpack to what each lane's
    environment gave: depth, pose, cosine on every channel, the target mask
    in slot 0 only when the target is visible."""
    envs = [_env(TENV, s) for s in (0, 1)]
    obs = [e.reset() for e in envs]
    while not any(ob["target_visible"] for ob in obs):  # the spin brings a target into view
        assert envs[0].steps < 12
        obs = [e.step(TENV.TURN_LEFT) for e in envs]
    o, cos, masks, valid = ED.step_inputs(obs, CFG, "cpu")
    for i, ob in enumerate(obs):
        np.testing.assert_array_equal(o.depth[i].numpy(), ob["depth"])
        np.testing.assert_array_equal(o.robot_xy[i].numpy(), ob["robot_xy"])
        assert float(o.robot_heading[i]) == np.float32(ob["heading"])
        assert (cos[i].numpy() == np.float32(ob["cosine"])).all() and cos.shape[1] == CFG.value_channels
        assert bool(valid[i, 0]) == ob["target_visible"] and not valid[i, 1:].any() and not masks[i, 1:].any()
        np.testing.assert_array_equal(masks[i, 0].numpy(), ob["target_mask"] & ob["target_visible"])
        np.testing.assert_allclose(o.tf_camera_to_episodic[i, :3, 3].numpy(),
                                   np.float32([*ob["robot_xy"], CFG.camera.camera_height]), rtol=0, atol=0)
