"""vlfm_tpu_torch's Habitat adapter, evaluation loop and entry points
against vlfm_tpu's, on the CPU.

At tests/test_imitation.py's small shapes (a 48x64 camera, a 512 px map,
16 frontiers, 8 object slots), with a 3-turn spin so that episodes of at
most 12 steps leave INITIALIZE. Perception is the red-pixel stub of
tests/test_habitat_env.py. Held:

- ``goal_name``, ``filter_depth`` and ``HabitatObsAdapter.observation``
  (one lane of the port's batch-first ``Observation``);
- ``FakeHabitatEnv``'s observations and metrics, bit for bit, over a
  scripted walk;
- ``habitat_target_seen`` / ``habitat_false_positive`` on the mock's
  top-down maps, and ``HabitatEnvWrapper`` / ``make_habitat_env`` under
  ``tests/mock_habitat.py`` (adapted observations, bookkeeping, metrics,
  ``advance`` order, action names);
- ``HabitatVLFMAgent``: JAX's actions and goals (GOAL_ATOL) over an
  episode, with the key stream ``PRNGKey(0)`` then one split per act;
  on ``open_room_plan`` seeds 1 and 2 (EPISODE_SEEDS). Seeds 0 and 3-7
  meet, at step 7, two frontier cells at exactly the same distance from
  their segment's centroid (1.3265306 px^2 in f64): the port takes the
  first, as exact arithmetic does, and XLA's f32 rounding the other, on
  bit-equal maps (ROADMAP Queue 3);
- ``evaluate``: the same results and byte-equal log files, the port's
  video one frame short of its steps (the one-step delay);
- ``python -m vlfm_tpu_torch.run --backend synthetic --cpu`` prints JAX's
  aggregate, ``--backend habitat --cpu`` finishes an episode on the mock,
  and ``runner.demo --cpu`` prints JAX's episode line and aggregate.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import mock_habitat
from tests.test_torch_step import one_torch_thread, port_config  # noqa: F401
from vlfm_tpu import run as JRUN
from vlfm_tpu.adapters import habitat as JH
from vlfm_tpu.config import CameraConfig, VLFMConfig
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.runner import demo as JDEMO
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu.runner import habitat_eval as JEVAL
from vlfm_tpu_torch import run as RUN
from vlfm_tpu_torch.adapters import habitat as H
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.runner import demo as DEMO
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.runner import habitat_eval as EVAL

JCFG = VLFMConfig(camera=CameraConfig(height=48, width=64), map_size=512,
                  max_frontiers=16, max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128,
                  num_init_turns=3)
CFG = port_config(JCFG)
JSPEC = JGrid(JCFG.map_size, JCFG.pixels_per_meter, JCFG.map_pad)
SPEC = GridSpec2D(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
MAX_STEPS = 12
EPISODE_SEEDS = (1, 2)  # open_room_plan seeds without a frontier tie in 12 steps (see above)
GOAL_ATOL = 1e-6  # metres, as tests/test_torch_step.py
SPL_ATOL = 1e-6
# run.py's --config: JCFG's fields, so JAX compiles its step once here
CONFIG = {"camera": {"height": 48, "width": 64}, "map_size": 512,
          "max_frontiers": 16, "max_frontier_cells": 256, "object_map_slots": 8,
          "object_map_points_per_slot": 128, "num_init_turns": 3}


def red_pixel_perceive(rgb, target):
    """tests/test_habitat_env.py's stub: the target is painted (220, 40, 40)."""
    mask = np.all(rgb == np.array([220, 40, 40], np.uint8), axis=-1)
    k = CFG.max_detections_per_frame
    masks = np.zeros((k, *rgb.shape[:2]), bool)
    valid = np.zeros(k, bool)
    if mask.sum() > 40:
        masks[0] = mask
        valid[0] = True
    cos = np.full(CFG.value_channels, 0.9 if valid[0] else 0.3, np.float32)
    return cos, masks, valid


def _fake(pkg, ev, seed, max_steps=MAX_STEPS):
    env = pkg.FakeObjectNavEnv(pkg.open_room_plan(seed=seed), pkg.EnvConfig(width=64, height=48,
                                                                            max_steps=max_steps))
    return ev.FakeHabitatEnv(env, episode_id=str(seed), object_category="toilet")


def _agents():
    return (H.HabitatVLFMAgent(CFG, SPEC, "greedy", red_pixel_perceive, device="cpu"),
            JH.HabitatVLFMAgent(JCFG, JSPEC, "greedy", red_pixel_perceive))


@pytest.fixture()
def habitat_mock():
    mod = mock_habitat.install()
    yield mod
    mock_habitat.uninstall()


def _assert_obs_equal(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_goal_names_and_filter_depth_match_jax():
    for dataset, n in (("hm3d", 6), ("mp3d", 21)):
        assert [H.goal_name(i, dataset) for i in range(n)] == [JH.goal_name(i, dataset) for i in range(n)]
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.1, 1.0, (48, 64)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    depth[:, 5] = 0.0  # a whole column of holes falls back to 1.0
    got = H.filter_depth(depth)
    np.testing.assert_array_equal(got, JH.filter_depth(depth))
    assert not (got == 0).any()
    clean = depth + 0.5
    assert H.filter_depth(clean) is clean


def test_obs_adapter_matches_jax():
    port, ref = H.HabitatObsAdapter(CFG, device="cpu"), JH.HabitatObsAdapter(JCFG)
    env = _fake(JENV, JEVAL, 0)
    obs = env.reset()
    for a in (2, 1, 1, 3, 1):
        obs = env.step(a)
    obs["depth"][3:7, 10:12] = 0.0
    got, want = port.observation(obs), ref.observation(obs)
    np.testing.assert_array_equal(got.depth[0].numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.tf_camera_to_episodic[0].numpy(), np.asarray(want.tf_camera_to_episodic))
    np.testing.assert_array_equal(got.robot_xy[0].numpy(), np.asarray(want.robot_xy))
    assert float(got.robot_heading[0]) == float(want.robot_heading)
    assert got.depth.shape == (1, 48, 64) and got.tf_camera_to_episodic.shape == (1, 4, 4)
    assert port.target_object(obs) == ref.target_object(obs) == "toilet"
    for dataset in ("hm3d", "mp3d"):
        assert H.HabitatObsAdapter(CFG, dataset).non_coco_caption == JH.HabitatObsAdapter(JCFG, dataset).non_coco_caption


def test_fake_habitat_env_matches_jax():
    port, ref = _fake(TENV, EVAL, 2, max_steps=30), _fake(JENV, JEVAL, 2, max_steps=30)
    assert port.current_episode == EVAL.FakeEpisode(**dataclasses.asdict(ref.current_episode))
    _assert_obs_equal(port.reset(), ref.reset())
    for a in [2] * 4 + [1] * 10 + [3] * 2 + [1] * 6 + [0]:
        _assert_obs_equal(port.step(a), ref.step(a))
        assert port.episode_over == ref.episode_over
        assert port.get_metrics() == ref.get_metrics()
    assert port.episode_over


def test_habitat_taxonomy_helpers_match_jax(habitat_mock):
    env = JEVAL.make_habitat_env().advance()
    env.reset()
    for a in [1] * 6 + [2] * 3 + [1] * 6:
        env.step(a)
    tdm = env._env.get_metrics()["top_down_map"]
    target = np.asarray(env._env._env.plan.target)
    assert EVAL.habitat_target_seen(tdm) == JEVAL.habitat_target_seen(tdm)
    for k in (0, 3, 5, 9):
        np.testing.assert_array_equal(EVAL._dilate_bool(tdm["target_bboxes_mask"], k),
                                      JEVAL._dilate_bool(tdm["target_bboxes_mask"], k))
    for goal in (target, target + 3.0, target + np.array([0.2, -0.3]), np.array([1e6, 1e6])):
        assert EVAL.habitat_false_positive(tdm, goal) == JEVAL.habitat_false_positive(tdm, goal)
    assert EVAL.habitat_false_positive({}, target) is None
    assert EVAL.habitat_target_seen({}) is False


def test_import_is_the_only_failure_without_habitat():
    assert "habitat" not in sys.modules
    with pytest.raises(ModuleNotFoundError, match="habitat"):
        EVAL.make_habitat_env()


@pytest.mark.parametrize("names", [False, True], ids=["ids", "action-names"])
def test_habitat_env_wrapper_matches_jax(habitat_mock, names):
    port = EVAL.make_habitat_env("my/config.yaml", overrides=("a=b",), pass_action_names=names)
    ref = JEVAL.make_habitat_env("my/config.yaml", overrides=("a=b",), pass_action_names=names)
    assert (port._radius, port._max_steps) == (ref._radius, ref._max_steps)
    assert "semantic_sensor" not in port._env.config.habitat.simulator.agents.main_agent.sim_sensors
    for episode in range(2):
        port.advance(), ref.advance()
        assert dataclasses.asdict(port.current_episode) == dataclasses.asdict(ref.current_episode)
        assert port.current_episode.episode_id == str(episode)
        _assert_obs_equal(port.reset(), ref.reset())
        for a in (1, 2, 1, 1, 3, 0):
            _assert_obs_equal(port.step(a), ref.step(a))
            assert port.get_metrics() == ref.get_metrics()
            assert port.episode_over == ref.episode_over
        assert port._env.step_action_types == ref._env.step_action_types
        goal = np.asarray(port._env._env.plan.target)
        assert port.false_positive(goal) == ref.false_positive(goal)


def test_agent_takes_jaxs_actions_and_goals():
    port_env, ref_env = _fake(TENV, EVAL, EPISODE_SEEDS[0]), _fake(JENV, JEVAL, EPISODE_SEEDS[0])
    port, ref = _agents()
    o, jo = port_env.reset(), ref_env.reset()
    port.reset(), ref.reset()
    actions = []
    while not ref_env.episode_over:
        a, ja = port.act(o), ref.act(jo)
        assert a == ja
        np.testing.assert_allclose(port.last_info.goal[0].numpy(), np.asarray(ref.last_info.goal), atol=GOAL_ATOL)
        assert bool(port.last_info.target_detected[0]) == bool(ref.last_info.target_detected)
        assert int(port.last_info.mode[0]) == int(ref.last_info.mode)
        actions.append(a)
        o, jo = port_env.step(a), ref_env.step(ja)
    assert port_env.episode_over and len(actions) == MAX_STEPS
    assert actions[:3] == [2, 2, 2] and len(set(actions)) > 1  # the spin, then moves
    assert [int(w) for w in port._rng.tolist()] == [int(w) for w in np.asarray(ref._rng)]


def _results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for k in ("spl", "soft_spl", "path_length", "distance_to_goal"):
            assert abs(g.pop(k) - w.pop(k)) <= SPL_ATOL, k
        assert g == w


def test_evaluate_results_and_logs_match_jax(tmp_path):
    port, ref = _agents()
    lines, jlines = [], []
    got = EVAL.evaluate(lambda i: _fake(TENV, EVAL, EPISODE_SEEDS[i]), port, 2, log_dir=str(tmp_path / "port"),
                        video_dir=str(tmp_path / "video"), print_fn=lines.append)
    want = JEVAL.evaluate(lambda i: _fake(JENV, JEVAL, EPISODE_SEEDS[i]), ref, 2, log_dir=str(tmp_path / "jax"),
                          print_fn=jlines.append)
    _results_equal(got, want)
    assert lines == jlines
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) and len(files) == 2
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    import cv2

    videos = sorted(os.listdir(tmp_path / "video"))
    assert len(videos) == 2
    for name, r in zip(videos, got):
        cap = cv2.VideoCapture(str(tmp_path / "video" / name))
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        assert n == r.steps - 1  # the one-step-delay realignment drops the trailing frame


def _run_main(main, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", argv)
    main()
    return capsys.readouterr().out


def _aggregate(out):
    return json.loads(out[out.index("{"):])


def test_run_py_synthetic_prints_jaxs_aggregate(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(CONFIG))
    args = ["--backend", "synthetic", "--cpu", "--episodes", "1", "--max-steps", "10", "--config", str(cfg),
            "--log-dir", "LOGS"]
    got = _run_main(RUN.main, ["run"] + [str(tmp_path / "port") if a == "LOGS" else a for a in args],
                    monkeypatch, capsys)
    want = _run_main(JRUN.main, ["run"] + [str(tmp_path / "jax") if a == "LOGS" else a for a in args],
                     monkeypatch, capsys)
    assert _aggregate(got) == _aggregate(want)
    assert _aggregate(got)["episodes"] == 1 and _aggregate(got)["avg_steps"] == 10
    assert got.split(" (")[0] == want.split(" (")[0]  # the episode line, but its rate
    name = "0_two_room.json"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_run_py_habitat_backend_on_the_mock(habitat_mock, tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({**CONFIG, "camera": {"height": 96, "width": 128}}))
    out = _run_main(RUN.main, ["run", "--backend", "habitat", "--episodes", "1", "--config", str(cfg), "--cpu",
                               "--log-dir", str(tmp_path / "logs")], monkeypatch, capsys)
    agg = _aggregate(out)
    assert agg["episodes"] == 1 and agg["avg_steps"] > 0
    assert "running_success=" in out
    logged = json.loads((tmp_path / "logs" / "0_mock_scene.json").read_text())
    assert logged["target_object"] == "toilet" and logged["episode_id"] == "0"


def test_run_py_refuses_what_it_does_not_have(monkeypatch):
    for extra in (["--weights-dir", "bundle"], ["--backend", "reality"]):
        monkeypatch.setattr(sys, "argv", ["run", "--cpu"] + extra)
        with pytest.raises(SystemExit, match="vlfm_tpu"):
            RUN.main()


def test_run_py_loads_the_reference_pointnav_checkpoint(tmp_path):
    """An upstream-layout .pth (a ``state_dict`` wrapper, a critic the
    network does not have) loads as it is."""
    src = PN.PointNavPolicy.init_random(3, depth_shape=(48, 64), device="cpu")
    sd = {k: v.clone() for k, v in src.module.state_dict().items()}
    torch.save({"state_dict": {**sd, "critic.fc.weight": torch.zeros(1, 512)}}, tmp_path / "pointnav.pth")
    got = RUN.load_pointnav_weights(str(tmp_path / "pointnav.pth"), (48, 64), "cpu")
    for k, v in got.module.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_demo_prints_jaxs_episode_and_aggregate(monkeypatch, capsys):
    args = ["demo", "--cpu", "--episodes", "1", "--max-steps", "8", "--image-height", "48", "--image-width", "64"]
    got = _run_main(DEMO.main, args, monkeypatch, capsys)
    want = _run_main(JDEMO.main, args, monkeypatch, capsys)
    assert _aggregate(got) == _aggregate(want)
    assert got.split(" (")[0] == want.split(" (")[0]
    assert got.startswith("episode 0: ") and _aggregate(got)["avg_steps"] == 8
