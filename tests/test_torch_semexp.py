"""vlfm_tpu_torch's SemExp/Gibson harness over the fake vec env, on the CPU:
the cases of tests/test_semexp.py on the port.

Parity target: vlfm/semexp_env/eval.py (loop semantics, observation
merging, V2/V3 selection through EXPLORATION_THRESH, the already-evaluated
fast-forward, named videos), as ``vlfm_tpu/adapters/semexp.py`` has it.
The observation merge and the fake vec env's stacks and infos are held to
JAX's bit for bit; the loop runs the port's agent (``HabitatVLFMAgent`` at
B = 1 on the CPU) with the red-pixel perception of tests/test_semexp.py.
"""

import os

import numpy as np
import pytest

from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.adapters import semexp as JS
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu_torch.adapters.semexp import FakeSemExpVecEnv, SemExpVLFMAgent, evaluate_semexp, merge_obs_infos
from vlfm_tpu_torch.config import CameraConfig, VLFMConfig
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.runner import log_saver

CFG = VLFMConfig(camera=CameraConfig(height=96, width=128),
                 max_frontiers=16, max_frontier_cells=256,
                 object_map_slots=8, object_map_points_per_slot=128)
SPEC = GridSpec2D(size=512, pixels_per_meter=20, pad=160)


def red_pixel_perceive(rgb, target):
    mask = np.all(rgb == np.array([220, 40, 40], np.uint8), axis=-1)
    k = CFG.max_detections_per_frame
    masks = np.zeros((k, *rgb.shape[:2]), bool)
    valid = np.zeros(k, bool)
    if mask.sum() > 40:
        masks[0] = mask
        valid[0] = True
    cos = np.full(CFG.value_channels, 0.9 if valid[0] else 0.3, np.float32)
    return cos, masks, valid


def make_envs(n, fe=TENV, vec=FakeSemExpVecEnv):
    """``n`` open-room episodes at 128x96, 60 steps, behind ``vec`` (the
    port's or JAX's vec env over ``fe``, the port's or JAX's fake env)."""
    return vec(lambda i: fe.FakeObjectNavEnv(fe.open_room_plan(seed=i),
                                             fe.EnvConfig(width=128, height=96, max_steps=60)), n)


def agent(**kw):
    return SemExpVLFMAgent(CFG, SPEC, "greedy", red_pixel_perceive, device="cpu", **kw)


def test_merge_obs_infos_layout():
    obs = np.zeros((1, 4, 8, 10), np.float32)
    obs[0, 0] = 7  # red channel
    obs[0, 3] = 0.5  # depth
    infos = ({"goal_name": "potted-plant", "gps": [1, 2], "compass": [0.1], "heading": [0.1]},)
    d = merge_obs_infos(obs, infos)
    assert d["rgb"].shape == (8, 10, 3) and d["rgb"][0, 0, 0] == 7
    assert d["depth"].shape == (8, 10) and d["depth"][0, 0] == 0.5
    assert d["objectgoal"] == "potted plant"  # '-' -> ' ' (eval.py:141)
    want = JS.merge_obs_infos(obs, infos)
    assert d.keys() == want.keys()
    for k in d:
        np.testing.assert_array_equal(d[k], want[k])


def test_fake_vec_env_matches_jax():
    """The port's and JAX's vec envs give the same stacks and infos over a
    scripted walk through an episode's end and the auto-reset."""
    envs, jenvs = make_envs(2), make_envs(2, JENV, JS.FakeSemExpVecEnv)
    (o, i), (jo, ji) = envs.reset(), jenvs.reset()
    for action in [1, 1, 2, 1, 3, 1, 1, 0, 1, 1]:
        np.testing.assert_array_equal(o, jo)
        assert i[0].keys() == ji[0].keys()
        for k in i[0]:
            np.testing.assert_array_equal(i[0][k], ji[0][k])
        o, _, done, i = envs.step(action)
        jo, _, jdone, ji = jenvs.step(action)
        assert done == jdone


def test_exploration_thresh_selects_v3(monkeypatch):
    monkeypatch.setenv("EXPLORATION_THRESH", "0.5")
    a = agent()
    assert a.version == "v3"
    assert a.cfg.exploration_thresh == 0.5
    assert "|" in a.cfg.text_prompt  # dual-channel prompt
    monkeypatch.delenv("EXPLORATION_THRESH")
    assert agent().version == "v2"


def test_eval_loop_logs_and_videos(tmp_path):
    log_dir = str(tmp_path / "logs")
    video_dir = str(tmp_path / "videos")
    results = evaluate_semexp(make_envs(2), agent(), 2, max_episode_length=60, log_dir=log_dir,
                              video_dir=video_dir, print_fn=lambda s: None)
    assert len(results) == 2
    assert any(r["success"] for r in results)
    assert len(os.listdir(log_dir)) == 2
    vids = os.listdir(video_dir)
    assert len(vids) == 2
    assert all(v.startswith("epid=") and v.endswith(".mp4") for v in vids)
    # the reference's file name schema carries success/spl/target (eval.py:188-195)
    assert any("-succ=1-" in v for v in vids)


def test_already_evaluated_fast_forward(tmp_path):
    log_dir = str(tmp_path / "logs")
    log_saver.log_episode("0", "fake_scene", {"success": 1.0}, log_dir)
    results = evaluate_semexp(make_envs(2), agent(), 2, max_episode_length=60, log_dir=log_dir,
                              print_fn=lambda s: None)
    # episode 0 was fast-forwarded with a STOP and not logged again, and its
    # 1-step metrics stay out of the results (another shard owns it)
    assert len(results) == 1
    assert results[0]["episode_id"] == "1"
    assert len(os.listdir(log_dir)) == 2  # the record that was there + episode 1
