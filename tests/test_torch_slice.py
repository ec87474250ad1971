"""The port's slice end to end against vlfm_tpu, at tiny size on the CPU.

chip_smoke.py's main path, in both packages, each with its own config,
tokenizer and synthetic environment: a 12-view spin of the environment,
BLIP2-ITM cosines for the default prompt, and per view the obstacle-map
update with its frontiers and the fusion into the value map (the map half
of vlfm_tpu/policy/itm.py:step, with its full-prune cadence); then V2
values of the frontiers, the frontier choice and the greedy rho-theta
controller (vlfm_tpu/policy/itm.py:253-261). The port runs it all through
its ``step``, the last view being its first EXPLORE step. Held: cosines to 1e-4, the
value map to 1e-5 and the obstacle grids cell for cell (but for cone-edge
cells on an ulp tie, at most 0.1 % of the cells updated), the frontiers
(their validity exactly, their position to 1e-6 m), waypoint values to
1e-4, and the same chosen frontier and action; also with
``sync_explored_areas``, which cuts the value map to the explored area.
The port runs the spin as one lane (B = 1) of its batch-first API.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.config import CameraConfig, VLFMConfig
from vlfm_tpu.mapping import obstacle_map as JOM
from vlfm_tpu.mapping import value_map as JVM
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu.parallel.engine import PerceptionEngine as JEngine
from vlfm_tpu.policy import acyclic as JAC
from vlfm_tpu.policy import itm as JITM
from vlfm_tpu.policy.frontier_selection import select_best_frontier as jax_select
from vlfm_tpu.runner.fake_env import EnvConfig, FakeObjectNavEnv, two_room_plan
from vlfm_tpu.utils import geometry as JG
from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import tokenizer as TTOK
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from vlfm_tpu_torch.ops import threefry as T
from vlfm_tpu_torch.parallel.engine import PerceptionEngine
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.utils import geometry as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = VLFMConfig(map_size=512, camera=CameraConfig(width=160, height=120))
TCFG = TCONFIG.VLFMConfig(map_size=512, camera=TCONFIG.CameraConfig(width=160, height=120))
SPEC = GridSpec2D(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
JSPEC = JGrid(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
TARGET = "chair"
HIGH_VIEW = 7
MAP_ATOL = 1e-5
EDGE_FLIP_FRACTION = 1e-3


def _spin(env):
    return [env.reset()] + [env.step(ITM.TURN_LEFT) for _ in range(11)]


@pytest.fixture(scope="module")
def views():
    """The same spin from each package's environment: (JAX's, the port's)."""
    cam = CFG.camera
    jenv = FakeObjectNavEnv(two_room_plan(seed=0), EnvConfig(width=cam.width, height=cam.height))
    tenv = TENV.FakeObjectNavEnv(TENV.two_room_plan(seed=0),
                                 TENV.EnvConfig(width=cam.width, height=cam.height))
    return _spin(jenv), _spin(tenv)


@pytest.fixture(scope="module")
def engines():
    """Tiny BLIP2-ITM, f32 compute, with JAX's weights in both packages."""
    jcfg = dataclasses.replace(JB.BLIP2ITMConfig.tiny(), compute_dtype=jnp.float32)
    s = jcfg.vit.image_size
    params = jax.jit(JB.BLIP2ITMModule(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, 4), jnp.int32),
        jnp.ones((1, 4), bool))["params"]
    tcfg = dataclasses.replace(BLIP2ITMConfig.tiny(), compute_dtype=torch.float32)
    titm = BLIP2ITM.from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return (JEngine(JB.BLIP2ITM(jcfg, params), WordPieceTokenizer(toy_vocab()),
                    text_prompt=CFG.text_prompt),
            PerceptionEngine(titm, TTOK.WordPieceTokenizer(TTOK.toy_vocab()), TCFG.text_prompt))


def _robot(views):
    return np.float32(views[-1]["robot_xy"]), np.float32(views[-1]["heading"])


def run_jax(views, cosines, sync_explored=False):
    cam = CFG.camera
    obstacle = JOM.create(JSPEC, CFG.max_frontiers)
    state = JVM.create(JSPEC, CFG.value_channels)
    for steps, (o, c) in enumerate(zip(views, cosines)):
        xyz = jnp.array([o["robot_xy"][0], o["robot_xy"][1], cam.camera_height], jnp.float32)
        tf = JG.xyz_yaw_to_tf_matrix(xyz, jnp.float32(o["heading"]))
        depth = jnp.asarray(o["depth"], jnp.float32)
        obstacle = JOM.update(  # vlfm_tpu/policy/itm.py:124-140
            obstacle, JSPEC, depth, tf, cam.min_depth, cam.max_depth, cam.fx, cam.fy, cam.hfov,
            min_height=CFG.min_obstacle_height, max_height=CFG.max_obstacle_height,
            area_thresh_m2=CFG.obstacle_map_area_threshold, full_prune=(steps % 8) == 0,
            agent_radius=CFG.agent_radius, max_frontier_cells=CFG.max_frontier_cells,
            max_frontiers=CFG.max_frontiers)
        state = JVM.update(state, JSPEC, c, depth, tf, cam.min_depth, cam.max_depth, cam.hfov,
                           use_max_confidence=CFG.use_max_confidence,
                           fusion_type=JVM.FUSION_DEFAULT,
                           explored=obstacle.explored if sync_explored else None)  # itm.py:157
    robot, heading = _robot(views)
    fxy, valid = obstacle.frontiers_xy, obstacle.frontiers_valid
    wv = JVM.waypoint_values(state, JSPEC, fxy, valid, radius_px=int(0.5 * JSPEC.pixels_per_meter))
    choice = jax_select(fxy, valid, wv[:, 0], jnp.asarray(robot), jnp.zeros(2),
                        jnp.float32(-jnp.inf), JAC.create())
    rho, theta = JG.rho_theta(jnp.asarray(robot), jnp.float32(heading), choice.frontier)
    half_turn = jnp.deg2rad(15.0)  # vlfm_tpu/policy/itm.py:256-261
    action = jnp.where(theta > half_turn, JITM.TURN_LEFT,
                       jnp.where(theta < -half_turn, JITM.TURN_RIGHT, JITM.MOVE_FORWARD))
    action = jnp.where(choice.any_valid, action, JITM.STOP)
    return obstacle, state, wv, choice, (float(rho), float(theta)), int(action)


def run_torch(views, cosines, sync_explored=False):
    """The spin through the port's ``step`` (one lane, greedy controller,
    no detections), with the spin's last view its first EXPLORE step: that
    step's decision is the frontier choice and greedy action over the maps
    after all 12 views, from a fresh choice history."""
    cfg = dataclasses.replace(TCFG, sync_explored_areas=sync_explored, num_init_turns=len(views) - 1)
    state = ITM.create_state(SPEC, cfg, device="cpu")
    k = cfg.max_detections_per_frame
    masks = torch.zeros((1, k, cfg.camera.height, cfg.camera.width), dtype=torch.bool)
    valid = torch.zeros((1, k), dtype=torch.bool)
    for steps, (o, c) in enumerate(zip(views, cosines)):
        xyz = torch.tensor([o["robot_xy"][0], o["robot_xy"][1], cfg.camera.camera_height])
        heading = torch.tensor([o["heading"]], dtype=torch.float32)
        obs = ITM.Observation(
            depth=torch.from_numpy(o["depth"].astype(np.float32))[None],
            tf_camera_to_episodic=G.xyz_yaw_to_tf_matrix(xyz, heading[0])[None],
            robot_xy=torch.from_numpy(np.float32(o["robot_xy"]))[None],
            robot_heading=heading,
        )
        _, info, state = ITM.step(state, obs, c[None], masks, valid, T.PRNGKey(steps, device="cpu")[None],
                                  pointnav="greedy", spec=SPEC, cfg=cfg)
    assert int(info.mode[0]) == ITM.MODE_EXPLORE
    obstacle = state.obstacle
    wvals = VM.waypoint_values(state.value, SPEC, obstacle.frontiers_xy, obstacle.frontiers_valid,
                               radius_px=int(0.5 * SPEC.pixels_per_meter))
    return obstacle, state.value, (info, wvals, state.acyclic)


def _chosen(frontiers, frontier):
    return int(np.argmin(np.linalg.norm(np.asarray(frontiers) - np.asarray(frontier), axis=1)))


def _assert_map_close(got, want, n_views):
    """Within MAP_ATOL, except cells on a cone-edge ulp tie (XLA's CPU atan2
    and cos against PyTorch's, see test_torch_value_map.py), which may flip:
    at most EDGE_FLIP_FRACTION of the cells the spin updated."""
    bad = np.abs(got.astype(np.float32) - np.asarray(want, np.float32)) > MAP_ATOL
    if bad.ndim == 3:
        bad = bad.any(-1)
    assert bad.sum() <= EDGE_FLIP_FRACTION * n_views * 256 * 256, f"{bad.sum()} cells differ"


def _compare(views, jcos, tcos, sync_explored=False):
    jviews, tviews = views
    jobs, jstate, jwv, jchoice, jrt, jaction = run_jax(jviews, jcos, sync_explored)
    tobs, tstate, (info, wvals, acyclic) = run_torch(tviews, tcos, sync_explored)
    _assert_map_close(tstate.conf[0].numpy(), jstate.conf, len(tviews))
    _assert_map_close(tstate.values[0].numpy(), jstate.values, len(tviews))
    for name in ("obstacles", "navigable", "explored"):
        _assert_map_close(getattr(tobs, name)[0].numpy(), getattr(jobs, name), len(tviews))
    valid = tobs.frontiers_valid[0].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jobs.frontiers_valid))
    assert valid.sum() >= 2
    # XLA's jit divides by pixels_per_meter as a product with its reciprocal.
    np.testing.assert_allclose(tobs.frontiers_xy[0].numpy(), np.asarray(jobs.frontiers_xy), atol=1e-6, rtol=0)
    np.testing.assert_allclose(wvals[0].numpy(), np.asarray(jwv), atol=1e-4)
    fxy = tobs.frontiers_xy[0].numpy()[valid]
    chosen = _chosen(fxy, info.goal[0].numpy())
    assert chosen == _chosen(fxy, jchoice.frontier)
    np.testing.assert_allclose(float(info.best_value[0]), float(jchoice.value), atol=1e-4)
    np.testing.assert_allclose([float(info.rho[0]), float(info.theta[0])], jrt, atol=1e-5)
    assert int(info.action[0]) == jaction
    np.testing.assert_array_equal(acyclic.keys[0].numpy(), np.asarray(jchoice.acyclic.keys))
    return fxy[chosen], int(info.action[0])


def test_spin_slice_with_itm_cosines_matches_jax(views, engines):
    jeng, teng = engines
    jcos = jeng.score(jnp.asarray(np.stack([o["rgb"] for o in views[0]])), TARGET)
    tcos = teng.score(torch.from_numpy(np.stack([o["rgb"] for o in views[1]])), TARGET)
    assert tcos.shape == (12, TCFG.value_channels) and torch.isfinite(tcos).all()
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-4)
    _compare(views, jcos, tcos)


def test_spin_slice_picks_the_high_value_view_like_jax(views):
    """chip_smoke.py phase 5: a high cosine at view 7 and a low one
    elsewhere must send both packages to the frontier inside view 7's
    field of view."""
    cos = np.full((12, CFG.value_channels), 0.1, np.float32)
    cos[HIGH_VIEW] = 0.9
    frontier, action = _compare(views, jnp.asarray(cos), torch.from_numpy(cos))
    robot, _ = _robot(views[1])
    bearing = np.arctan2(frontier[1] - robot[1], frontier[0] - robot[0])
    off = (bearing - views[1][HIGH_VIEW]["heading"] + np.pi) % (2 * np.pi) - np.pi
    assert abs(off) <= CFG.camera.hfov / 2  # the frontier lies in view 7's cone
    assert action in (ITM.TURN_LEFT, ITM.TURN_RIGHT, ITM.MOVE_FORWARD)


def test_spin_slice_with_synced_explored_area_matches_jax(views):
    """With ``sync_explored_areas`` the value map is cut to the obstacle
    map's explored area after every view (vlfm_tpu/policy/itm.py:157), in
    both packages alike; the cut changes the port's map."""
    cos = np.linspace(0.1, 0.9, 12 * CFG.value_channels, dtype=np.float32).reshape(12, -1)
    _compare(views, jnp.asarray(cos), torch.from_numpy(cos), sync_explored=True)
    _, synced, _ = run_torch(views[1], torch.from_numpy(cos), sync_explored=True)
    _, unsynced, _ = run_torch(views[1], torch.from_numpy(cos))
    assert not torch.equal(synced.conf, unsynced.conf)


def test_port_imports_no_jax():
    """Neither jax nor anything of the JAX package: every module of the
    port imports alone."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vlfm_tpu_torch\n"
        "for m in pkgutil.walk_packages(vlfm_tpu_torch.__path__, 'vlfm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vlfm_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('vlfm_tpu_torch.')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 19


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """No card (or no repo around the script): a non-zero exit and no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                           text=True, timeout=120, env=env)
    assert alone.returncode != 0 and '"ok": true' not in alone.stdout
