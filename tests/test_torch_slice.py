"""The port's slice end to end against vlfm_tpu, at tiny size on the CPU.

chip_smoke.py's main path, in both packages, each with its own config,
tokenizer and synthetic environment: a 12-view spin of the environment, BLIP2-ITM cosines for the default prompt, fusion of
the views into the value map, waypoint values on a ring at the view
bearings, the frontier choice and the greedy rho-theta controller
(vlfm_tpu/policy/itm.py:253-261). Held: cosines to 1e-4, value map to
1e-5 (but for cone-edge cells on an ulp tie, at most 0.1 % of the cells
updated), waypoint values to 1e-4, and the same chosen waypoint and action.
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
from vlfm_tpu_torch.parallel.engine import PerceptionEngine
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.utils import geometry as G

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = VLFMConfig(map_size=512, camera=CameraConfig(width=160, height=120))
TCFG = TCONFIG.VLFMConfig(map_size=512, camera=TCONFIG.CameraConfig(width=160, height=120))
SPEC = GridSpec2D(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
JSPEC = JGrid(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
TARGET = "chair"
RING_M = 2.0
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
    titm = BLIP2ITM.from_jax_params(tcfg, jax.tree_util.tree_map(np.asarray, params))
    return (JEngine(JB.BLIP2ITM(jcfg, params), WordPieceTokenizer(toy_vocab()),
                    text_prompt=CFG.text_prompt),
            PerceptionEngine(titm, TTOK.WordPieceTokenizer(TTOK.toy_vocab()), TCFG.text_prompt))


def _ring(views):
    robot = np.float32(views[-1]["robot_xy"])
    bearings = np.float32([o["heading"] for o in views])
    ring = robot + np.float32(RING_M) * np.stack([np.cos(bearings), np.sin(bearings)], 1)
    return robot, np.float32(views[-1]["heading"]), ring


def run_jax(views, cosines):
    cam = CFG.camera
    state = JVM.create(JSPEC, CFG.value_channels)
    for o, c in zip(views, cosines):
        xyz = jnp.array([o["robot_xy"][0], o["robot_xy"][1], cam.camera_height], jnp.float32)
        tf = JG.xyz_yaw_to_tf_matrix(xyz, jnp.float32(o["heading"]))
        state = JVM.update(state, JSPEC, c, jnp.asarray(o["depth"], jnp.float32), tf,
                           cam.min_depth, cam.max_depth, cam.hfov,
                           use_max_confidence=CFG.use_max_confidence,
                           fusion_type=JVM.FUSION_DEFAULT)
    robot, heading, ring = _ring(views)
    valid = jnp.ones(len(views), bool)
    wv = JVM.waypoint_values(state, JSPEC, jnp.asarray(ring), valid,
                             radius_px=int(0.5 * JSPEC.pixels_per_meter))
    choice = jax_select(jnp.asarray(ring), valid, wv[:, 0], jnp.asarray(robot), jnp.zeros(2),
                        jnp.float32(-jnp.inf), JAC.create())
    rho, theta = JG.rho_theta(jnp.asarray(robot), jnp.float32(heading), choice.frontier)
    half_turn = jnp.deg2rad(15.0)  # vlfm_tpu/policy/itm.py:256-261
    action = jnp.where(theta > half_turn, JITM.TURN_LEFT,
                       jnp.where(theta < -half_turn, JITM.TURN_RIGHT, JITM.MOVE_FORWARD))
    action = jnp.where(choice.any_valid, action, JITM.STOP)
    return state, wv, choice, (float(rho), float(theta)), int(action)


def run_torch(views, cosines):
    cam = TCFG.camera
    state = VM.create(SPEC, TCFG.value_channels, device="cpu")
    for o, c in zip(views, cosines):
        xyz = torch.tensor([o["robot_xy"][0], o["robot_xy"][1], cam.camera_height])
        tf = G.xyz_yaw_to_tf_matrix(xyz, torch.tensor(o["heading"], dtype=torch.float32))
        ITM.fuse_view(state, SPEC, TCFG, c, torch.from_numpy(o["depth"].astype(np.float32)), tf)
    robot, heading, ring = _ring(views)
    dec = ITM.decide(state, SPEC, torch.from_numpy(ring), torch.ones(len(views), dtype=torch.bool),
                     torch.from_numpy(robot), torch.tensor(heading), torch.zeros(2),
                     torch.tensor(-np.inf), AC.create())
    return state, dec


def _chosen(ring, frontier):
    return int(np.argmin(np.linalg.norm(ring - np.asarray(frontier), axis=1)))


def _assert_map_close(got, want, n_views):
    """Within MAP_ATOL, except cells on a cone-edge ulp tie (XLA's CPU atan2
    and cos against PyTorch's, see test_torch_value_map.py), which may flip:
    at most EDGE_FLIP_FRACTION of the cells the spin updated."""
    bad = np.abs(got - np.asarray(want)) > MAP_ATOL
    if bad.ndim == 3:
        bad = bad.any(-1)
    assert bad.sum() <= EDGE_FLIP_FRACTION * n_views * 256 * 256, f"{bad.sum()} cells differ"


def _compare(views, jcos, tcos):
    jviews, tviews = views
    jstate, jwv, jchoice, jrt, jaction = run_jax(jviews, jcos)
    tstate, dec = run_torch(tviews, tcos)
    _assert_map_close(tstate.conf.numpy(), jstate.conf, len(tviews))
    _assert_map_close(tstate.values.numpy(), jstate.values, len(tviews))
    np.testing.assert_allclose(dec.waypoint_values.numpy(), np.asarray(jwv), atol=1e-4)
    _, _, ring = _ring(tviews)
    chosen = _chosen(ring, dec.choice.frontier.numpy())
    assert chosen == _chosen(ring, jchoice.frontier)
    np.testing.assert_allclose([float(dec.rho), float(dec.theta)], jrt, atol=1e-5)
    assert int(dec.action) == jaction
    np.testing.assert_array_equal(dec.choice.acyclic.keys.numpy(), np.asarray(jchoice.acyclic.keys))
    return chosen, int(dec.action)


def test_spin_slice_with_itm_cosines_matches_jax(views, engines):
    jeng, teng = engines
    jcos = jeng.score(jnp.asarray(np.stack([o["rgb"] for o in views[0]])), TARGET)
    tcos = teng.score(torch.from_numpy(np.stack([o["rgb"] for o in views[1]])), TARGET)
    assert tcos.shape == (12, TCFG.value_channels) and torch.isfinite(tcos).all()
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-4)
    _compare(views, jcos, tcos)


def test_spin_slice_picks_the_high_value_view_like_jax(views):
    """chip_smoke.py phase 5: a high cosine at view 7 and a low one
    elsewhere must send both packages to the waypoint at view 7's bearing."""
    cos = np.full((12, CFG.value_channels), 0.1, np.float32)
    cos[HIGH_VIEW] = 0.9
    chosen, action = _compare(views, jnp.asarray(cos), torch.from_numpy(cos))
    assert chosen == HIGH_VIEW
    assert action in (ITM.TURN_LEFT, ITM.TURN_RIGHT, ITM.MOVE_FORWARD)


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
