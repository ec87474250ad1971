"""vlfm_tpu_torch's robot path against vlfm_tpu's, on the CPU.

At tests/test_reality_policy.py's size: a 256 px map (20 px/m, 160 px of
padding), 16 frontiers, 8 object slots of 128 points, Spot's camera shapes
(five 240x424 body depth cameras, a 480x640 gripper RGB camera). Held:

- the host copies, bit for bit: FakeRobot's frames and poses over a fixed
  command sequence, ``ObjectNavEnv``'s and ``PointNavEnv``'s observations
  over actions with all eight arm yaws, the -1.0 sentinel and the 5 -> 2
  body-camera switch, and the constants;
- ``reality_step`` through ``RealityITMPolicyV2.get_action``: the same
  observations and hook outputs (the JAX test's detector, which fires on
  two frames after the arm's start, its constant inferred depth, and
  cosines drawn from a seed) into both packages over NUM_INIT_YAWS + 12
  steps, with the greedy controller and the continuous PointNav (JAX's
  parameters carried over by ``from_jax_params``), each at v2 and v3. Per
  step angular, linear, rho and theta within ACTION_ATOL and arm_yaw and
  stop exactly; at the end the obstacle, navigable and explored grids
  exactly, the frontiers within FRONTIER_ATOL_M, the value map within
  VALUE_ATOL and the object map's clouds exactly;
- the slice as a whole: hooks over each package's tiny
  ``FullStackPerception`` (the same seeded weights) and a tiny ZoeDepth as
  ``infer_depth_fn``, 12 steps: cosines within COS_ATOL, masks within
  MASK_FLIPS, and the actions and maps as above;
- tests/test_reality_policy.py's behaviour cases on the port: the arm's
  start then motion, exploring after the start, a detection that leads to
  NAVIGATE and a stop, negative yaws routed to the arm; and ``run.py
  --backend reality`` exits with the SDK message.

The seeds: FakeRobot 0 (its depth replaced by a constant 3 m, so the maps
are the same whatever it draws), the cosines 0, the policy's key stream 0,
the tiny models' weights 0 (ZoeDepth 2). None meets a frontier-centroid
tie (ROADMAP Queue 3) in these steps: the maps agree bit for bit.
"""

import dataclasses
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_full_stack import numpy_params
from tests.test_torch_step import one_torch_thread, port_config  # noqa: F401
from vlfm_tpu.config import VLFMConfig as JConfig
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.models import pointnav as JPN
from vlfm_tpu.models import sam as JS
from vlfm_tpu.models import zoedepth as JZ
from vlfm_tpu.policy import reality as JR
from vlfm_tpu.reality import envs as JE
from vlfm_tpu.reality import robots as JRB
from vlfm_tpu.runner import full_stack as JFS
from vlfm_tpu_torch import run as RUN
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import blip2_itm as B
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.models import zoedepth as Z
from vlfm_tpu_torch.policy import reality as R
from vlfm_tpu_torch.reality import envs as E
from vlfm_tpu_torch.reality import robots as RB
from vlfm_tpu_torch.runner import full_stack as FS

JCFG = JConfig(max_frontiers=16, max_frontier_cells=256, object_map_slots=8, object_map_points_per_slot=128)
CFG = port_config(JCFG)
# v3 reads an exploration channel: two prompts (tests/test_torch_step_versions.py's)
JCFG_V3 = dataclasses.replace(JCFG, text_prompt="Seems like there is a target_object ahead.|There is a lot of "
                              "area to explore ahead.", exploration_thresh=0.3)
JSPEC = JGrid(size=256, pixels_per_meter=20, pad=160)
SPEC = GridSpec2D(256, 20, 160)
HAND_H, HAND_W = RB.SPOT_CAMERA_SHAPES["hand_color"]
STEPS = R.NUM_INIT_YAWS + 12
ACTION_ATOL = 1e-5  # angular, linear, rho, theta
FRONTIER_ATOL_M = 1e-6  # XLA's jit divides by pixels_per_meter as a product with its reciprocal
VALUE_ATOL = 1e-6
COS_ATOL = 1e-4  # tests/test_torch_blip2_itm.py's f32 tolerance
MASK_FLIPS = 1e-3  # tests/test_torch_detection_pipeline.py's flip fraction
SLICE_STEPS = 12


def open_space(base):
    """``base`` (either package's FakeRobot) with a constant 3 m depth: an
    open room, so the explored area grows and frontiers exist (as
    tests/test_reality_policy.py's OpenSpaceRobot)."""

    class OpenSpaceRobot(base):
        def get_camera_data(self, camera_ids):
            out = super().get_camera_data(camera_ids)
            for cid, cam in out.items():
                if "depth" in cid:
                    cam.image = np.full_like(cam.image, 3000)  # mm
            return out

    return OpenSpaceRobot


def make_env(robot=None):
    return E.ObjectNavEnv(robot or open_space(RB.FakeRobot)(), E.RealityEnvConfig(all_cams_until_step=10))


def make_hooks(seed=0, fire=(R.NUM_INIT_YAWS + 1, R.NUM_INIT_YAWS + 2), channels=1):
    """A fresh (score_fn, detect_fn, infer_depth_fn) per policy, so both
    packages draw the same sequence: seeded cosines, a centred detection on
    the calls in ``fire`` (1-based), and a constant inferred depth of 2 m at
    the gripper camera's 5 m range (tests/test_reality_policy.py's)."""
    rng = np.random.default_rng(seed)
    calls = {"n": 0}

    def score(rgb):
        return rng.uniform(0.0, 1.0, channels).astype(np.float32)

    def detect(rgb):
        calls["n"] += 1
        h, w = rgb.shape[:2]
        masks = np.zeros((CFG.max_detections_per_frame, h, w), bool)
        valid = np.zeros(CFG.max_detections_per_frame, bool)
        if calls["n"] in fire:
            masks[0, h // 3: 2 * h // 3, w // 3: 2 * w // 3] = True
            valid[0] = True
        return masks, valid

    def infer_depth(rgb, mn, mx):
        return np.full(rgb.shape[:2], 0.4, np.float32)

    return dict(score_fn=score, detect_fn=detect, infer_depth_fn=infer_depth)


def assert_obs_equal(got, want, path="obs"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_obs_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_obs_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def assert_actions_close(ta, ja):
    assert set(ta) == set(ja) == {"angular", "linear", "arm_yaw", "stop", "rho_theta"}
    np.testing.assert_allclose([ta["angular"], ta["linear"], *ta["rho_theta"]],
                               [ja["angular"], ja["linear"], *ja["rho_theta"]], atol=ACTION_ATOL, rtol=0)
    assert ta["arm_yaw"] == ja["arm_yaw"] and ta["stop"] == ja["stop"]


def assert_maps_close(ts, js):
    """The port's (1, ...) state against JAX's single-episode state."""
    assert int(ts.steps[0]) == int(js.steps)
    for name in ("obstacles", "navigable", "explored", "frontiers_valid"):
        np.testing.assert_array_equal(getattr(ts.obstacle, name)[0].numpy(), np.asarray(getattr(js.obstacle, name)),
                                      err_msg=name)
    np.testing.assert_allclose(ts.obstacle.frontiers_xy[0].numpy(), np.asarray(js.obstacle.frontiers_xy),
                               atol=FRONTIER_ATOL_M, rtol=0)
    for name in ("conf", "values"):
        np.testing.assert_allclose(getattr(ts.value, name)[0].numpy(), np.asarray(getattr(js.value, name)),
                                   atol=VALUE_ATOL, rtol=0, err_msg=name)
    for name in ts.objmap._fields:
        np.testing.assert_array_equal(getattr(ts.objmap, name)[0].numpy(), np.asarray(getattr(js.objmap, name)),
                                      err_msg=f"objmap.{name}")


def drive_both(tpolicy, jpolicy, steps, env=None):
    """Both policies on the same observations; JAX's actions drive the
    environment. Returns each step's (port, JAX) actions."""
    env = env or make_env()
    obs = env.reset("toilet")
    out = []
    for _ in range(steps):
        ja, ta = jpolicy.get_action(obs), tpolicy.get_action(obs)
        out.append((ta, ja))
        obs = env.step(ja)
    return out


# --- the host copies --------------------------------------------------------
def test_constants_match_jax():
    np.testing.assert_array_equal(R.INITIAL_ARM_YAWS, JR.INITIAL_ARM_YAWS)
    assert R.INITIAL_ARM_YAWS.dtype == JR.INITIAL_ARM_YAWS.dtype
    assert (R.NUM_INIT_YAWS, R.MAX_BODY_CAMS) == (JR.NUM_INIT_YAWS, JR.MAX_BODY_CAMS)
    assert RB.SPOT_CAMERA_SHAPES == JRB.SPOT_CAMERA_SHAPES
    np.testing.assert_array_equal(RB.CAM_TO_XYZ, JRB.CAM_TO_XYZ)
    assert E.BODY_DEPTH_CAMERAS == JE.BODY_DEPTH_CAMERAS
    assert (E.STOP, E.MOVE_FORWARD, E.TURN_LEFT, E.TURN_RIGHT) == (JE.STOP, JE.MOVE_FORWARD, JE.TURN_LEFT,
                                                                  JE.TURN_RIGHT)
    assert dataclasses.asdict(E.RealityEnvConfig()) == dataclasses.asdict(JE.RealityEnvConfig())


def test_fake_robot_frames_and_poses_bit_equal():
    ids = list(RB.SPOT_CAMERA_SHAPES) + ["unknown_color"]
    commands = [(0.3, 0.0), (0.0, 0.5), (-0.7, 0.2), (1.2, 0.4), (0.0, 0.0)]
    port, ref = RB.FakeRobot(seed=3), JRB.FakeRobot(seed=3)
    for angular, linear in commands:
        got, want = port.get_camera_data(ids), ref.get_camera_data(ids)
        assert list(got) == list(want)
        for cid in want:
            g, w = got[cid], want[cid]
            np.testing.assert_array_equal(g.image, w.image)
            assert g.image.dtype == w.image.dtype and g.fx == w.fx and g.fy == w.fy
            np.testing.assert_array_equal(g.tf_camera_to_global, w.tf_camera_to_global)
        (gxy, gyaw), (wxy, wyaw) = port.xy_yaw, ref.xy_yaw
        np.testing.assert_array_equal(gxy, wxy)
        assert gyaw == wyaw
        port.command_base_velocity(angular, linear)
        ref.command_base_velocity(angular, linear)
    np.testing.assert_array_equal(port.arm_joints, ref.arm_joints)


def _mixed_actions():
    """All eight arm yaws, base actions behind the -1.0 sentinel, discrete
    actions, then enough steps to pass the 5 -> 2 body-camera switch."""
    acts = [{"arm_yaw": float(y), "angular": 0.0, "linear": 0.0} for y in R.INITIAL_ARM_YAWS]
    acts += [{"arm_yaw": -1.0, "angular": 0.4, "linear": 0.2}, E.TURN_LEFT, E.MOVE_FORWARD,
             {"angular": -0.3, "linear": 0.1}, E.TURN_RIGHT, E.STOP, {"arm_yaw": -1.0, "angular": 0.0, "linear": 0.3}]
    return acts


def test_object_nav_env_observations_bit_equal():
    port = E.ObjectNavEnv(RB.FakeRobot(seed=1), E.RealityEnvConfig(all_cams_until_step=10))
    ref = JE.ObjectNavEnv(JRB.FakeRobot(seed=1), JE.RealityEnvConfig(all_cams_until_step=10))
    assert_obs_equal(port.reset("toilet"), ref.reset("toilet"))
    counts = []
    for a in _mixed_actions():
        got, want = port.step(a), ref.step(a)
        assert_obs_equal(got, want)
        counts.append(len(got["obstacle_depths"]))
        assert port.steps == ref.steps
    assert counts[:10] == [5] * 10 and counts[-1] == 2, counts
    assert port.robot.xy_yaw[1] != 0.0, "the base actions turned the robot"


def test_point_nav_env_observations_bit_equal():
    for relative in (True, False):
        port, ref = E.PointNavEnv(RB.FakeRobot(seed=2)), JE.PointNavEnv(JRB.FakeRobot(seed=2))
        port.robot.command_base_velocity(0.8, 0.6)
        ref.robot.command_base_velocity(0.8, 0.6)
        assert_obs_equal(port.reset(np.array([2.0, -1.0]), relative=relative),
                         ref.reset(np.array([2.0, -1.0]), relative=relative))
        for a in (E.MOVE_FORWARD, E.TURN_LEFT, {"angular": 0.2, "linear": 0.4}, E.TURN_RIGHT, E.STOP):
            assert_obs_equal(port.step(a), ref.step(a))


# --- reality_step against JAX -----------------------------------------------
@pytest.fixture(scope="module")
def pointnavs():
    """(JAX, port) continuous PointNav with the same weights."""
    shape = tuple(JCFG.depth_image_shape)
    policy = JPN.PointNavPolicy({}, discrete=False)
    init = jax.jit(policy.init_params, static_argnames=("depth_shape",))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), depth_shape=shape))
    return (JPN.PointNavPolicy(jax.tree_util.tree_map(jnp.asarray, params), discrete=False),
            PN.PointNavPolicy.from_jax_params(params, shape, device="cpu"))


@pytest.mark.parametrize("version", ["v2", "v3"])
@pytest.mark.parametrize("controller", ["greedy", "neural"])
def test_reality_step_matches_jax(pointnavs, controller, version):
    jpn, tpn = pointnavs if controller == "neural" else ("greedy", "greedy")
    jcfg = JCFG_V3 if version == "v3" else JCFG
    c = jcfg.value_channels
    jpolicy = JR.RealityITMPolicyV2(JSPEC, jcfg, pointnav=jpn, version=version, seed=0, **make_hooks(channels=c))
    tpolicy = R.RealityITMPolicyV2(SPEC, port_config(jcfg), pointnav=tpn, version=version, seed=0, device="cpu",
                                   **make_hooks(channels=c))
    steps = drive_both(tpolicy, jpolicy, STEPS)
    for k, (ta, ja) in enumerate(steps):
        assert_actions_close(ta, ja)
        if k < R.NUM_INIT_YAWS:
            assert ta["arm_yaw"] == float(R.INITIAL_ARM_YAWS[k]) and ta["angular"] == ta["linear"] == 0.0
    assert_maps_close(tpolicy.state, jpolicy.state)
    assert bool(tpolicy.state.objmap.slot_used.any()), "the detections reached the object map"
    assert int(tpolicy.state.obstacle.frontiers_valid.sum()) > 0
    assert any(abs(ta["angular"]) > 0 or abs(ta["linear"]) > 0 for ta, _ in steps), "the robot never moved"
    if controller == "neural":
        np.testing.assert_allclose(tpolicy.state.pointnav.h.numpy(), np.asarray(jpolicy.state.pointnav.h),
                                   atol=1e-4, rtol=0)
        assert tpolicy.state.pointnav.prev_action.shape == (1, 2)


# --- the slice as a whole, with tiny perception -----------------------------
@pytest.fixture(scope="module")
def perception():
    """(JAX, port) tiny FullStackPerception with the same seeded f32
    weights, each with a tiny ZoeDepth of the same weights."""
    bcfg = dataclasses.replace(JB.BLIP2ITMConfig.tiny(), compute_dtype=jnp.float32)
    s = bcfg.vit.image_size
    ocfg, scfg = JO.OwlViTDetConfig.tiny(), JS.SamConfig.tiny_mobile_sam()
    ids, mask = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool)
    bp = numpy_params(JB.BLIP2ITMModule(bcfg), jnp.zeros((1, s, s, 3)), ids, mask)
    op = numpy_params(JO.OwlViTDetectionModule(ocfg), jnp.zeros((1, 64, 64, 3)), ids, mask)
    sp = numpy_params(JS.SamModule(scfg), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    zp = numpy_params(JZ.ZoeDepthModule(JZ.ZoeDepthJaxConfig.tiny_test()), jnp.zeros((1, 64, 64, 3)), seed=2)
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jp = JFS.FullStackPerception(JCFG, itm=JB.BLIP2ITM(bcfg, to_jax(bp)), detector=JO.OwlViTDetector(ocfg, to_jax(op)),
                                 sam=JS.SAM(scfg, to_jax(sp)),
                                 monodepth=JZ.ZoeDepth(JZ.ZoeDepthJaxConfig.tiny_test(), to_jax(zp)))
    tp = FS.FullStackPerception(
        CFG,
        itm=B.BLIP2ITM.from_jax_params(dataclasses.replace(B.BLIP2ITMConfig.tiny(), compute_dtype=torch.float32), bp,
                                       device="cpu"),
        detector=O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(), op, device="cpu"),
        sam=S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), sp, device="cpu"),
        monodepth=Z.ZoeDepth.from_jax_params(Z.ZoeDepthConfig.tiny_test(), zp, device="cpu"),
        device="cpu")
    return jp, tp


def perception_hooks(perception, target, log, frame):
    """``RealityITMPolicyV2``'s hooks as closures over a FullStackPerception
    (either package's; ``frame`` makes its array of the policy's numpy
    frame): the cosines, the target's masks and validity, and the model's
    monocular depth; each output is appended to ``log``."""
    def score_fn(rgb):
        out = np.asarray(perception.engine.score(frame(rgb)[None], target)[0])
        log.append(("cos", out))
        return out

    def detect_fn(rgb):
        masks, valid, _ = perception.pipeline(frame(rgb)[None], target)
        masks, valid = np.asarray(masks[0]), np.asarray(valid[0])
        log.append(("det", masks, valid))
        return masks, valid

    def infer_depth_fn(rgb, min_depth, max_depth):
        out = np.asarray(perception.monodepth.infer_depth(frame(rgb)[None], min_depth, max_depth)[0])
        log.append(("depth", out))
        return out

    return dict(score_fn=score_fn, detect_fn=detect_fn, infer_depth_fn=infer_depth_fn)


def test_slice_with_tiny_perception_matches_jax(perception):
    jperc, tperc = perception
    jlog, tlog = [], []
    jpolicy = JR.RealityITMPolicyV2(JSPEC, JCFG, version="v2", seed=0,
                                    **perception_hooks(jperc, "toilet", jlog, jnp.asarray))
    tpolicy = R.RealityITMPolicyV2(SPEC, CFG, version="v2", seed=0, device="cpu",
                                   **perception_hooks(tperc, "toilet", tlog, torch.from_numpy))
    steps = drive_both(tpolicy, jpolicy, SLICE_STEPS)
    assert [e[0] for e in tlog] == [e[0] for e in jlog], "the hooks ran in another order"
    n_masks = 0
    for t, j in zip(tlog, jlog):
        if t[0] == "cos":
            np.testing.assert_allclose(t[1], j[1], atol=COS_ATOL, rtol=0)
        elif t[0] == "det":
            np.testing.assert_array_equal(t[2], j[2])
            assert float(np.mean(t[1] != j[1])) <= MASK_FLIPS
            n_masks += int(t[2].sum())
        else:
            np.testing.assert_allclose(t[1], j[1], atol=1e-6, rtol=0)
    assert n_masks > 0, "the tiny detector detected nothing"
    assert sum(e[0] == "depth" for e in tlog) == sum(bool(e[2].any()) for e in tlog if e[0] == "det")
    for ta, ja in steps:
        assert_actions_close(ta, ja)
    assert_maps_close(tpolicy.state, jpolicy.state)


# --- tests/test_reality_policy.py's behaviour cases, on the port ------------
class TestObservationProtocol:
    def test_camera_schedule_and_fields(self):
        env = make_env()
        obs = env.reset("toilet")
        assert len(obs["obstacle_depths"]) == 5
        for od in obs["obstacle_depths"]:
            assert od["depth"].shape == RB.SPOT_CAMERA_SHAPES["frontleft_depth"]
            assert od["tf"].shape == (4, 4)
        assert obs["nav_depth"].shape[1] == 2 * RB.SPOT_CAMERA_SHAPES["frontleft_depth"][1]
        assert 0 < obs["hand_fov"] < math.pi
        env.steps = 11  # past the start, only the front pair is polled
        assert len(env.observe()["obstacle_depths"]) == 2

    def test_tf_is_episodic_xyz(self):
        """At boot the hand camera sits at the episodic origin facing +x,
        and its forward axis turns with the robot."""
        env = make_env()
        tf = env.reset("toilet")["hand_tf"]
        np.testing.assert_allclose(tf[:2, 3], [0, 0], atol=1e-5)
        np.testing.assert_allclose(tf[:3, :3] @ np.array([1.0, 0, 0]), [1, 0, 0], atol=1e-5)
        env.robot._yaw = math.pi / 2
        tf = env.observe()["hand_tf"]
        np.testing.assert_allclose(tf[:3, :3] @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-5)


class TestRealityPolicy:
    def test_initialize_spins_arm_then_navigates(self):
        env = make_env()
        policy = R.RealityITMPolicyV2(SPEC, CFG, pointnav="greedy", device="cpu")
        obs = env.reset("toilet")
        yaws = []
        for t in range(R.NUM_INIT_YAWS + 3):
            action = policy.get_action(obs)
            assert set(action) == {"angular", "linear", "arm_yaw", "stop", "rho_theta"}
            if t < R.NUM_INIT_YAWS:
                yaws.append(action["arm_yaw"])
                assert action["angular"] == 0.0 and action["linear"] == 0.0
            else:
                assert action["arm_yaw"] == -1.0
            obs = env.step(action)
        np.testing.assert_allclose(yaws, R.INITIAL_ARM_YAWS, atol=1e-6)

    def test_explores_with_motion_after_init(self):
        env = make_env()
        policy = R.RealityITMPolicyV2(SPEC, CFG, pointnav="greedy", device="cpu")
        obs = env.reset("toilet")
        moved = stopped = False
        for _ in range(R.NUM_INIT_YAWS + 6):
            action = policy.get_action(obs)
            if action["stop"]:
                stopped = True
                break
            if action["arm_yaw"] == -1.0 and (abs(action["angular"]) > 0 or abs(action["linear"]) > 0):
                moved = True
            obs = env.step(action)
        assert moved or stopped, "the policy neither moved nor stopped after the start"

    def test_detection_produces_navigate_and_stop(self):
        """A detector that fires on two frames after the start sends the
        policy to NAVIGATE; closing in within pointnav_stop_radius stops."""
        hooks = make_hooks(fire=(R.NUM_INIT_YAWS + 1, R.NUM_INIT_YAWS + 2))
        hooks.pop("score_fn")
        env = make_env()
        policy = R.RealityITMPolicyV2(SPEC, CFG, pointnav="greedy", device="cpu", **hooks)
        obs = env.reset("toilet")
        stopped = False
        for _ in range(R.NUM_INIT_YAWS + 20):
            action = policy.get_action(obs)
            rho, theta = action["rho_theta"]
            assert np.isfinite(rho) and np.isfinite(theta)
            if action["stop"]:
                stopped = True
                break
            obs = env.step(action)
        assert stopped, "never stopped at the detected object"
        assert bool(policy.state.called_stop[0]), "the stop was a reached goal"


def test_env_routes_negative_arm_yaws_to_the_arm():
    """Every INITIAL_ARM_YAWS entry, the negative ones too, reaches
    set_arm_joints; only the exact -1.0 sentinel is a base action
    (objectnav_env.py:102-113)."""
    robot = RB.FakeRobot()
    env = E.ObjectNavEnv(robot)
    env.reset("toilet")
    arm_calls, base_calls = [], []
    robot.set_arm_joints = lambda joints, travel_time=1.0: arm_calls.append(float(joints[0]))
    robot.command_base_velocity = lambda ang, lin: base_calls.append((ang, lin))
    for yaw in R.INITIAL_ARM_YAWS:
        env.step({"arm_yaw": float(yaw), "angular": 0.0, "linear": 0.0})
    assert arm_calls == [float(y) for y in R.INITIAL_ARM_YAWS], (arm_calls, base_calls)
    env.step({"arm_yaw": -1.0, "angular": 0.3, "linear": 0.1})
    assert base_calls == [(0.3, 0.1)]


def test_hooks_take_tensors_and_the_start_keeps_the_base_still():
    """Hooks may return tensors; without a valid detection depth is never
    inferred, and ``last_inputs`` replays the step."""
    calls = {"depth": 0}

    def detect(rgb):
        return torch.zeros((CFG.max_detections_per_frame, *rgb.shape[:2]), dtype=torch.bool), \
            torch.zeros(CFG.max_detections_per_frame, dtype=torch.bool)

    def infer_depth(rgb, mn, mx):
        calls["depth"] += 1
        return torch.full(rgb.shape[:2], 0.4)

    env = make_env()
    policy = R.RealityITMPolicyV2(SPEC, CFG, detect_fn=detect, infer_depth_fn=infer_depth,
                                  score_fn=lambda rgb: torch.tensor([0.7]), device="cpu")
    obs = env.reset("toilet")
    fresh = R.create_state(SPEC, CFG, device="cpu")
    action = policy.get_action(obs)
    assert calls["depth"] == 0 and action["arm_yaw"] == float(R.INITIAL_ARM_YAWS[0])
    again, state = R.reality_step(fresh, *policy.last_inputs, pointnav="greedy", spec=SPEC, cfg=CFG)
    assert torch.equal(state.value.values, policy.state.value.values)
    assert torch.equal(state.obstacle.explored, policy.state.obstacle.explored)
    assert float(again.arm_yaw[0]) == action["arm_yaw"]


def test_reality_step_refuses_unknown_versions():
    policy = R.RealityITMPolicyV2(SPEC, CFG, version="v1", device="cpu")
    with pytest.raises(ValueError, match="v2"):
        policy.get_action(make_env().reset("toilet"))


def test_run_py_reality_backend_names_the_robot_path(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run", "--cpu", "--backend", "reality"])
    with pytest.raises(SystemExit, match="Boston Dynamics SDK") as exc:
        RUN.main()
    msg = str(exc.value)
    assert "vlfm_tpu_torch.reality.envs.ObjectNavEnv" in msg and "BDSWRobot" in msg and "FakeRobot" in msg
