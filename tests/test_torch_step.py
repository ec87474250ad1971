"""Gate 1: vlfm_tpu_torch's whole policy step against vlfm_tpu's, on the CPU.

The setup is ``__graft_entry__.py``'s small one (512 px map, 96x128
camera, JAX PointNav initialised from ``PRNGKey(0)``), its PointNav carried
into the port by ``PointNavPolicy.from_jax_params``. Held:

- the entry's own step: every output and the new state;
- 16 steps of ``two_room_plan(seed=0)`` (the 12-turn spin, then moves;
  the same actions drive both environments), V2 with PointNav: per step
  the action, mode, goal (1e-6 m), frontier count, ``target_detected``,
  ``best_value`` (1e-4), rho and theta (1e-5), and PointNav's ``h``/``c``
  (1e-4); at the end the obstacle grids (but for cone-edge cells on an
  atan2/cos ulp tie, at most 0.1 % of the cells updated), the value map
  (1e-5, the same allowance), the object map, the acyclic memory and the
  frontier stickiness;
- a detection that sends the policy to NAVIGATE and then STOP within
  ``pointnav_stop_radius``, and a STOP at the map's edge, as
  ``tests/test_policy.py`` runs them;
- B = 3 lanes equal three B = 1 runs: bit for bit but PointNav's floats,
  held to 1e-4 (a convolution's blocking follows the batch size).

The helpers here are shared with test_torch_step_versions.py and
test_torch_episode_driver.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from vlfm_tpu.policy import itm as JITM
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu.utils.geometry import xyz_yaw_to_tf_matrix as jax_tf
from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.pointnav import PointNavPolicy
from vlfm_tpu_torch.ops import threefry as T
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.runner.episode_driver import step_inputs

H, W = 96, 128
GOAL_ATOL = 1e-6  # metres: XLA's jit divides by pixels_per_meter as a product with its reciprocal
VALUE_ATOL = 1e-4
ANGLE_ATOL = 1e-5
PN_ATOL = 1e-4  # PointNav h/c and logits: flax's GroupNorm against torch's in the last bits
MAP_ATOL = 1e-5
EDGE_FLIP_FRACTION = 1e-3
POINT_ATOL = 1e-5
SPIN_THEN_MOVES = [JITM.TURN_LEFT] * 12 + [JITM.MOVE_FORWARD] * 2 + [JITM.TURN_RIGHT] + [JITM.MOVE_FORWARD]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """This module's PyTorch ops on one thread: the suite runs its files in
    parallel workers, and at these sizes more threads add CPU time, not
    speed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg) -> TCONFIG.VLFMConfig:
    """The port's twin of a JAX ``VLFMConfig``."""
    fields = dataclasses.asdict(jcfg)
    cam = TCONFIG.CameraConfig(**fields.pop("camera"))
    return TCONFIG.VLFMConfig(camera=cam, **{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})


def port_spec(jspec) -> GridSpec2D:
    return GridSpec2D(jspec.size, jspec.pixels_per_meter, jspec.pad)


def jax_inputs(o, cfg):
    """JAX's step inputs from one env observation, as the JAX driver builds
    them: (Observation, cosines, masks, valid)."""
    cam = jnp.array([o["robot_xy"][0], o["robot_xy"][1], cfg.camera.camera_height])
    obs = JITM.Observation(
        depth=jnp.asarray(o["depth"]),
        tf_camera_to_episodic=jax_tf(cam, jnp.float32(o["heading"])),
        robot_xy=jnp.asarray(o["robot_xy"]),
        robot_heading=jnp.float32(o["heading"]),
    )
    k = cfg.max_detections_per_frame
    masks = np.zeros((k, *o["depth"].shape), bool)
    valid = np.zeros(k, bool)
    if o["target_visible"]:
        masks[0], valid[0] = o["target_mask"], True
    return obs, jnp.full((cfg.value_channels,), o["cosine"], jnp.float32), jnp.asarray(masks), jnp.asarray(valid)


def port_key(seed, step):
    return T.fold_in(T.PRNGKey(seed, device="cpu"), step)[None]


def assert_info_close(ti, ji, lane=0):
    for name in ("action", "mode", "num_frontiers", "target_detected", "stop_called"):
        assert int(getattr(ti, name)[lane]) == int(getattr(ji, name)), name
    np.testing.assert_allclose(ti.goal[lane].numpy(), np.asarray(ji.goal), atol=GOAL_ATOL, rtol=0)
    np.testing.assert_allclose(float(ti.best_value[lane]), float(ji.best_value), atol=VALUE_ATOL)
    np.testing.assert_allclose([float(ti.rho[lane]), float(ti.theta[lane])], [float(ji.rho), float(ji.theta)],
                               atol=ANGLE_ATOL)


def _close_cells(got, want, atol, allowed):
    bad = np.abs(got.astype(np.float32) - np.asarray(want, np.float32)) > atol
    bad = bad.any(-1) if bad.ndim == 3 else bad
    assert bad.sum() <= allowed, f"{bad.sum()} cells differ (allowed {allowed})"


def assert_state_close(ts, js, n_steps, lane=0, check_pointnav=True):
    """The port's lane against a JAX state after ``n_steps`` steps."""
    assert int(ts.steps[lane]) == int(js.steps)
    for name in ("called_stop",):
        assert bool(getattr(ts, name)[lane]) == bool(getattr(js, name))
    np.testing.assert_allclose(ts.last_goal[lane].numpy(), np.asarray(js.last_goal), atol=GOAL_ATOL, rtol=0)
    np.testing.assert_allclose(ts.last_frontier[lane].numpy(), np.asarray(js.last_frontier), atol=GOAL_ATOL, rtol=0)
    np.testing.assert_allclose(float(ts.last_value[lane]), float(js.last_value), atol=VALUE_ATOL)
    if check_pointnav:
        for name in ("h", "c"):
            np.testing.assert_allclose(getattr(ts.pointnav, name)[:, lane].numpy(),
                                       np.asarray(getattr(js.pointnav, name))[:, 0], atol=PN_ATOL, rtol=0)
        np.testing.assert_array_equal(ts.pointnav.prev_action[lane].numpy(), np.asarray(js.pointnav.prev_action)[0])
        np.testing.assert_array_equal(ts.pointnav.not_done[lane].numpy(), np.asarray(js.pointnav.not_done)[0])
    cells = n_steps * 224 * 224
    for name in ("obstacles", "navigable", "explored"):
        _close_cells(getattr(ts.obstacle, name)[lane].numpy(), getattr(js.obstacle, name), 0, EDGE_FLIP_FRACTION * cells)
    np.testing.assert_array_equal(ts.obstacle.frontiers_valid[lane].numpy(), np.asarray(js.obstacle.frontiers_valid))
    np.testing.assert_allclose(ts.obstacle.frontiers_xy[lane].numpy(), np.asarray(js.obstacle.frontiers_xy),
                               atol=GOAL_ATOL, rtol=0)
    for name in ("conf", "values"):
        _close_cells(getattr(ts.value, name)[lane].numpy(), getattr(js.value, name), MAP_ATOL,
                     EDGE_FLIP_FRACTION * n_steps * 256 * 256)
    for name in ("point_valid", "slot_used", "point_in_range", "cursor", "has_last_target"):
        np.testing.assert_array_equal(getattr(ts.objmap, name)[lane].numpy(), np.asarray(getattr(js.objmap, name)),
                                      err_msg=name)
    for name in ("points", "last_target"):
        np.testing.assert_allclose(getattr(ts.objmap, name)[lane].numpy(), np.asarray(getattr(js.objmap, name)),
                                   atol=POINT_ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(ts.acyclic.keys[lane].numpy(), np.asarray(js.acyclic.keys))
    assert int(ts.acyclic.count[lane]) == int(js.acyclic.count)


def assert_lane_equal(state, lane, single):
    """Lane ``lane`` of a batched PolicyState equals a B = 1 state: bit for
    bit, but PointNav's ``h`` and ``c`` to PN_ATOL (a convolution's and a
    GEMM's blocking, and so their last bits, follow the batch size)."""
    for name, got, want in zip(state._fields, state, single):
        if name == "pointnav":
            for f in ("h", "c"):
                torch.testing.assert_close(getattr(got, f)[:, lane:lane + 1], getattr(want, f), atol=PN_ATOL, rtol=0)
            for f in ("prev_action", "not_done"):
                assert torch.equal(getattr(got, f)[lane:lane + 1], getattr(want, f)), f
            continue
        for g, w in zip(got, want) if isinstance(got, tuple) else [(got, want)]:
            assert torch.equal(g[lane:lane + 1], w), name


def run_both(jstep, tstep, jcfg, tcfg, jspec, tspec, plan_seed=0, actions=SPIN_THEN_MOVES, key_seed=0,
             cosines=None):
    """Drive both packages from the same environment's frames (the given
    actions drive both environments); ``cosines[k]``, when given, replaces
    step k's (C,) cosines in both. Returns each step's (JAX info, port
    info) and both final states."""
    jenv = JENV.FakeObjectNavEnv(JENV.two_room_plan(plan_seed), JENV.EnvConfig(width=W, height=H))
    tenv = TENV.FakeObjectNavEnv(TENV.two_room_plan(plan_seed), TENV.EnvConfig(width=W, height=H))
    jstate = JITM.create_state(jspec, jcfg)
    tstate = ITM.create_state(tspec, tcfg, device="cpu")
    jo, to = jenv.reset(), tenv.reset()
    infos = []
    for k, a in enumerate(actions):
        jobs, jcos, jmasks, jvalid = jax_inputs(jo, jcfg)
        tobs, tcos, tmasks, tvalid = step_inputs([to], tcfg, "cpu")
        if cosines is not None:
            jcos, tcos = jnp.asarray(cosines[k]), torch.from_numpy(cosines[k])[None]
        _, ji, jstate = jstep(jstate, jobs, jcos, jmasks, jvalid, jax.random.fold_in(jax.random.PRNGKey(key_seed), k))
        _, ti, tstate = tstep(tstate, tobs, tcos, tmasks, tvalid, port_key(key_seed, k))
        infos.append((ji, ti))
        jo, to = jenv.step(a), tenv.step(a)
    return infos, jstate, tstate


@pytest.fixture(scope="module")
def setup():
    """``__graft_entry__.entry()``'s step and arguments, and the port's
    twins of its config, grid and PointNav."""
    fn, args = GE.entry()
    jcfg, jspec, jpn = fn.keywords["cfg"], fn.keywords["spec"], fn.keywords["pointnav"]
    tcfg, tspec = port_config(jcfg), port_spec(jspec)
    tpn = PointNavPolicy.from_jax_params(jax.tree_util.tree_map(np.asarray, jpn.params),
                                         tuple(jcfg.depth_image_shape), device="cpu")
    return fn, args, jcfg, jspec, jpn, tcfg, tspec, tpn


def _tstep(setup):
    *_, tcfg, tspec, tpn = setup
    return lambda *a: ITM.step(*a, pointnav=tpn, spec=tspec, cfg=tcfg, version="v2")


def test_port_config_is_the_entrys(setup):
    _, _, jcfg, _, _, tcfg, _, _ = setup
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg), "depth_image_shape": tuple(jcfg.depth_image_shape)}


def test_one_step_equals_the_graft_entry(setup):
    fn, args, jcfg, jspec, _, tcfg, tspec, _ = setup
    jaction, ji, jstate = fn(*args)
    jstate0, jobs, jcos, jmasks, jvalid, jrng = args
    obs = ITM.Observation(*(torch.from_numpy(np.array(x))[None] for x in jobs))
    tstate = ITM.create_state(tspec, tcfg, device="cpu")
    keys = torch.from_numpy(np.asarray(jrng).astype(np.int64))[None]
    taction, ti, tstate = _tstep(setup)(tstate, obs, torch.from_numpy(np.array(jcos))[None],
                                        torch.from_numpy(np.array(jmasks))[None],
                                        torch.from_numpy(np.array(jvalid))[None], keys)
    assert int(taction[0]) == int(jaction) == JITM.TURN_LEFT
    assert_info_close(ti, ji)
    assert_state_close(tstate, jstate, 1)


@pytest.fixture(scope="module")
def sixteen_steps(setup):
    fn, _, jcfg, jspec, _, tcfg, tspec, _ = setup
    return run_both(fn, _tstep(setup), jcfg, tcfg, jspec, tspec)


def test_sixteen_steps_v2_with_pointnav_match_jax_step_by_step(sixteen_steps):
    infos, _, _ = sixteen_steps
    for ji, ti in infos:
        assert_info_close(ti, ji)
    modes = [int(ti.mode[0]) for _, ti in infos]
    assert modes[:12] == [ITM.MODE_INITIALIZE] * 12 and modes[12] == ITM.MODE_EXPLORE
    assert min(int(ti.num_frontiers[0]) for _, ti in infos[12:]) > 0


def test_sixteen_steps_end_in_jaxs_state(sixteen_steps):
    _, jstate, tstate = sixteen_steps
    assert_state_close(tstate, jstate, len(SPIN_THEN_MOVES))


def test_pointnav_logits_match_jax_after_sixteen_steps(setup, sixteen_steps):
    _, _, _, _, jpn, _, _, tpn = setup
    _, jstate, tstate = sixteen_steps
    want = jpn._heads.apply({"params": jpn.params["heads"]}, jstate.pointnav.h[-1])
    np.testing.assert_allclose(tpn.logits(tstate.pointnav).numpy(), np.asarray(want), atol=PN_ATOL, rtol=0)


def _room_depth(dist=None):
    """Open space at max range, or a constant depth of ``dist`` metres
    (tests/test_policy.py:room_depth)."""
    if dist is None:
        return np.ones((H, W), np.float32)
    return np.full((H, W), (dist - 0.5) / 4.5, np.float32)


def _obs(x, y, yaw, depth):
    """An env-style observation at a pose, with no target in view."""
    return {"depth": depth, "robot_xy": np.array([x, y], np.float32), "heading": yaw, "cosine": 0.6,
            "target_visible": False, "target_mask": np.zeros((H, W), bool)}


def _step_pair(setup, jstate, tstate, o, masks_np, valid_np, key):
    fn, _, jcfg, _, _, tcfg, _, _ = setup
    jobs, jcos, _, _ = jax_inputs(o, jcfg)
    _, ji, jstate = fn(jstate, jobs, jcos, jnp.asarray(masks_np), jnp.asarray(valid_np), jax.random.PRNGKey(key))
    tobs, tcos, _, _ = step_inputs([o], tcfg, "cpu")
    _, ti, tstate = _tstep(setup)(tstate, tobs, tcos, torch.from_numpy(masks_np)[None],
                                  torch.from_numpy(valid_np)[None], T.PRNGKey(key, device="cpu")[None])
    return ji, jstate, ti, tstate


def _past_initialization(setup):
    _, _, jcfg, jspec, _, tcfg, tspec, _ = setup
    jstate = JITM.create_state(jspec, jcfg)._replace(steps=jnp.int32(20))
    tstate = ITM.create_state(tspec, tcfg, device="cpu")
    return jstate, tstate._replace(steps=torch.full((1,), 20, dtype=torch.int32))


def test_detection_navigates_then_stops_like_jax(setup):
    """tests/test_policy.py:test_detection_triggers_navigate_and_stop at the
    entry's camera: a blob straight ahead at 3 m, then a pose beside it."""
    k = setup[2].max_detections_per_frame
    jstate, tstate = _past_initialization(setup)
    yy, xx = np.mgrid[:H, :W]
    blob = (xx - W // 2) ** 2 + (yy - H // 2) ** 2 < 24**2
    depth = _room_depth()
    depth[blob] = (3.0 - 0.5) / 4.5
    masks = np.zeros((k, H, W), bool)
    masks[0] = masks[1] = blob
    valid = np.zeros(k, bool)
    valid[0] = True
    ji, jstate, ti, tstate = _step_pair(setup, jstate, tstate, _obs(0.0, 0.0, 0.0, depth), masks, valid, 1)
    assert_info_close(ti, ji)
    assert bool(ti.target_detected[0]) and int(ti.mode[0]) == ITM.MODE_NAVIGATE
    assert float(ti.rho[0]) == pytest.approx(3.0, abs=0.5)
    none = np.zeros((k, H, W), bool), np.zeros(k, bool)
    ji, jstate, ti, tstate = _step_pair(setup, jstate, tstate, _obs(2.5, 0.0, 0.0, _room_depth()), *none, 2)
    assert_info_close(ti, ji)
    assert int(ti.action[0]) == ITM.STOP and bool(ti.stop_called[0])
    assert_state_close(tstate, jstate, 2)


def test_map_edge_stops_like_jax(setup):
    """The logical map is 25.6 m wide: 12.5 m out the agent is within 8 px
    of its edge."""
    k = setup[2].max_detections_per_frame
    jstate, tstate = _past_initialization(setup)
    none = np.zeros((k, H, W), bool), np.zeros(k, bool)
    ji, jstate, ti, tstate = _step_pair(setup, jstate, tstate, _obs(12.5, 0.0, 0.0, _room_depth()), *none, 3)
    assert_info_close(ti, ji)
    assert int(ti.action[0]) == ITM.STOP


def test_three_lanes_equal_three_single_runs(setup):
    """Three two-room episodes (seeds 0-2) with oracle detections, a 3-turn
    spin and 3 PointNav steps, one B = 3 batch against each lane alone:
    every map, frontier, info and action bit for bit, PointNav's ``h``/``c``
    and logits to PN_ATOL. No step's action sits on a near tie (the B = 1
    run's top two logits within PN_ATOL)."""
    *_, tcfg, tspec, tpn = setup
    tcfg = dataclasses.replace(tcfg, num_init_turns=3)
    actions = [JITM.TURN_LEFT] * 3 + [JITM.MOVE_FORWARD, JITM.TURN_RIGHT, JITM.MOVE_FORWARD]

    def run(seeds):
        envs = [TENV.FakeObjectNavEnv(TENV.two_room_plan(s), TENV.EnvConfig(width=W, height=H)) for s in seeds]
        obs = [e.reset() for e in envs]
        state = ITM.create_state(tspec, tcfg, batch=len(seeds), device="cpu")
        infos, logits = [], []
        for k, a in enumerate(actions):
            keys = T.fold_in(T.PRNGKey(torch.tensor(seeds), device="cpu"), k)
            _, info, state = ITM.step(state, *step_inputs(obs, tcfg, "cpu"), keys, pointnav=tpn, spec=tspec,
                                      cfg=tcfg)
            infos.append(info)
            logits.append(tpn.logits(state.pointnav))
            obs = [e.step(a) for e in envs]
        return infos, logits, state

    infos, logits, state = run([0, 1, 2])
    for lane in range(3):
        infos1, logits1, state1 = run([lane])
        for info, info1, lg, lg1 in zip(infos, infos1, logits, logits1):
            for name, got, want in zip(info._fields, info, info1):
                assert torch.equal(got[lane], want[0]), name
            torch.testing.assert_close(lg[lane], lg1[0], atol=PN_ATOL, rtol=0)
            top2 = torch.topk(lg1[0], 2).values
            assert float(top2[0] - top2[1]) > PN_ATOL
        assert_lane_equal(state, lane, state1)
    assert not torch.equal(state.obstacle.explored[0], state.obstacle.explored[1])
    assert [int(info.mode[0]) for info in infos] == [ITM.MODE_INITIALIZE] * 3 + [ITM.MODE_EXPLORE] * 3
