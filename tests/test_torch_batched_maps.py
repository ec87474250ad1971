"""The port's batch-first map half: B lanes in one call against B single
lanes, bit for bit, and every lane against JAX, on the CPU.

- The gate: three spins of ``two_room_plan(seed=0, 1, 2)`` with different
  start poses and step counts (so the every-8th-step full prune falls on
  different views per lane; lane 2 stands where its window starts are
  negative and clamp), run as one B = 3 batch through the port's ``step``
  (at every view the obstacle map, the value map and the decision, the
  choice history carried), equal three B = 1 runs bit for bit, and every
  lane keeps the JAX parity of test_torch_obstacle_map.py and
  test_torch_slice.py at their tolerances, each view's decision too.
- Windows at per-lane centres (a negative start, a clamped one) against
  ``jax.lax.dynamic_slice``; the sweep loops with one lane converging early
  and another cut at ``max_iters``; the batched ops lane by lane.
- The window helpers and the value-map fusion on ``meta`` tensors, which
  hold no data: any read back to the host would raise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.config import CameraConfig, VLFMConfig
from vlfm_tpu.mapping import obstacle_map as JOM
from vlfm_tpu.mapping import value_map as JVM
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.ops import flood as JFL
from vlfm_tpu.ops import frontier as JFR
from vlfm_tpu.ops import windows as JW
from vlfm_tpu.policy import acyclic as JAC
from vlfm_tpu.policy.frontier_selection import select_best_frontier as jax_select
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu.utils import geometry as JG
from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops import bitpack as BP
from vlfm_tpu_torch.ops import flood as FL
from vlfm_tpu_torch.ops import frontier as FR
from vlfm_tpu_torch.ops import sparse as SP
from vlfm_tpu_torch.ops import threefry as T
from vlfm_tpu_torch.ops import windows as W
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.utils import geometry as G

CFG = VLFMConfig(map_size=256, map_pad=64, camera=CameraConfig(width=160, height=120))
TCFG = TCONFIG.VLFMConfig(map_size=256, map_pad=64, camera=TCONFIG.CameraConfig(width=160, height=120))
SPEC = GridSpec2D(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
JSPEC = JGrid(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
EDGE_FLIP_FRACTION = 1e-3  # cone-edge cells on an atan2/cos ulp tie (test_torch_obstacle_map.py)
MAP_ATOL = 1e-5  # value map (test_torch_slice.py)
VIEWS = 6
# (plan seed, start xy, start yaw, the policy's step count at the first view)
LANES = [(0, (0.0, 0.0), 0.0, 0), (1, (1.0, -1.0), 1.2, 3), (2, (-3.0, 0.5), -2.0, 5)]


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- windows --------------------------------------------------------------
# Lane 1's row start is negative (it counts from the end, then clamps) and
# its column start clamps at the far edge; lane 2's row start clamps there;
# lane 3's centre itself is negative.
CENTRES = [(300, 400), (5, 820), (831, 400), (-5, 10)]


def test_windows_at_per_lane_centres_match_dynamic_slice():
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(len(CENTRES), 832, 832, 2)).astype(np.float32)
    c = np.array(CENTRES, np.int32)
    at = W.window_index(torch.from_numpy(c), 64, 832)
    got = W.read_window(torch.from_numpy(arr), at)
    block = rng.normal(size=(len(CENTRES), 64, 64, 2)).astype(np.float32)
    t = torch.from_numpy(arr.copy())
    W.write_window(t, torch.from_numpy(block), at)
    for lane in range(len(CENTRES)):
        _eq(got[lane], JW.read_window(jnp.asarray(arr[lane]), jnp.asarray(c[lane]), 64))
        _eq(t[lane], JW.write_window(jnp.asarray(arr[lane]), jnp.asarray(block[lane]), jnp.asarray(c[lane])))
    starts = W.window_starts(torch.from_numpy(c), 64, 832)
    assert starts.tolist() == [[268, 368], [768, 768], [768, 368], [768, 768]]


def test_window_helpers_and_fusion_read_nothing_back():
    """On ``meta`` tensors every host read (``.item()``, ``.tolist()``,
    ``bool()``, a data-dependent shape) raises, so these calls prove the
    window helpers and the whole value-map fusion stay on the device."""
    meta = torch.device("meta")
    arr = torch.empty((3, 832, 832, 2), device=meta)
    centres = torch.empty((3, 2), dtype=torch.int32, device=meta)
    at = W.window_index(centres, 64, 832)
    assert W.read_window(arr, at).shape == (3, 64, 64, 2)
    assert W.write_window(arr, torch.empty((3, 64, 64, 2), device=meta), at) is arr
    spec = GridSpec2D(size=512, pixels_per_meter=20, pad=160)
    state = VM.create(spec, 2, batch=3, device=meta)
    tf = torch.empty((3, 4, 4), device=meta)
    for explored in (None, torch.empty((3, 832, 832), dtype=torch.bool, device=meta)):
        out = VM.update(state, spec, torch.empty((3, 2), device=meta), torch.empty((3, 48, 64), device=meta), tf,
                        0.5, 5.0, 1.38, explored=explored)
        assert out.values.shape == (3, 832, 832, 2)
    with pytest.raises((NotImplementedError, RuntimeError)):
        bool(torch.empty((), dtype=torch.bool, device=meta))  # what a host read does here


# --- sweep loops ------------------------------------------------------------
def _serpentine(h, w):
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


@pytest.mark.parametrize("cols", [64, 50])  # the packed branch, and the dense one
def test_sweep_loop_runs_until_every_lane_converges_or_max_iters(cols):
    """Lane 0 (a small square) converges in the first check; lane 1 (a
    winding corridor inside an empty frame, so no wrap-around shortcuts it)
    is cut at max_iters. Each equals its own single JAX run: the converged
    lane is a fixed point through lane 1's extra sweeps."""
    masks = np.zeros((2, 30, cols), bool)
    masks[0, 2:8, 2:8] = True
    masks[1, 1:-1, 1:-1] = _serpentine(28, cols - 2)
    seeds = np.zeros_like(masks)
    seeds[0, 3, 3] = seeds[1, 1, 1] = True
    got = FL.flood_from_seed(torch.from_numpy(masks), torch.from_numpy(seeds), max_iters=48)
    for lane in range(2):
        _eq(got[lane], JFL.flood_from_seed(jnp.asarray(masks[lane]), jnp.asarray(seeds[lane]), max_iters=48))
    assert torch.equal(got[0], torch.from_numpy(masks[0])) and int(got[1].sum()) < int(masks[1].sum())
    labels = FL.label_components(torch.from_numpy(masks), 8)
    for lane in range(2):
        _eq(labels[lane], JFL.label_components(jnp.asarray(masks[lane]), 8))


def _blobs(shape, seed, n=10):
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    for _ in range(n):
        r, c = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
        m[r:r + rng.integers(1, 14), c:c + rng.integers(1, 14)] = True
    return m


@pytest.mark.parametrize("s", [128, 120])  # packed, dense
def test_batched_frontier_ops_equal_single_lanes(s):
    """Frontier detection and its steps on three lanes at once equal each
    lane alone, and JAX."""
    rr, cc = np.mgrid[:s, :s]
    nav, expl = [], []
    for lane in range(3):
        e = (rr - s // 2 - 4 * lane) ** 2 + (cc - s // 2) ** 2 < (s // 4 + 3 * lane) ** 2
        n = ~_blobs((s, s), 13 + lane)
        n[s // 2 + lane, :] = False
        nav.append(n)
        expl.append(e & n)
    nav_t, expl_t = torch.from_numpy(np.stack(nav)), torch.from_numpy(np.stack(expl))
    got = FR.detect_frontiers(nav_t, expl_t, 48.0, max_cells=256, max_frontiers=8)
    sizes = FL.component_sizes(FL.label_components(nav_t, 16), nav_t)
    small = FL.remove_small_components_coarse(nav_t, 200.0, max_iters=12)
    for lane in range(3):
        one = FR.detect_frontiers(nav_t[lane:lane + 1], expl_t[lane:lane + 1], 48.0, max_cells=256, max_frontiers=8)
        want = JFR.detect_frontiers(jnp.asarray(nav[lane]), jnp.asarray(expl[lane]), jnp.float32(48.0),
                                    max_cells=256, max_frontiers=8)
        for name in ("waypoints_px", "valid", "sizes", "overflow"):
            assert torch.equal(getattr(got, name)[lane], getattr(one, name)[0]), name
            _eq(getattr(got, name)[lane], getattr(want, name))
        jl = JFL.label_components(jnp.asarray(nav[lane]), 16)
        _eq(sizes[lane], JFL.component_sizes(jl, jnp.asarray(nav[lane])))
        _eq(small[lane], JFL.remove_small_components_coarse(jnp.asarray(nav[lane]), jnp.float32(200.0),
                                                            max_iters=12))
    assert int(got.valid.sum(dim=1).min()) >= 1
    if s % 32 == 0:
        packed = BP.pack_cols(expl_t)
        rows, cols, valid = BP.first_set_bits_packed(packed, 300)
        for lane in range(3):
            r1, c1, v1 = BP.first_set_bits_packed(packed[lane:lane + 1], 300)
            assert torch.equal(rows[lane], r1[0]) and torch.equal(cols[lane], c1[0]) and torch.equal(valid[lane], v1[0])
    idx, valid = SP.first_nonzero_indices(expl_t.reshape(3, -1), 40)
    for lane in range(3):
        i1, v1 = SP.first_nonzero_indices(expl_t[lane].reshape(-1), 40)
        assert torch.equal(idx[lane], i1) and torch.equal(valid[lane], v1)


# --- the gate -------------------------------------------------------------
def _lane_views(pkg_env, lane):
    seed, start, yaw, _ = LANES[lane]
    plan = dataclasses.replace(pkg_env.two_room_plan(seed=seed), start=start, start_yaw=yaw)
    env = pkg_env.FakeObjectNavEnv(plan, pkg_env.EnvConfig(width=CFG.camera.width, height=CFG.camera.height))
    return [env.reset()] + [env.step(ITM.TURN_LEFT) for _ in range(VIEWS - 1)]


@pytest.fixture(scope="module")
def lane_views():
    """(JAX's views, the port's views) of each lane."""
    return [(_lane_views(JENV, lane), _lane_views(TENV, lane)) for lane in range(len(LANES))]


def _cosines(lane):
    rng = np.random.default_rng(100 + lane)
    return rng.uniform(0.05, 0.95, (VIEWS, CFG.value_channels)).astype(np.float32)


def _pose(o):
    xyz = torch.tensor([o["robot_xy"][0], o["robot_xy"][1], CFG.camera.camera_height], dtype=torch.float32)
    return G.xyz_yaw_to_tf_matrix(xyz, torch.tensor(o["heading"], dtype=torch.float32))


def run_port(per_lane_views, lanes):
    """The spin of ``lanes`` as one batch through the port's ``step``
    (greedy controller, no detections, every view an EXPLORE step: per
    view the obstacle-map update, the fusion and the decision, the choice
    history carried from view to view)."""
    b = len(lanes)
    cfg = dataclasses.replace(TCFG, sync_explored_areas=True, num_init_turns=0)
    state = ITM.create_state(SPEC, cfg, batch=b, device="cpu")
    state = state._replace(steps=torch.tensor([LANES[lane][3] for lane in lanes], dtype=torch.int32))
    cos = torch.from_numpy(np.stack([_cosines(lane) for lane in lanes]))
    k = cfg.max_detections_per_frame
    masks = torch.zeros((b, k, CFG.camera.height, CFG.camera.width), dtype=torch.bool)
    valid = torch.zeros((b, k), dtype=torch.bool)
    infos = []
    for v in range(VIEWS):
        views = [per_lane_views[lane][1][v] for lane in lanes]
        obs = ITM.Observation(
            depth=torch.from_numpy(np.stack([o["depth"] for o in views]).astype(np.float32)),
            tf_camera_to_episodic=torch.stack([_pose(o) for o in views]),
            robot_xy=torch.from_numpy(np.array([o["robot_xy"] for o in views], np.float32)),
            robot_heading=torch.tensor([o["heading"] for o in views], dtype=torch.float32),
        )
        keys = T.fold_in(T.PRNGKey(torch.tensor(lanes), device="cpu"), v)
        _, info, state = ITM.step(state, obs, cos[:, v], masks, valid, keys, pointnav="greedy", spec=SPEC, cfg=cfg)
        infos.append(info)
    wvals = VM.waypoint_values(state.value, SPEC, state.obstacle.frontiers_xy, state.obstacle.frontiers_valid,
                               radius_px=int(0.5 * SPEC.pixels_per_meter))
    return state.obstacle, state.value, (infos, wvals, state)


def run_jax(views, lane):
    """The same lane in JAX: per view both map updates and the frontier
    choice (the choice history carried, as JAX's ``step`` carries it on an
    EXPLORE step)."""
    cam = CFG.camera
    obstacle = JOM.create(JSPEC, CFG.max_frontiers)
    value = JVM.create(JSPEC, CFG.value_channels)
    cos = _cosines(lane)
    last_frontier, last_value, acyclic = jnp.zeros(2), jnp.float32(-jnp.inf), JAC.create()
    choices = []
    for v, o in enumerate(views):
        xyz = jnp.array([o["robot_xy"][0], o["robot_xy"][1], cam.camera_height], jnp.float32)
        tf = JG.xyz_yaw_to_tf_matrix(xyz, jnp.float32(o["heading"]))
        depth = jnp.asarray(o["depth"], jnp.float32)
        steps = LANES[lane][3] + v
        obstacle = JOM.update(
            obstacle, JSPEC, depth, tf, cam.min_depth, cam.max_depth, cam.fx, cam.fy, cam.hfov,
            min_height=CFG.min_obstacle_height, max_height=CFG.max_obstacle_height,
            area_thresh_m2=CFG.obstacle_map_area_threshold, full_prune=(steps % 8) == 0,
            agent_radius=CFG.agent_radius, max_frontier_cells=CFG.max_frontier_cells,
            max_frontiers=CFG.max_frontiers)
        value = JVM.update(value, JSPEC, jnp.asarray(cos[v]), depth, tf, cam.min_depth, cam.max_depth, cam.hfov,
                           use_max_confidence=CFG.use_max_confidence, fusion_type=JVM.FUSION_DEFAULT,
                           explored=obstacle.explored)
        wv = JVM.waypoint_values(value, JSPEC, obstacle.frontiers_xy, obstacle.frontiers_valid,
                                 radius_px=int(0.5 * JSPEC.pixels_per_meter))
        choice = jax_select(obstacle.frontiers_xy, obstacle.frontiers_valid, wv[:, 0],
                            jnp.asarray(o["robot_xy"], jnp.float32), last_frontier, last_value, acyclic)
        last_frontier, last_value, acyclic = choice.last_frontier, choice.last_value, choice.acyclic
        choices.append(choice)
    return obstacle, value, wv, choices


def _lane(tree, lane):
    return [t[lane] for t in tree]


@pytest.fixture(scope="module")
def batched_and_single(lane_views):
    return run_port(lane_views, [0, 1, 2]), [run_port(lane_views, [lane]) for lane in range(3)]


def test_gate_three_lanes_equal_three_single_runs_bit_for_bit(batched_and_single):
    (obstacle, value, (infos, wvals, state)), singles = batched_and_single
    for lane, (o1, v1, (infos1, wvals1, state1)) in enumerate(singles):
        for got, want in zip(_lane(obstacle, lane), _lane(o1, 0)):
            assert torch.equal(got, want)
        for got, want in zip(_lane(value, lane), _lane(v1, 0)):
            assert torch.equal(got, want)
        assert torch.equal(wvals[lane], wvals1[0])
        for info, info1 in zip(infos, infos1):
            for got, want in zip(info, info1):
                assert torch.equal(got[lane], want[0])
        for got, want in ((state.acyclic.keys, state1.acyclic.keys), (state.last_frontier, state1.last_frontier),
                          (state.last_value, state1.last_value), (state.steps, state1.steps)):
            assert torch.equal(got[lane], want[0])
    # The lanes differ, the prune schedule too, and lane 2's windows clamp.
    assert not torch.equal(obstacle.explored[0], obstacle.explored[1])
    rc = SPEC.to_storage(SPEC.xy_to_px(torch.tensor([LANES[2][1]])))
    assert int(rc[0, 0]) - 288 // 2 < 0
    assert bool(obstacle.frontiers_valid.any(dim=1).all())


def test_reset_clears_only_the_chosen_lanes(batched_and_single):
    """An episode that starts anew clears its lane; the others go on."""
    (obstacle, value, _), _ = batched_and_single
    obstacle = OM.ObstacleMapState(*(t.clone() for t in obstacle))
    value = VM.ValueMapState(*(t.clone() for t in value))
    lanes = torch.tensor([False, True, False])
    fresh_o = OM.create(SPEC, TCFG.max_frontiers, batch=1, device="cpu")
    before = [t.clone() for t in obstacle]
    OM.reset(obstacle, lanes)
    VM.reset(value, lanes)
    for got, was, new in zip(obstacle, before, fresh_o):
        assert torch.equal(got[1], new[0]) and torch.equal(got[0], was[0]) and torch.equal(got[2], was[2])
    assert not value.conf[1].any() and not value.values[1].any() and value.conf[0].any() and value.conf[2].any()


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_gate_every_lane_keeps_its_jax_parity(lane_views, batched_and_single, lane):
    (obstacle, value, (infos, wvals, state)), _ = batched_and_single
    jobs, jval, jwv, jchoices = run_jax(lane_views[lane][0], lane)
    for name in ("obstacles", "navigable", "explored"):
        flips = int((getattr(obstacle, name)[lane].numpy() != np.asarray(getattr(jobs, name))).sum())
        assert flips <= EDGE_FLIP_FRACTION * VIEWS * 224 * 224, f"{name}: {flips} cells differ"
    _eq(obstacle.frontiers_valid[lane], jobs.frontiers_valid)
    np.testing.assert_allclose(obstacle.frontiers_xy[lane].numpy(), np.asarray(jobs.frontiers_xy), atol=1e-6, rtol=0)
    for got, want in ((value.conf[lane], jval.conf), (value.values[lane], jval.values)):
        bad = np.abs(got.numpy() - np.asarray(want)) > MAP_ATOL
        bad = bad.any(-1) if bad.ndim == 3 else bad
        assert bad.sum() <= EDGE_FLIP_FRACTION * VIEWS * 256 * 256
    np.testing.assert_allclose(wvals[lane].numpy(), np.asarray(jwv), atol=1e-4)
    for info, jchoice in zip(infos, jchoices):  # each view's decision
        np.testing.assert_allclose(info.goal[lane].numpy(), np.asarray(jchoice.frontier), atol=1e-6, rtol=0)
        np.testing.assert_allclose(float(info.best_value[lane]), float(jchoice.value), atol=1e-4)
    np.testing.assert_array_equal(state.acyclic.keys[lane].numpy(), np.asarray(jchoices[-1].acyclic.keys))
