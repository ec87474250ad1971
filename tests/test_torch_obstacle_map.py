"""vlfm_tpu_torch's obstacle map and its ops against vlfm_tpu, on the CPU.

Every op of the map half (morphology, bit-packed masks, flood fill and
component labelling, sparse extraction, the obstacle splat, the fog of war,
frontier detection) on seeded numpy masks, through the JAX function and
the port's, and then ``obstacle_map.update`` over the spin of the synthetic
environment on a small map (256 px plus 2 x 64 px of padding: 384 columns,
so the bit-packed branch runs). Held bit for bit, except the fog of war's
cone edges, where ``atan2`` differs in the last ulp between XLA and
PyTorch: at most 0.1 % of the cells may flip there. Frontier positions in
meters are held to 1e-6 m, because XLA's jit divides by pixels_per_meter as
a product with its reciprocal.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.config import CameraConfig, VLFMConfig
from vlfm_tpu.mapping import obstacle_map as JOM
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.ops import bitpack as JBP
from vlfm_tpu.ops import flood as JFL
from vlfm_tpu.ops import frontier as JFR
from vlfm_tpu.ops import morphology as JM
from vlfm_tpu.ops import sparse as JSP
from vlfm_tpu.ops.fog_of_war import reveal_fog_of_war_window as jax_reveal
from vlfm_tpu.ops.raster import splat_depth_to_window as jax_splat
from vlfm_tpu.runner.fake_env import EnvConfig, FakeObjectNavEnv, two_room_plan
from vlfm_tpu.utils import geometry as JG
from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping import obstacle_map as OM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops import bitpack as BP
from vlfm_tpu_torch.ops import flood as FL
from vlfm_tpu_torch.ops import frontier as FR
from vlfm_tpu_torch.ops import morphology as M
from vlfm_tpu_torch.ops import sparse as SP
from vlfm_tpu_torch.ops.fog_of_war import reveal_fog_of_war_window
from vlfm_tpu_torch.ops.raster import splat_depth_to_window
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.utils import geometry as G

EDGE_FLIP_FRACTION = 1e-3
CFG = VLFMConfig(map_size=256, map_pad=64, camera=CameraConfig(width=160, height=120))
TCFG = TCONFIG.VLFMConfig(map_size=256, map_pad=64, camera=TCONFIG.CameraConfig(width=160, height=120))
SPEC = GridSpec2D(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)
JSPEC = JGrid(CFG.map_size, CFG.pixels_per_meter, CFG.map_pad)


def _mask(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _blobs(shape, seed, n=6):
    """Filled rectangles: components of several sizes."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, bool)
    for _ in range(n):
        r, c = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
        m[r:r + rng.integers(1, 14), c:c + rng.integers(1, 14)] = True
    return m


def _serpentine(h, w):
    """One corridor winding through the whole grid: a flood from one end
    needs about h * w / 2 sweeps to reach the other."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


# --- morphology -----------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 7])
def test_dilate_erode_match_jax(k):
    m = _mask((37, 45), 0.08, k)
    _eq(M.dilate(torch.from_numpy(m), k), JM.dilate(jnp.asarray(m), k))
    _eq(M.erode(torch.from_numpy(~m), k), JM.erode(jnp.asarray(~m), k))
    if k % 2:  # and cv2's, for the odd kernels the reference uses
        want = cv2.dilate(m.astype(np.uint8), np.ones((k, k), np.uint8)).astype(bool)
        _eq(M.dilate(torch.from_numpy(m), k), want)


def test_resampling_and_repeated_erosion_match_jax():
    m = _mask((32, 48), 0.3, 1)
    _eq(M.erode_repeated_3x3(torch.from_numpy(m), 2), JM.erode_repeated_3x3(jnp.asarray(m), 2))
    _eq(M.max_pool_downsample(torch.from_numpy(m), 4), JM.max_pool_downsample(jnp.asarray(m), 4))
    c = _mask((8, 12), 0.5, 2)
    _eq(M.upsample_nearest(torch.from_numpy(c), 4), JM.upsample_nearest(jnp.asarray(c), 4))


# --- bit packing ----------------------------------------------------------
def _packed_mask(seed):
    """Random bits, with bit 31 and bit 0 of words set on the grid's edges."""
    m = _mask((24, 96), 0.1, seed)
    m[:, 31] = m[:, 63] = m[:, 32] = True  # bit 31 and bit 0 across word seams
    m[0, :] |= _mask((96,), 0.5, seed + 1)  # top row: rolls wrap to the bottom
    m[-1, 95] = m[5, 0] = True  # last and first column: carries wrap
    return m


def test_pack_roundtrip_and_bit31_match_jax():
    m = _packed_mask(0)
    got, want = BP.pack_cols(torch.from_numpy(m)), JBP.pack_cols(jnp.asarray(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert int(got.max()) >= 2**31  # bit 31 is set, and stays unsigned
    _eq(BP.unpack_cols(got, 96), JBP.unpack_cols(want, 96))
    np.testing.assert_array_equal(BP.popcount(got).numpy(), np.asarray(jnp.bitwise_count(want)))


def test_dilate8_packed_wraps_like_jnp_roll():
    m = _packed_mask(1)
    cur, jcur = BP.pack_cols(torch.from_numpy(m)), JBP.pack_cols(jnp.asarray(m))
    for _ in range(3):
        cur, jcur = BP.dilate8_packed(cur), JBP.dilate8_packed(jcur)
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur).astype(np.int64))
    out = BP.unpack_cols(cur, 96).numpy()
    assert out[-1].any() and out[:, 0].any()  # the wrap reached the far edges


@pytest.mark.parametrize("size", [1, 7, 64, 700])
def test_first_set_bits_packed_match_jax(size):
    m = _packed_mask(2)
    got = BP.first_set_bits_packed(BP.pack_cols(torch.from_numpy(m)), size)
    want = JBP.first_set_bits_packed(JBP.pack_cols(jnp.asarray(m)), size)
    for g, w in zip(got, want):
        _eq(g, w)


# --- flood fill and labelling ---------------------------------------------
@pytest.mark.parametrize("cols", [64, 50])  # the packed branch, and the dense one
@pytest.mark.parametrize("max_iters", [16, 1024])  # unconverged, converged
def test_flood_from_seed_matches_jax(cols, max_iters):
    m = _serpentine(30, cols)
    seed = np.zeros_like(m)
    seed[0, 0] = True
    got = FL.flood_from_seed(torch.from_numpy(m), torch.from_numpy(seed), max_iters=max_iters)
    want = JFL.flood_from_seed(jnp.asarray(m), jnp.asarray(seed), max_iters=max_iters)
    _eq(got, want)
    assert (int(got.sum()) == int(m.sum())) is (max_iters == 1024)


def test_flood_packed_hits_max_iters_like_jax():
    m = _serpentine(30, 64)
    seed = np.zeros_like(m)
    seed[0, 0] = True
    mp, sp = BP.pack_cols(torch.from_numpy(m)), BP.pack_cols(torch.from_numpy(seed))
    got = BP.flood_packed(mp, sp, max_iters=40, check_every=8)
    want = JBP.flood_packed(JBP.pack_cols(jnp.asarray(m)), JBP.pack_cols(jnp.asarray(seed)),
                            max_iters=40, check_every=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert int(BP.unpack_cols(got, 64).sum()) < int(m.sum())


@pytest.mark.parametrize("max_iters", [4, 64])
def test_label_components_and_sizes_match_jax(max_iters):
    m = _blobs((40, 52), 3) | _serpentine(40, 52) & _mask((40, 52), 0.9, 4)
    labels = FL.label_components(torch.from_numpy(m), max_iters)
    jlabels = JFL.label_components(jnp.asarray(m), max_iters)
    _eq(labels, jlabels)
    _eq(FL.component_sizes(labels, torch.from_numpy(m)), JFL.component_sizes(jlabels, jnp.asarray(m)))


@pytest.mark.parametrize("thresh,max_roots", [(40.0, 128), (300.0, 128), (300.0, 3)])
def test_remove_small_components_coarse_matches_jax(thresh, max_roots):
    m = _blobs((96, 128), 5, n=14)
    got = FL.remove_small_components_coarse(torch.from_numpy(m), thresh, max_iters=12, max_roots=max_roots)
    want = JFL.remove_small_components_coarse(jnp.asarray(m), jnp.float32(thresh), max_iters=12,
                                              max_roots=max_roots)
    _eq(got, want)


# --- sparse extraction ----------------------------------------------------
@pytest.mark.parametrize("n,p,size", [(3000, 0.01, 64), (3000, 0.5, 64), (200_000, 0.4, 96), (77, 0.0, 5)])
def test_first_nonzero_indices_match_jax_and_bisection(n, p, size):
    m = _mask((n,), p, n)
    idx, valid = SP.first_nonzero_indices(torch.from_numpy(m), size)
    jidx, jvalid = JSP.first_nonzero_indices(jnp.asarray(m), size)
    _eq(idx, jidx)
    _eq(valid, jvalid)
    t = torch.arange(1, size + 1)
    dense, total = SP._nth_set_bit_dense(torch.from_numpy(m), t)
    bisect = torch.searchsorted(torch.cumsum(torch.from_numpy(m).long(), 0), t)
    ok = t <= total
    assert torch.equal(dense[ok], bisect[ok])


def test_first_nonzero_coords_match_jax():
    m = _mask((45, 70), 0.02, 9)
    for g, w in zip(SP.first_nonzero_coords(torch.from_numpy(m), 50),
                    JSP.first_nonzero_coords(jnp.asarray(m), 50)):
        _eq(g, w)


# --- obstacle splat and fog of war ----------------------------------------
@pytest.mark.parametrize("yaw", [0.0, 0.7, -2.4])
def test_splat_depth_to_window_matches_jax(yaw):
    rng = np.random.default_rng(11)
    depth = rng.uniform(0.5, 6.5, (60, 80)).astype(np.float32)
    in_band = rng.random((60, 80)) < 0.3
    fx = 80 / (2 * np.tan(np.deg2rad(79.0) / 2))
    got = splat_depth_to_window(torch.from_numpy(depth), torch.from_numpy(in_band),
                                torch.tensor(yaw, dtype=torch.float32), fx, 5.0, window=288)
    want = jax_splat(jnp.asarray(depth), jnp.asarray(in_band), jnp.float32(yaw), jnp.float32(fx),
                     jnp.float32(5.0), window=288, pixels_per_meter=20)
    assert got.numpy().sum() > 100
    _eq(got, want)


@pytest.mark.parametrize("heading", [0.0, 1.1, -2.9, 3.1])
def test_fog_of_war_matches_jax_up_to_cone_edges(heading):
    nav = ~M.dilate(torch.from_numpy(_mask((224, 224), 0.002, 12)), 5).numpy()
    fov = float(np.deg2rad(79.0))
    got = reveal_fog_of_war_window(torch.from_numpy(nav), torch.tensor(heading, dtype=torch.float32), fov, 100.0)
    want = np.asarray(jax_reveal(jnp.asarray(nav), jnp.float32(heading), jnp.float32(fov), jnp.float32(100.0)))
    assert want.sum() > 500
    assert (got.numpy() != want).sum() <= EDGE_FLIP_FRACTION * want.size


# --- frontiers ------------------------------------------------------------
def _frontier_scene(s, seed):
    """An explored disk with walls across it, inside a navigable area with
    small unexplored pockets."""
    rr, cc = np.mgrid[:s, :s]
    explored = (rr - s // 2) ** 2 + (cc - s // 2) ** 2 < (s // 4) ** 2
    navigable = ~_blobs((s, s), seed, n=10)
    navigable[s // 2, :] = False
    return navigable, explored & navigable


@pytest.mark.parametrize("s,max_cells", [(128, 512), (120, 512), (128, 64)])  # packed, dense, overflow
def test_detect_frontiers_matches_jax(s, max_cells):
    nav, expl = _frontier_scene(s, 13)
    got = FR.detect_frontiers(torch.from_numpy(nav), torch.from_numpy(expl), 48.0,
                              max_cells=max_cells, max_frontiers=8)
    want = JFR.detect_frontiers(jnp.asarray(nav), jnp.asarray(expl), jnp.float32(48.0),
                                max_cells=max_cells, max_frontiers=8)
    for name in ("waypoints_px", "valid", "sizes", "overflow"):
        _eq(getattr(got, name), getattr(want, name))
    assert bool(got.overflow) is (max_cells == 64)
    assert int(got.valid.sum()) >= (1 if max_cells == 64 else 2)


# --- the map --------------------------------------------------------------
def _spin(env, n):
    return [env.reset()] + [env.step(ITM.TURN_LEFT) for _ in range(n - 1)]


def _tf(o, jax_side):
    xyz = np.array([o["robot_xy"][0], o["robot_xy"][1], CFG.camera.camera_height], np.float32)
    if jax_side:
        return JG.xyz_yaw_to_tf_matrix(jnp.asarray(xyz), jnp.float32(o["heading"]))
    return G.xyz_yaw_to_tf_matrix(torch.from_numpy(xyz), torch.tensor(o["heading"], dtype=torch.float32))


def _jax_update(state, o, steps):
    cam = CFG.camera
    return JOM.update(
        state, JSPEC, jnp.asarray(o["depth"], jnp.float32), _tf(o, True), cam.min_depth, cam.max_depth,
        cam.fx, cam.fy, cam.hfov, min_height=CFG.min_obstacle_height, max_height=CFG.max_obstacle_height,
        area_thresh_m2=CFG.obstacle_map_area_threshold, full_prune=(steps % 8) == 0,
        agent_radius=CFG.agent_radius, max_frontier_cells=CFG.max_frontier_cells,
        max_frontiers=CFG.max_frontiers)


def _assert_state_close(got: OM.ObstacleMapState, want):
    for name in ("obstacles", "navigable", "explored"):
        flips = int((getattr(got, name).numpy() != np.asarray(getattr(want, name))).sum())
        assert flips <= EDGE_FLIP_FRACTION * 224 * 224, f"{name}: {flips} cells differ"
    _eq(got.frontiers_valid, want.frontiers_valid)
    _eq(got.frontier_overflow, want.frontier_overflow)
    np.testing.assert_allclose(got.frontiers_xy.numpy(), np.asarray(want.frontiers_xy), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def spin_views():
    cam = CFG.camera
    jviews = _spin(FakeObjectNavEnv(two_room_plan(seed=0), EnvConfig(width=cam.width, height=cam.height)), 6)
    tviews = _spin(TENV.FakeObjectNavEnv(TENV.two_room_plan(seed=0),
                                         TENV.EnvConfig(width=cam.width, height=cam.height)), 6)
    return jviews, tviews


def test_update_over_the_spin_matches_jax(spin_views):
    jviews, tviews = spin_views
    jstate = JOM.create(JSPEC, CFG.max_frontiers)
    state = OM.create(SPEC, TCFG.max_frontiers, device="cpu")
    for steps, (jo, o) in enumerate(zip(jviews, tviews)):
        jstate = _jax_update(jstate, jo, steps)
        state = ITM.update_obstacles(state, SPEC, TCFG, torch.from_numpy(o["depth"].astype(np.float32)),
                                     _tf(o, False), steps)
        _assert_state_close(state, jstate)
    assert int(state.frontiers_valid.sum()) >= 3 and int(state.obstacles.sum()) > 500


def test_update_from_a_mid_episode_map_matches_jax(spin_views):
    """Both packages continue the same JAX-made map (``from_numpy``), with
    and without the full prune, and without exploring."""
    jviews, tviews = spin_views
    jstate = JOM.create(JSPEC, CFG.max_frontiers)
    for steps in range(3):
        jstate = _jax_update(jstate, jviews[steps], steps)
    state = OM.from_numpy(jstate, device="cpu")
    _assert_state_close(state, jstate)
    for view, steps in ((3, 3), (4, 8)):  # step 8: full prune
        jstate = _jax_update(jstate, jviews[view], steps)
        o = tviews[view]
        state = ITM.update_obstacles(state, SPEC, TCFG, torch.from_numpy(o["depth"].astype(np.float32)),
                                     _tf(o, False), steps)
        _assert_state_close(state, jstate)
    cam = CFG.camera
    o, jo = tviews[5], jviews[5]
    jnext = JOM.update(jstate, JSPEC, jnp.asarray(jo["depth"], jnp.float32), _tf(jo, True), cam.min_depth,
                       cam.max_depth, cam.fx, cam.fy, cam.hfov, CFG.min_obstacle_height,
                       CFG.max_obstacle_height, CFG.obstacle_map_area_threshold, explore=False)
    nxt = OM.update(state, SPEC, torch.from_numpy(o["depth"].astype(np.float32)), _tf(o, False),
                    cam.min_depth, cam.max_depth, cam.fx, cam.fy, cam.hfov, CFG.min_obstacle_height,
                    CFG.max_obstacle_height, CFG.obstacle_map_area_threshold, explore=False)
    _assert_state_close(nxt, jnext)


def test_create_reset_and_helpers_match_jax():
    state = OM.create(SPEC, 8, device="cpu")
    for got, want in zip(state, JOM.create(JSPEC, 8)):
        _eq(got, want)
    state.obstacles[3, 4] = True
    state.frontiers_valid[1] = True
    for got, want in zip(OM.reset(state), JOM.create(JSPEC, 8)):
        _eq(got, want)
    assert OM._agent_kernel_size(SPEC, 0.18) == JOM._agent_kernel_size(JSPEC, 0.18) == 7
    assert OM._agent_kernel_size(SPEC, 0.2) == JOM._agent_kernel_size(JSPEC, 0.2)
    for frac in (0.1, 0.5):
        depth = np.where(_mask((30, 40), frac, 14), 0.0, 0.6).astype(np.float32)
        _eq(OM.fill_depth_holes(torch.from_numpy(depth)), JOM.fill_depth_holes(jnp.asarray(depth)))
