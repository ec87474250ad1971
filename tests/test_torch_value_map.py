"""vlfm_tpu_torch geometry, grid, windows, cone, median and value map
against their vlfm_tpu twins, on the same numpy inputs, on the CPU.

The port's maps are batch-first: each case runs as one lane (B = 1)
against JAX's single map. Geometry, grid, windows, median and waypoint
values are held exactly. The
cone's confidence goes through atan2 and cos, whose CPU implementations in
XLA and PyTorch differ in the last ulp, so map cells are held to 1e-6
(a few f32 ulps of values in [0, 1]). A cell whose comparison sits on such
an ulp tie (the cone edge, or max-confidence replacement between two equal
confidences) may flip outright; flips are bounded to 0.1 % of the cells
the updates touched.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.mapping import value_map as JVM
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.ops import cone as JC
from vlfm_tpu.ops import windows as JW
from vlfm_tpu.ops.median import masked_median as jax_median
from vlfm_tpu.utils import geometry as JG
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.ops import cone as C
from vlfm_tpu_torch.ops import windows as W
from vlfm_tpu_torch.ops.median import masked_median
from vlfm_tpu_torch.utils import geometry as G

SPEC = GridSpec2D(size=512, pixels_per_meter=20, pad=160)
JSPEC = JGrid(size=512, pixels_per_meter=20, pad=160)
FOV = float(np.deg2rad(79))
MIN_D, MAX_D = 0.5, 5.0
MAP_ATOL = 1e-6  # ulps of XLA's against PyTorch's CPU atan2/cos
EDGE_FLIP_FRACTION = 1e-3  # cells on an ulp tie, of the cells updated


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def synthetic_depth(seed=0, h=48, w=64):
    rng = np.random.default_rng(seed)
    img = np.repeat(rng.uniform(0.3, 1.0, size=(1, w)), h, axis=0)
    img += rng.uniform(-0.05, 0.0, size=(h, w))
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def assert_maps_equal(got, want, cells):
    """Within MAP_ATOL except for at most EDGE_FLIP_FRACTION * cells flips."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want) > MAP_ATOL
    if diff.ndim == 3:
        diff = diff.any(-1)
    assert diff.sum() <= EDGE_FLIP_FRACTION * cells, f"{diff.sum()} cells differ"
    assert ((got != 0) != (want != 0)).sum() <= EDGE_FLIP_FRACTION * cells


# --- geometry -----------------------------------------------------------------
def test_geometry_matches_jax():
    rng = np.random.default_rng(0)
    theta = rng.uniform(-20, 20, 64).astype(np.float32)
    np.testing.assert_allclose(G.wrap_heading(_t(theta)).numpy(),
                               np.asarray(JG.wrap_heading(_j(theta))), atol=1e-6)
    pos, goal = rng.normal(size=2).astype(np.float32), rng.normal(size=2).astype(np.float32)
    head = np.float32(rng.uniform(-3, 3))
    got = G.rho_theta(_t(pos), torch.tensor(head), _t(goal))
    want = JG.rho_theta(_j(pos), jnp.float32(head), _j(goal))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in want], rtol=1e-6)
    xyz = rng.normal(size=3).astype(np.float32)
    tf = G.xyz_yaw_to_tf_matrix(_t(xyz), torch.tensor(head))
    jtf = JG.xyz_yaw_to_tf_matrix(_j(xyz), jnp.float32(head))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jtf), atol=1e-7)
    assert float(G.extract_yaw(tf)) == pytest.approx(float(JG.extract_yaw(jtf)), abs=1e-6)
    pts = rng.normal(size=(50, 3)).astype(np.float32) * 3
    np.testing.assert_allclose(G.transform_points(tf, _t(pts)).numpy(),
                               np.asarray(JG.transform_points(jtf, _j(pts))), atol=1e-5)
    cone = G.within_fov_cone(_t(xyz), torch.tensor(head), FOV, 3.0, _t(pts))
    jcone = JG.within_fov_cone(_j(xyz), jnp.float32(head), FOV, 3.0, _j(pts))
    assert cone.tolist() == np.asarray(jcone).tolist()
    valid = rng.random(50) < 0.7
    got = G.closest_point_within_threshold(_t(pts), _t(goal), 1.5, _t(valid))
    want = JG.closest_point_within_threshold(_j(pts), _j(goal), 1.5, _j(valid))
    assert int(got) == int(want)
    depth = rng.uniform(0.5, 4.0, (6, 8)).astype(np.float32)
    mask = rng.random((6, 8)) < 0.5
    p, v = G.get_point_cloud(_t(depth), _t(mask), 5.0, 6.0)
    jp, jv = JG.get_point_cloud(_j(depth), _j(mask), 5.0, 6.0)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(G.rotation_matrix_2d(torch.tensor(head)).numpy(),
                               np.asarray(JG.rotation_matrix_2d(jnp.float32(head))), atol=1e-7)
    np.testing.assert_allclose(G.pt_from_rho_theta(torch.tensor(2.5), torch.tensor(head)).numpy(),
                               np.asarray(JG.pt_from_rho_theta(jnp.float32(2.5), jnp.float32(head))),
                               atol=1e-6)
    assert G.focal_length_from_fov(FOV, 640) == JG.focal_length_from_fov(FOV, 640)
    assert G.get_fov(300.0, 640) == JG.get_fov(300.0, 640)
    assert G.calculate_vfov(FOV, 640, 480) == JG.calculate_vfov(FOV, 640, 480)
    np.testing.assert_allclose(
        G.convert_to_global_frame(_t(xyz), float(head), _t(pos.tolist() + [0.5])).numpy(),
        np.asarray(JG.convert_to_global_frame(_j(xyz), float(head), _j(pos.tolist() + [0.5]))),
        atol=1e-6,
    )


# --- grid and windows ----------------------------------------------------------
def test_grid_matches_jax():
    rng = np.random.default_rng(1)
    xy = rng.uniform(-15, 15, (40, 2)).astype(np.float32)
    xy[0] = [0.025, -0.025]  # half-pixel ties round to even in both
    rc = SPEC.xy_to_px(_t(xy))
    jrc = JSPEC.xy_to_px(_j(xy))
    assert rc.dtype == torch.int32
    np.testing.assert_array_equal(rc.numpy(), np.asarray(jrc))
    np.testing.assert_array_equal(SPEC.px_to_xy(rc).numpy(), np.asarray(JSPEC.px_to_xy(jrc)))
    np.testing.assert_array_equal(SPEC.in_bounds(rc).numpy(), np.asarray(JSPEC.in_bounds(jrc)))
    np.testing.assert_array_equal(SPEC.to_storage(rc).numpy(), np.asarray(JSPEC.to_storage(jrc)))
    z = SPEC.zeros(channels=2, device="cpu")
    assert z.shape == (832, 832, 2) and z.dtype == torch.float32
    assert SPEC.crop_logical(z).shape == (512, 512, 2)


@pytest.mark.parametrize("center", [(300, 400), (5, 820), (831, 0)])
def test_windows_match_jax(center):
    rng = np.random.default_rng(2)
    arr = rng.normal(size=(832, 832, 2)).astype(np.float32)
    c = np.array(center, np.int32)
    at = W.window_index(_t(c)[None], 64, 832)
    got = W.read_window(_t(arr)[None], at)[0]
    want = JW.read_window(_j(arr), _j(c), 64)  # starts clamp into the array
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    block = rng.normal(size=(64, 64, 2)).astype(np.float32)
    t = _t(arr.copy())[None]
    out = W.write_window(t, _t(block)[None], at)
    assert out is t  # in place
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(JW.write_window(_j(arr), _j(block), _j(c))))


# --- cone and median ----------------------------------------------------------
@pytest.mark.parametrize("yaw", [0.0, 0.5, -1.2, np.pi / 2, 3.0])
def test_cone_matches_jax(yaw):
    depth = synthetic_depth(int(abs(yaw) * 10))
    row = C.depth_row_max(_t(depth), MIN_D, MAX_D)
    jrow = JC.depth_row_max(_j(depth), MIN_D, MAX_D)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    got = C.visible_confidence_window(row[None], f32([yaw]), f32(FOV), f32(MAX_D))[0]
    want = JC.visible_confidence_window(jrow, jnp.float32(yaw), jnp.float32(FOV), jnp.float32(MAX_D))
    assert got.shape == (256, 256) and float(got.max()) > 0.9
    assert_maps_equal(got.numpy(), want, 256 * 256)


def test_median_matches_jax_exactly():
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.0, 1.0, (64, 441)).astype(np.float32)
    valid = rng.random((64, 441)) < rng.uniform(0.0, 1.0, (64, 1))
    valid[0] = False  # an all-invalid row
    valid[1] = False
    valid[1, 7] = True  # a single-element row
    got = masked_median(_t(vals), _t(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_median(_j(vals), _j(valid))))
    assert got[0] == -1.0 and got[1] == vals[1, 7]


# --- value map ------------------------------------------------------------------
VIEWS = [  # (values, depth seed, x, y, yaw)
    ([0.4, 0.1], 1, 0.0, 0.0, 0.0),
    ([0.9, 0.3], 2, 0.0, 0.0, 0.9),
    ([0.2, 0.7], 3, 0.6, -0.4, -0.5),
]


def _explored():
    rng = np.random.default_rng(7)
    e = np.zeros((SPEC.storage_size,) * 2, bool)
    o = SPEC.pad + SPEC.origin
    e[o - 150 : o + 150, o - 150 : o + 150] = rng.random((300, 300)) < 0.9
    return e


@pytest.mark.parametrize("fusion", [VM.FUSION_DEFAULT, VM.FUSION_REPLACE, VM.FUSION_EQUAL_WEIGHTING])
@pytest.mark.parametrize("use_max", [True, False])
@pytest.mark.parametrize("with_explored", [False, True])
def test_update_matches_jax(fusion, use_max, with_explored):
    explored = _explored() if with_explored else None
    state = VM.create(SPEC, 2, device="cpu")
    jstate = JVM.create(JSPEC, 2)
    for vals, seed, x, y, yaw in VIEWS:
        depth = synthetic_depth(seed)
        xyz = np.array([x, y, 0.88], np.float32)
        tf = G.xyz_yaw_to_tf_matrix(_t(xyz), torch.tensor(yaw, dtype=torch.float32))[None]
        jtf = JG.xyz_yaw_to_tf_matrix(_j(xyz), jnp.float32(yaw))
        kw = dict(use_max_confidence=use_max, fusion_type=fusion)
        out = VM.update(state, SPEC, _t(np.float32(vals))[None], _t(depth)[None], tf, MIN_D, MAX_D, FOV,
                        explored=None if explored is None else _t(explored)[None], **kw)
        assert out is state  # in place
        jstate = JVM.update(jstate, JSPEC, _j(np.float32(vals)), _j(depth), jtf, MIN_D, MAX_D, FOV,
                            explored=None if explored is None else _j(explored), **kw)
    cells = len(VIEWS) * 256 * 256
    assert float(state.conf.max()) > 0
    assert_maps_equal(state.conf[0].numpy(), jstate.conf, cells)
    assert_maps_equal(state.values[0].numpy(), jstate.values, cells)
    assert VM.reset(state) is state and not state.conf.any() and not state.values.any()


def test_waypoint_values_and_sort_match_jax():
    state = VM.create(SPEC, 2, device="cpu")
    jstate = JVM.create(JSPEC, 2)
    for vals, seed, x, y, yaw in VIEWS:
        depth = synthetic_depth(seed)
        xyz = np.array([x, y, 0.0], np.float32)
        VM.update(state, SPEC, _t(np.float32(vals))[None], _t(depth)[None],
                  G.xyz_yaw_to_tf_matrix(_t(xyz), torch.tensor(yaw, dtype=torch.float32))[None],
                  MIN_D, MAX_D, FOV)
        jstate = JVM.update(jstate, JSPEC, _j(np.float32(vals)), _j(depth),
                            JG.xyz_yaw_to_tf_matrix(_j(xyz), jnp.float32(yaw)), MIN_D, MAX_D, FOV)
    # Maps are equal (checked above), so feed the JAX map to both sides.
    state = VM.ValueMapState(_t(jstate.conf)[None].clone(), _t(jstate.values)[None].clone())
    wps = np.array([[2.0, 0.0], [1.5, 1.2], [-3.0, -3.0], [3.0, -1.0], [12.9, 12.9], [0.5, 0.0]],
                   np.float32)
    valid = np.array([True, True, True, True, True, False])
    got = VM.waypoint_values(state, SPEC, _t(wps)[None], _t(valid)[None], radius_px=10)[0]
    want = JVM.waypoint_values(jstate, JSPEC, _j(wps), _j(valid), radius_px=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:2] > 0).all() and (got[5] == -1).all()
    spts, svals, order = VM.sort_waypoints_single_channel(got[:, 0], _t(wps), _t(valid))
    jpts, jvals, jorder = JVM.sort_waypoints_single_channel(want[:, 0], _j(wps), _j(valid))
    assert order.tolist() == np.asarray(jorder).tolist()
    np.testing.assert_array_equal(svals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(spts.numpy(), np.asarray(jpts))
