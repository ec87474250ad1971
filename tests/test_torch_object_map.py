"""vlfm_tpu_torch's object map and its ops against vlfm_tpu, on the CPU.

The same masks, depth, poses and threefry keys go through both packages.
Held exactly: sampled indices, keep masks, slots, ``point_valid``,
``point_in_range``, ``slot_used`` and the cursor; points within 1e-5 m (the
tolerance of JAX's own batch-versus-sequential test). The port's map is
batch-first: single cases are one lane (B = 1), and B = 3 lanes are held
against three B = 1 calls bit for bit.

DBSCAN's neighbour test ``d2 <= eps^2`` reads a full-f32 product from XLA's
CPU matmul on one side and PyTorch's on the other; a pair whose d2 sits on
a last-ulp tie with eps^2 could flip. ``test_largest_cluster_mask_matches_jax``
counts those flips on every case and bounds them (at most 2 pairs in a
case); the seeded inputs here have none, and every keep mask is held
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.config import VLFMConfig
from vlfm_tpu.mapping import object_map as JOBJ
from vlfm_tpu.ops import sparse as JSP
from vlfm_tpu.ops.clustering import largest_cluster_mask as jax_cluster
from vlfm_tpu.utils import geometry as JG
from vlfm_tpu_torch import config as TCONFIG
from vlfm_tpu_torch.mapping import object_map as OBJ
from vlfm_tpu_torch.ops import sparse as SP
from vlfm_tpu_torch.ops import threefry as T
from vlfm_tpu_torch.ops.clustering import largest_cluster_mask
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.utils import geometry as G

MIN_D, MAX_D = 0.5, 5.0
H, W = 48, 64
FOV = float(np.deg2rad(79))
FX = FY = W / (2 * np.tan(FOV / 2))
POINT_ATOL = 1e-5  # metres, as tests/test_object_map.py::test_update_batch_equals_sequential
MAX_TIE_FLIPS = 2  # d2 <= eps^2 pairs that may flip on a last-ulp tie between the two CPU products


def _key(seed):
    return T.PRNGKey(seed, device="cpu")


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)


def _tf(x, y, yaw):
    xyz = np.array([x, y, 0.88], np.float32)
    return (G.xyz_yaw_to_tf_matrix(torch.from_numpy(xyz), torch.tensor(yaw, dtype=torch.float32)),
            JG.xyz_yaw_to_tf_matrix(jnp.asarray(xyz), jnp.float32(yaw)))


def _blob(cx, cy, r, h=H, w=W):
    yy, xx = np.mgrid[:h, :w]
    return (xx - cx) ** 2 + (yy - cy) ** 2 < r * r


def _scene(seed):
    """Depth with three objects at 3, 2 and 4.9 m (the last straddles the
    95 % range margin), their masks, one empty mask, one blob hugging the
    left edge (too offset: all suspect) and one too close (0.7 m)."""
    rng = np.random.default_rng(seed)
    depth = np.full((H, W), 0.95, np.float32) + rng.uniform(-0.02, 0.0, (H, W)).astype(np.float32)
    masks = np.zeros((6, H, W), bool)
    specs = [((32, 24, 12), 3.0), ((48, 30, 10), 2.0), ((20, 20, 11), 4.9), (None, 0), ((4, 24, 9), 3.0),
             ((40, 12, 9), 0.7)]
    for i, (blob, dist) in enumerate(specs):
        if blob is None:
            continue
        m = _blob(*blob)
        masks[i] = m
        depth[m] = (dist + rng.uniform(-0.05, 0.05, int(m.sum())) - MIN_D) / (MAX_D - MIN_D)
    depth[rng.random((H, W)) < 0.01] = 0.0  # holes read as far
    return depth, masks


# --- sparse sampling ------------------------------------------------------
@pytest.mark.parametrize("n,p,size", [(3000, 0.01, 64), (3000, 0.5, 64), (76800, 0.03, 512), (300, 0.0, 8),
                                      (1200, 1.0, 256)])
def test_stratified_valid_sample_matches_jax(n, p, size):
    m = np.random.default_rng(n).random(n) < p
    for seed in (0, 3):
        idx, valid = SP.stratified_valid_sample(torch.from_numpy(m)[None], size, _key(seed)[None])
        jidx, jvalid = JSP.stratified_valid_sample(jnp.asarray(m), size, jax.random.PRNGKey(seed))
        _eq(idx[0], jidx)
        _eq(valid[0], jvalid)
        assert m[idx[0][valid[0]].numpy()].all()


def test_nth_set_bit_dense_pins_the_exact_chunk_prefix_gather():
    """tests/test_object_map.py::test_dense_nth_set_bit_equals_bisection's
    cases, the 1,638,400-entry one among them (chunk prefixes ~1.5e6, past
    what a reduced-precision product keeps), against searchsorted and JAX."""
    rng = np.random.default_rng(7)
    for n, density in [(76800, 0.03), (76800, 0.6), (3072, 0.2), (100, 0.5), (2 * SP._LANES, 1.0),
                       (1638400, 0.9)]:
        mask = rng.random(n) < density
        prefix = np.cumsum(mask.astype(np.int64))
        total = int(prefix[-1])
        t_np = np.unique(np.concatenate([rng.integers(1, total + 1, 64), [1, total],
                                         prefix[prefix > 0][:4]])).astype(np.int64)
        idx, tot = SP._nth_set_bit_dense(torch.from_numpy(mask), torch.from_numpy(t_np))
        assert int(tot) == total
        np.testing.assert_array_equal(idx.numpy(), np.searchsorted(prefix, t_np, side="left"))
        jidx, _ = JSP._nth_set_bit_dense(jnp.asarray(mask), jnp.asarray(t_np, jnp.int32))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("rc", [(3, 5), (0, 0), (15, 19), (7, 18)])
def test_subsample_never_loses_a_one_pixel_mask(rc):
    """tests/test_object_map.py:183-193 in both packages."""
    eroded = np.zeros((16, 20), bool)
    eroded[rc] = True
    idx, keep = OBJ._subsample(_key(0)[None], torch.from_numpy(eroded)[None], 8)
    jidx, jkeep = JOBJ._subsample(jax.random.PRNGKey(0), jnp.asarray(eroded), 8)
    _eq(idx[0], jidx)
    _eq(keep[0], jkeep)
    assert bool(keep[0, 0]) and int(idx[0, 0]) == rc[0] * 20 + rc[1]


@pytest.mark.parametrize("seed,p", [(1, 0.1), (2, 0.6), (3, 0.004)])
def test_subsample_matches_jax_and_stays_in_the_mask(seed, p):
    eroded = np.random.default_rng(seed).random((32, 40)) < p
    idx, keep = OBJ._subsample(_key(seed)[None], torch.from_numpy(eroded)[None], 64)
    jidx, jkeep = JOBJ._subsample(jax.random.PRNGKey(seed), jnp.asarray(eroded), 64)
    _eq(idx[0], jidx)
    _eq(keep[0], jkeep)
    assert eroded.reshape(-1)[idx[0][keep[0]].numpy()].all()


# --- clustering -----------------------------------------------------------
def _cluster_points(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=0.06, size=(n // 2, 3)) + [3.0, 0.2, 0.1]
    b = rng.normal(scale=0.05, size=(n // 4, 3)) + [4.0, -1.0, 0.0]
    noise = rng.uniform(-5, 5, size=(n - n // 2 - n // 4, 3))
    pts = np.vstack([a, b, noise]).astype(np.float32)
    return pts[rng.permutation(n)], rng.random(n) < 0.9


def _tie_flips(points, valid, eps):
    """Pairs whose d2 <= eps^2 differs between XLA's and PyTorch's products."""
    def d2_jax(p):
        sq = jnp.sum(p * p, axis=1)
        return sq[:, None] + sq[None, :] - 2.0 * jnp.matmul(p, p.T, precision=jax.lax.Precision.HIGHEST)

    jd2 = np.asarray(jax.jit(d2_jax)(jnp.asarray(points)))
    p = torch.from_numpy(points)[None]
    sq = (p * p).sum(-1)
    td2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(p, p.transpose(1, 2)))[0].numpy()
    e2 = np.float32(eps) * np.float32(eps)
    both = valid[:, None] & valid[None, :]
    return int(((jd2 <= e2) != (td2 <= e2))[both].sum())


@pytest.mark.parametrize("n,seed,eps,min_pts", [(64, 0, 0.2, 5), (64, 1, 0.3, 3), (64, 2, 0.2, 40),
                                                (512, 3, 0.2, 10)])
def test_largest_cluster_mask_matches_jax(n, seed, eps, min_pts):
    pts, valid = _cluster_points(n, seed)
    got = largest_cluster_mask(torch.from_numpy(pts)[None], torch.from_numpy(valid)[None], eps, min_pts)[0]
    want = jax_cluster(jnp.asarray(pts), jnp.asarray(valid), jnp.float32(eps), jnp.int32(min_pts))
    assert _tie_flips(pts, valid, eps) <= MAX_TIE_FLIPS
    _eq(got, want)
    assert (int(got.sum()) > 0) is (min_pts < 40)


def test_largest_cluster_mask_batch_equals_single_sets():
    sets = [_cluster_points(64, s) for s in range(3)]
    pts = torch.from_numpy(np.stack([p for p, _ in sets]))
    valid = torch.from_numpy(np.stack([v for _, v in sets]))
    got = largest_cluster_mask(pts, valid, 0.2, 5)
    for i in range(3):
        assert torch.equal(got[i], largest_cluster_mask(pts[i:i + 1], valid[i:i + 1], 0.2, 5)[0])
    for i, (p, v) in enumerate(sets):  # and the JAX package's test case
        _eq(got[i], jax_cluster(jnp.asarray(p), jnp.asarray(v), jnp.float32(0.2), jnp.int32(5)))


# --- the map --------------------------------------------------------------
def _assert_state_matches(got, want, lane=0):
    for name in ("point_valid", "point_in_range", "slot_used", "cursor", "has_last_target"):
        _eq(getattr(got, name)[lane], getattr(want, name))
    np.testing.assert_allclose(got.points[lane].numpy(), np.asarray(want.points), atol=POINT_ATOL, rtol=0)
    np.testing.assert_allclose(got.last_target[lane].numpy(), np.asarray(want.last_target), atol=POINT_ATOL, rtol=0)


UPDATE_KW = dict(erosion_size=2)


@pytest.mark.parametrize("use_dbscan", [True, False])
def test_update_batch_explored_and_best_object_match_jax(use_dbscan):
    """Two frames of six detections each (an empty mask, an offset one, a
    too-close one, one straddling the range margin; the second frame's
    detection 2 flagged invalid), the eviction from a pose that looks at
    the suspect points again, and the target with its hysteresis."""
    state = OBJ.create(8, 64, device="cpu")
    jstate = JOBJ.create(8, 64)
    kw = dict(UPDATE_KW, use_dbscan=use_dbscan)
    poses = [(0.0, 0.0, 0.0), (0.5, 0.3, 0.4)]
    for frame, (x, y, yaw) in enumerate(poses):
        depth, masks = _scene(frame)
        valid = np.ones(6, bool)
        valid[2] = frame == 0
        tf, jtf = _tf(x, y, yaw)
        state = OBJ.update_batch(state, _key(frame)[None], torch.from_numpy(depth)[None],
                                 torch.from_numpy(masks)[None], torch.from_numpy(valid)[None], tf[None],
                                 MIN_D, MAX_D, FX, FY, **kw)
        jstate = JOBJ.update_batch(jstate, jax.random.PRNGKey(frame), jnp.asarray(depth), jnp.asarray(masks),
                                   jnp.asarray(valid), jtf, MIN_D, MAX_D, FX, FY, **kw)
        _assert_state_matches(state, jstate)
        assert bool(OBJ.has_object(state)[0]) == bool(JOBJ.has_object(jstate))
    assert 3 <= int(state.cursor[0]) <= 7  # accepted: not the empty, too-close or invalid ones
    assert bool((state.point_valid & ~state.point_in_range).any())  # suspect points exist
    tf, jtf = _tf(2.5, 1.0, 0.3)
    state = OBJ.update_explored(state, tf[None], MAX_D, FOV)
    jstate = JOBJ.update_explored(jstate, jtf, jnp.float32(MAX_D), jnp.float32(FOV))
    _assert_state_matches(state, jstate)
    for pos in ([0.0, 0.0], [0.2, 0.1], [3.0, -2.0]):
        target, state = OBJ.get_best_object(state, torch.tensor([pos]), use_dbscan=use_dbscan)
        jtarget, jstate = JOBJ.get_best_object(jstate, jnp.asarray(pos, jnp.float32), use_dbscan=use_dbscan)
        np.testing.assert_allclose(target[0].numpy(), np.asarray(jtarget), atol=POINT_ATOL, rtol=0)
        _assert_state_matches(state, jstate)
    pts, mask = OBJ.get_target_cloud(state)
    jpts, jmask = JOBJ.get_target_cloud(jstate)
    _eq(mask[0], jmask)
    np.testing.assert_allclose(pts[0].numpy(), np.asarray(jpts), atol=POINT_ATOL, rtol=0)


def test_update_batch_equals_sequential_updates():
    """The port's own form of tests/test_object_map.py:144: update_batch
    fills the slots K sequential ``update`` calls with the split keys fill,
    and JAX's sequential calls agree."""
    depth, masks = _scene(4)
    masks, valid = masks[:4], np.ones(4, bool)
    tf, jtf = _tf(0.0, 0.0, 0.0)
    state = OBJ.create(8, 64, device="cpu")
    batched = OBJ.update_batch(state, _key(5)[None], torch.from_numpy(depth)[None], torch.from_numpy(masks)[None],
                               torch.from_numpy(valid)[None], tf[None], MIN_D, MAX_D, FX, FY, **UPDATE_KW)
    seq, jseq = state, JOBJ.create(8, 64)
    for i, key in enumerate(T.split(_key(5), 4)):
        seq = OBJ.update(seq, key[None], torch.from_numpy(depth)[None], torch.from_numpy(masks[i])[None], tf[None],
                         MIN_D, MAX_D, FX, FY, **UPDATE_KW)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(5), 4)):
        jseq = JOBJ.update(jseq, key, jnp.asarray(depth), jnp.asarray(masks[i]), jtf, MIN_D, MAX_D, FX, FY,
                           **UPDATE_KW)
    for name in ("point_valid", "point_in_range", "slot_used", "cursor"):
        assert torch.equal(getattr(batched, name), getattr(seq, name)), name
    np.testing.assert_allclose(batched.points.numpy(), seq.points.numpy(), atol=POINT_ATOL, rtol=0)
    _assert_state_matches(seq, jseq)
    assert int(batched.cursor[0]) >= 2


def test_create_reset_and_too_offset_match_jax():
    state = OBJ.create(4, 16, batch=2, device="cpu")
    for got, want in zip(state, JOBJ.create(4, 16)):
        _eq(got[1], want)
    dirty = state._replace(cursor=torch.tensor([3, 5], dtype=torch.int32), slot_used=torch.ones(2, 4, dtype=bool))
    half = OBJ.reset(dirty, torch.tensor([False, True]))
    assert half.cursor.tolist() == [3, 0] and half.slot_used[0].all() and not half.slot_used[1].any()
    assert all(torch.equal(a, b) for a, b in zip(OBJ.reset(dirty), state))
    for blob in [(30, 24, 30), (3, 20, 3), (60, 20, 4), (32, 24, 10), (22, 24, 2)]:
        m = _blob(*blob)
        assert bool(OBJ._too_offset(torch.from_numpy(m)[None])[0]) == bool(JOBJ._too_offset(jnp.asarray(m)))
    assert not bool(OBJ._too_offset(torch.zeros(1, H, W, dtype=torch.bool))[0])


def test_three_lanes_equal_three_single_calls():
    """B = 3 lanes with their own keys, depth, masks, validity and poses,
    through update_batch, update_explored and get_best_object, equal three
    B = 1 calls bit for bit."""
    scenes = [_scene(10 + lane) for lane in range(3)]
    depth = torch.from_numpy(np.stack([d for d, _ in scenes]))
    masks = torch.from_numpy(np.stack([m for _, m in scenes]))
    valid = torch.from_numpy(np.array([[1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 1, 1], [0, 0, 0, 1, 1, 1]], bool))
    tf = torch.stack([_tf(0.1 * lane, -0.2 * lane, 0.3 * lane)[0] for lane in range(3)])
    keys = T.fold_in(T.PRNGKey(torch.arange(3)), 7)
    look = torch.stack([_tf(2.0, 0.5 * lane, 0.2)[0] for lane in range(3)])
    pos = torch.tensor([[0.0, 0.0], [1.0, 0.5], [-1.0, 2.0]])

    def run(lanes):
        s = OBJ.create(8, 64, batch=len(lanes), device="cpu")
        s = OBJ.update_batch(s, keys[lanes], depth[lanes], masks[lanes], valid[lanes], tf[lanes], MIN_D, MAX_D,
                             FX, FY, **UPDATE_KW)
        s = OBJ.update_explored(s, look[lanes], MAX_D, FOV)
        target, s = OBJ.get_best_object(s, pos[lanes])
        return target, s

    target, state = run([0, 1, 2])
    for lane in range(3):
        t1, s1 = run([lane])
        assert torch.equal(target[lane], t1[0])
        for got, want in zip(state, s1):
            assert torch.equal(got[lane], want[0])
    assert int(state.cursor.min()) >= 1 and not torch.equal(state.cursor[0], state.cursor[2])


def test_update_objects_matches_the_jax_step_sequence():
    """itm.update_objects against the object-map lines of JAX's step
    (vlfm_tpu/policy/itm.py:161-185) with the config's settings, on two
    lanes with keys fold_in(PRNGKey(lane), step)."""
    cfg = VLFMConfig(camera=dataclasses.replace(VLFMConfig().camera, width=W, height=H))
    tcfg = TCONFIG.VLFMConfig(camera=dataclasses.replace(TCONFIG.VLFMConfig().camera, width=W, height=H))
    cam = cfg.camera
    scenes = [_scene(20 + lane) for lane in range(2)]
    poses = [_tf(0.0, 0.0, 0.0), _tf(0.4, -0.3, 0.2)]
    robot = np.array([[0.0, 0.0], [0.4, -0.3]], np.float32)
    step = 3
    objmap = OBJ.create(tcfg.object_map_slots, tcfg.object_map_points_per_slot, batch=2, device="cpu")
    keys = T.fold_in(T.PRNGKey(torch.arange(2)), step)
    detected, goal, objmap = ITM.update_objects(
        objmap, None, tcfg, torch.from_numpy(np.stack([d for d, _ in scenes])),
        torch.from_numpy(np.stack([m for _, m in scenes])), torch.ones(2, 6, dtype=torch.bool),
        torch.stack([p[0] for p in poses]), torch.from_numpy(robot), keys)
    for lane in range(2):
        depth, masks = scenes[lane]
        jobj = JOBJ.create(cfg.object_map_slots, cfg.object_map_points_per_slot)
        jobj = JOBJ.update_batch(jobj, jax.random.fold_in(jax.random.PRNGKey(lane), step), jnp.asarray(depth),
                                 jnp.asarray(masks), jnp.ones(6, bool), poses[lane][1], cam.min_depth, cam.max_depth,
                                 cam.fx, cam.fy, erosion_size=cfg.object_map_erosion_size,
                                 use_dbscan=cfg.use_object_map_dbscan)
        jobj = JOBJ.update_explored(jobj, poses[lane][1], jnp.float32(cam.max_depth),
                                    jnp.float32(cam.object_map_cone_fov))
        jdet = JOBJ.has_object(jobj)
        jgoal, jobj = JOBJ.get_best_object(jobj, jnp.asarray(robot[lane]), use_dbscan=cfg.use_object_map_dbscan)
        assert bool(detected[lane]) == bool(jdet)
        np.testing.assert_allclose(goal[lane].numpy(), np.asarray(jgoal), atol=POINT_ATOL, rtol=0)
        _assert_state_matches(objmap, jobj, lane)
    assert bool(detected.all())
