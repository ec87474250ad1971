"""vlfm_tpu_torch's full stack against vlfm_tpu's, on the CPU.

Tiny BLIP2-ITM (f32), OWL-ViT and MobileSAM get seeded numpy weights in
JAX's parameter trees (``jax.eval_shape`` of the inits, which flax takes
~20 s to compile), carried into the port with ``from_jax_params``; both packages'
``FullStackPerception`` serve the same frames at
tests/test_farm_full_stack.py's small configuration (48x64 frames, a 512 px
map). Held against JAX: ``batch`` (cosines to 1e-4, validity exactly, masks
to a flip fraction of 1e-3, as tests/test_torch_blip2_itm.py and
tests/test_torch_detection_pipeline.py hold them) for a COCO target and a
non-COCO one, ungated and gated; two dispatches of the packed fused step on
2 lanes, the second resetting one lane (actions and detections exactly,
goals within 1e-5 m); and ``run_full_stack_episode`` over 16 steps (steps,
success, detection, seen and failure cause equal, SPL within 1e-6). Port
only: the packed and unpacked fused steps agree bit for bit (with f32
full-size records and with u16 half-size depth and half-size RGB), the callable
is cached and reads the models at each call, frames that crossed at half
size give masks on the camera grid, and misused options raise.

With ``cfg.use_vqa`` (a tiny BLIP2VQA bridge, seeded numpy trees, and the
yes token the port answers first on a valid slot, so that the veto keeps
some detections and drops others): ``batch`` ungated and with the veto
gated at 2 slots, the packed fused step and ``run_full_stack_episode`` equal
JAX's as above, and the veto only narrows. The monocular-depth fallback
(tiny ZoeDepth, the same weights on both sides): depth is inferred for an
all-ones depth image (to 1e-6 of JAX's) and the sensor's depth comes back as
the same object otherwise (JAX's test_monodepth_triggers_on_all_ones); an
episode whose camera gives all-ones depth hands ``step`` the inferred depth
on the steps with a detection and None on the others, and equals JAX's.

Also the JAX package's half-size RGB fault (ROADMAP Queue 3): its object
map samples pixel indices in a half-size mask's flattened grid and decodes
them with the depth's width, so the points of an object in the bottom
right of the frame come from the top rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_step import one_torch_thread, port_config, port_spec  # noqa: F401
from vlfm_tpu.config import CameraConfig as JCamera
from vlfm_tpu.config import VLFMConfig as JConfig
from vlfm_tpu.mapping import object_map as JOBJ
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.models import blip2_itm as JB
from vlfm_tpu.models import owl_vit as JO
from vlfm_tpu.models import sam as JS
from vlfm_tpu.policy import itm as JITM
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu.runner import full_stack as JFS
from vlfm_tpu.runner import packing as JPK
from vlfm_tpu_torch.models import blip2_itm as B
from vlfm_tpu_torch.models import owl_vit as O
from vlfm_tpu_torch.models import sam as S
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.runner import full_stack as FS
from vlfm_tpu_torch.runner import packing as PK
from vlfm_tpu_torch.runner import sim_farm as SF

JCFG = JConfig(camera=JCamera(height=48, width=64), max_frontiers=16, max_frontier_cells=256,
               object_map_slots=8, object_map_points_per_slot=128, max_detections_per_frame=4)
JSPEC = JGrid(size=512, pixels_per_meter=20, pad=160)
CFG, SPEC = port_config(JCFG), port_spec(JSPEC)
H, W = 48, 64
COS_ATOL = 1e-4  # tests/test_torch_blip2_itm.py's f32 tolerance
MASK_FLIPS = 1e-3  # tests/test_torch_detection_pipeline.py's flip fraction
GOAL_ATOL = 1e-5  # metres
SPL_ATOL = 1e-6
EPISODE_STEPS = 16


def numpy_params(module, *init_args, seed=0):
    """A JAX parameter tree of seeded numpy leaves, its structure from
    ``jax.eval_shape`` of the module's init (no compile): kernels
    N(0, 1/fan_in), norm scales 1 +- 0.1, embeddings N(0, 1/width), the
    rest 0.02-scale."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, n = path[-1].key, rng.normal(size=x.shape)
        if name == "kernel":
            n = n / np.sqrt(np.prod(x.shape[:-1]))
        elif name == "scale":
            n = 1 + 0.1 * n
        elif name == "embedding":
            n = n / np.sqrt(x.shape[-1])
        else:
            n = 0.02 * n
        return n.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def stacks():
    """(JAX models, port models) with the same tiny f32 weights."""
    bcfg = dataclasses.replace(JB.BLIP2ITMConfig.tiny(), compute_dtype=jnp.float32)
    s = bcfg.vit.image_size
    ocfg, scfg = JO.OwlViTDetConfig.tiny(), JS.SamConfig.tiny_mobile_sam()
    ids, mask = jnp.zeros((1, 4), jnp.int32), jnp.ones((1, 4), bool)
    bp = numpy_params(JB.BLIP2ITMModule(bcfg), jnp.zeros((1, s, s, 3)), ids, mask)
    op = numpy_params(JO.OwlViTDetectionModule(ocfg), jnp.zeros((1, 64, 64, 3)), ids, mask)
    sp = numpy_params(JS.SamModule(scfg), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    jmodels = dict(itm=JB.BLIP2ITM(bcfg, to_jax(bp)), detector=JO.OwlViTDetector(ocfg, to_jax(op)),
                   sam=JS.SAM(scfg, to_jax(sp)))
    tmodels = dict(
        itm=B.BLIP2ITM.from_jax_params(dataclasses.replace(B.BLIP2ITMConfig.tiny(), compute_dtype=torch.float32),
                                       bp, device="cpu"),
        detector=O.OwlViTDetector.from_jax_params(O.OwlViTDetConfig.tiny(), op, device="cpu"),
        sam=S.SAM.from_jax_params(S.SamConfig.tiny_mobile_sam(), sp, device="cpu"),
    )
    return jmodels, tmodels


def _pair(stacks, capacity=None):
    jmodels, tmodels = stacks
    jcfg = dataclasses.replace(JCFG, sam_frame_capacity=capacity)
    return (JFS.FullStackPerception(jcfg, **jmodels),
            FS.FullStackPerception(port_config(jcfg), **tmodels, device="cpu"))


def _frames(n=4):
    return np.random.default_rng(3).integers(0, 256, (n, H, W, 3), dtype=np.uint8)


@pytest.mark.parametrize("target,capacity", [("toilet", None), ("fireplace", None), ("toilet", 2)])
def test_batch_matches_jax(stacks, target, capacity):
    jp, tp = _pair(stacks, capacity)
    rgb = _frames()
    jc, jm, jv = jp.batch(rgb, target)
    tc, tm, tv = tp.batch(rgb, target)
    assert tc.shape == (4, CFG.value_channels) and tm.shape == (4, CFG.max_detections_per_frame, H, W)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=COS_ATOL, rtol=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert float(np.mean(tm.numpy() != np.asarray(jm))) <= MASK_FLIPS
    assert tv.any(), "threshold 0 puts detections on the frames"


def _envs(pkg, seeds):
    return [pkg.FakeObjectNavEnv(pkg.open_room_plan(seed=s), pkg.EnvConfig(width=W, height=H, max_steps=24))
            for s in seeds]


def _layout(pk, lanes=2, compressed=False):
    """The perception farm's layout: f32 full-size records, or with
    ``compressed`` the JAX bench's u16 half-size depth and half-size RGB."""
    h, w = (H // 2, W // 2) if compressed else (H, W)
    return pk.build_layout([("depth", "uint16" if compressed else "float32", (lanes, h, w)),
                            ("rgb", "uint8", (lanes, h, w, 3)),
                            ("heading", "float32", (lanes,)), ("xy", "float32", (lanes, 2)),
                            ("seeds", "int32", (lanes,)), ("steps", "int32", (lanes,)),
                            ("reset", "uint8", (lanes,))])


def _dispatches():
    """Two dispatches' packed fields on 2 lanes (open_room_plan seeds 0 and
    1, then lane 1 restarted on seed 2), and the actions that move the
    environments between them."""
    envs = _envs(TENV, (0, 1, 2))
    first = [envs[0].reset(), envs[1].reset()]
    second = [envs[0].step(TENV.TURN_LEFT), envs[2].reset()]
    return [(first, (0, 1), (0, 0), (0, 0)), (second, (0, 2), (1, 0), (0, 1))]


def _fill(views, obs, seeds, steps, reset):
    """One dispatch's fields; a half-size layout gets the farm's records'
    2x2 box averages and u16 depth (``sim_farm.pack_obs``)."""
    for j, o in enumerate(obs):
        if views["depth"].shape[-1] == W:
            views["depth"][j], views["rgb"][j] = o["depth"], o["rgb"]
        else:
            views["depth"][j] = np.clip(SF._avg2x2_f32(o["depth"]), 0, 1) * 65535.0 + 0.5
            views["rgb"][j] = SF._avg2x2_u8(o["rgb"])
        views["heading"][j], views["xy"][j] = o["heading"], o["robot_xy"]
    views["seeds"][:], views["steps"][:], views["reset"][:] = seeds, steps, reset


def test_packed_fused_step_matches_jax(stacks):
    jp, tp = _pair(stacks)
    jlayout, tlayout = _layout(JPK), _layout(PK)
    assert [tuple(f) for f in tlayout.fields] == [tuple(f) for f in jlayout.fields]
    assert tlayout.total == jlayout.total
    jstep = jp.make_fused_step("greedy", JSPEC, JCFG, "toilet", layout=jlayout)
    tstep = tp.make_fused_step("greedy", SPEC, CFG, "toilet", layout=tlayout)
    jfresh = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2, *x.shape)), JITM.create_state(JSPEC, JCFG))
    jstate = jax.tree_util.tree_map(jnp.copy, jfresh)
    tstate = ITM.create_state(SPEC, CFG, batch=2, device="cpu")
    buf = np.zeros(tlayout.total, np.uint8)
    views = PK.pack_views(buf, tlayout)
    for obs, seeds, steps, reset in _dispatches():
        _fill(views, obs, seeds, steps, reset)
        jout, jstate = jstep(jstate, jfresh, jnp.asarray(buf))
        tout, tstate = tstep(tstate, None, torch.from_numpy(buf.copy()))
        jout, tout = np.asarray(jout), tout.numpy()
        assert tout.shape == (2, 4) and tout.dtype == np.float32
        np.testing.assert_array_equal(tout[:, :2], jout[:, :2])  # actions, target_detected
        np.testing.assert_allclose(tout[:, 2:], jout[:, 2:], atol=GOAL_ATOL, rtol=0)
    np.testing.assert_array_equal(tstate.steps.numpy(), np.asarray(jstate.steps))  # lane 1 restarted
    assert tstate.steps.tolist() == [2, 1]


def test_run_full_stack_episode_matches_jax(stacks):
    jp, tp = _pair(stacks)
    env_kw = dict(width=W, height=H, max_steps=EPISODE_STEPS)
    jres, _ = JFS.run_full_stack_episode(JENV.FakeObjectNavEnv(JENV.open_room_plan(seed=1), JENV.EnvConfig(**env_kw)),
                                         JSPEC, JCFG, perception=jp, seed=1)
    tres, stats = FS.run_full_stack_episode(
        TENV.FakeObjectNavEnv(TENV.open_room_plan(seed=1), TENV.EnvConfig(**env_kw)), SPEC, CFG, perception=tp, seed=1,
        device="cpu")
    assert stats.env_steps == tres.steps == jres.steps == EPISODE_STEPS
    for name in ("success", "target_detected", "target_seen", "failure_cause", "called_stop", "collisions"):
        assert getattr(tres, name) == getattr(jres, name), name
    for name in ("spl", "soft_spl", "path_length", "distance_to_goal"):
        assert abs(getattr(tres, name) - getattr(jres, name)) <= SPL_ATOL, name


def _states_equal(a, b) -> bool:
    flat = lambda s: [t for f in s for t in (f if isinstance(f, tuple) else (f,))]  # noqa: E731
    return all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))


@pytest.mark.parametrize("compressed", [False, True], ids=["f32", "u16-half"])
def test_packed_equals_unpacked_bit_for_bit(stacks, compressed):
    _, tp = _pair(stacks)
    layout = _layout(PK, compressed=compressed)
    packed = tp.make_fused_step("greedy", SPEC, CFG, "fireplace", layout=layout)
    unpacked = tp.make_fused_step("greedy", SPEC, CFG, "fireplace")
    sp = ITM.create_state(SPEC, CFG, batch=2, device="cpu")
    su = ITM.create_state(SPEC, CFG, batch=2, device="cpu")
    buf = np.zeros(layout.total, np.uint8)
    views = PK.pack_views(buf, layout)
    for obs, seeds, steps, reset in _dispatches():
        _fill(views, obs, seeds, steps, reset)
        out, sp = packed(sp, None, torch.from_numpy(buf.copy()))
        action, detected, goal, su = unpacked(su, None, *(views[n].copy() for n in
                                                          ("reset", "depth", "heading", "xy", "rgb", "seeds", "steps")))
        assert torch.equal(out[:, 0], action.float()) and torch.equal(out[:, 1], detected.float())
        assert torch.equal(out[:, 2:], goal)
        assert _states_equal(sp, su)


def test_fused_step_is_cached_and_reads_the_models_at_each_call():
    tp = FS.FullStackPerception(CFG, device="cpu")
    layout = _layout(PK)
    step = tp.make_fused_step("greedy", SPEC, CFG, "toilet", layout=layout)
    assert tp.make_fused_step("greedy", SPEC, CFG, "toilet", layout=layout) is step
    assert tp.make_fused_step("greedy", SPEC, CFG, "fireplace", layout=layout) is not step
    buf = np.zeros(layout.total, np.uint8)
    _fill(PK.pack_views(buf, layout), *_dispatches()[0])
    values = []
    for seed in (0, 1):  # the ITM weights change after the first call
        if seed:
            other = B.BLIP2ITM.init_random(B.BLIP2ITMConfig.tiny(), seed=1, device="cpu")
            tp.itm.module.load_state_dict(other.module.state_dict())
            tp.engine._text_feat_cache.clear()
        _, st = step(ITM.create_state(SPEC, CFG, batch=2, device="cpu"), None, torch.from_numpy(buf))
        values.append(st.value.values.clone())
    assert not torch.equal(values[0], values[1])


@pytest.mark.parametrize("kw", [dict(cfg_vqa=True), dict(vqa=object()), dict(blip2_vqa=object()),
                                dict(monodepth=object())], ids=["use_vqa", "vqa", "blip2_vqa", "monodepth"])
def test_options_not_ported_raise(kw):
    """The VQA veto and the monocular-depth fallback are ported; what
    remains is refused with a ValueError: a bare T5 without its
    ``image_prefix`` (use_vqa), a veto model without ``cfg.use_vqa`` (vqa,
    blip2_vqa), a depth model without ``infer_depth`` (monodepth)."""
    use_vqa = kw.pop("cfg_vqa", False)
    if use_vqa:
        kw = dict(vqa=object())
    cfg = dataclasses.replace(CFG, use_vqa=use_vqa)
    with pytest.raises(ValueError):
        FS.FullStackPerception(cfg, device="cpu", **kw)


def test_defaults_are_the_tiny_models_and_call_returns_numpy():
    tp = FS.FullStackPerception(CFG, device="cpu")
    assert tp.itm.cfg == B.BLIP2ITMConfig.tiny()
    assert tp.pipeline.detector.cfg == O.OwlViTDetConfig.tiny()
    assert tp.pipeline.sam.cfg == S.SamConfig.tiny_mobile_sam()
    assert tp.tokenizer.max_len == 8
    assert tp.pipeline.non_coco_threshold == 0.0 and tp.pipeline.coco_threshold == CFG.coco_threshold
    ids, _ = tp.pipeline.encode_queries(["a toilet and a fireplace", "zebra"])
    assert int(ids.min()) >= 1 and int(ids.max()) < tp.pipeline.detector.cfg.text.vocab_size
    depth = np.full((H, W), 0.5, np.float32)
    cos, masks, valid, obj_depth = tp(_frames(1)[0], "toilet", depth)
    assert isinstance(cos, np.ndarray) and masks.shape == (CFG.max_detections_per_frame, H, W)
    assert valid.shape == (CFG.max_detections_per_frame,) and obj_depth is depth


def _avg2x2(img):
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return ((img.astype(np.uint16).reshape(h2, 2, w2, 2, 3).sum(axis=(1, 3)) + 2) >> 2).astype(np.uint8)


def test_jax_object_map_misplaces_half_size_masks():
    """The JAX fault the port avoids: an object in the bottom-right quarter
    of a 96x128 frame, near (depth 0.2) on a far wall (0.9). Its mask at
    half size (as the perception farm's rgb_half hands it to ``step``)
    gives points at the wall's distance; the same mask on the camera grid
    gives the object's."""
    h, w = 96, 128
    cam = JCFG.camera
    depth = np.full((h, w), 0.9, np.float32)
    depth[h // 2:, w // 2:] = 0.2
    half = np.zeros((1, h // 2, w // 2), bool)
    half[0, h // 4:, w // 4:] = True
    full = half.repeat(2, axis=1).repeat(2, axis=2)
    dists = []
    for mask in (full, half):
        st = JOBJ.create(4, 64)
        st = JOBJ.update_batch(st, jax.random.PRNGKey(0), jnp.asarray(depth), jnp.asarray(mask),
                               jnp.ones(1, bool), jnp.eye(4), cam.min_depth, cam.max_depth, cam.fx, cam.fy)
        pts, ok = np.asarray(st.points[0]), np.asarray(st.point_valid[0])
        assert ok.any()
        dists.append(float(np.median(pts[ok, 0])))  # the camera's forward axis: depth
    near = cam.min_depth + 0.2 * (cam.max_depth - cam.min_depth)
    far = cam.min_depth + 0.9 * (cam.max_depth - cam.min_depth)
    assert abs(dists[0] - near) < 1e-3, dists  # the camera-grid mask: the object
    assert abs(dists[1] - far) < 1e-3, dists  # the half-size mask: the wall behind it


def test_half_size_frames_give_camera_grid_masks(stacks):
    """The port brings masks of half-size frames to the camera grid before
    ``step``: SAM's output resampled to (H, W), as for a full-size frame."""
    _, tp = _pair(stacks)
    rgb = torch.from_numpy(np.stack([_avg2x2(f) for f in _frames(2)]))
    masks, valid, _ = tp.pipeline(rgb, "fireplace", (H, W))
    assert masks.shape == (2, CFG.max_detections_per_frame, H, W) and valid.any()
    small, valid_small, _ = tp.pipeline(rgb, "fireplace")
    assert small.shape[-2:] == (H // 2, W // 2) and torch.equal(valid, valid_small)
    same, _, _ = tp.pipeline(torch.from_numpy(_frames(2)), "fireplace", (H, W))
    assert torch.equal(same, tp.pipeline(torch.from_numpy(_frames(2)), "fireplace")[0])
    # the unpacked fused step on half-size RGB and half-size u16 depth
    step = tp.make_fused_step("greedy", SPEC, CFG, "fireplace")
    obs = [e.reset() for e in _envs(TENV, (0, 1))]
    depth = np.stack([(o["depth"].reshape(H // 2, 2, W // 2, 2).mean(axis=(1, 3)) * 65535 + 0.5).astype(np.uint16)
                      for o in obs])
    action, _, goal, st = step(ITM.create_state(SPEC, CFG, batch=2, device="cpu"), None, np.zeros(2, np.uint8),
                               depth, np.float32([o["heading"] for o in obs]), np.stack([o["robot_xy"] for o in obs]),
                               rgb.numpy(), np.int32([0, 1]), np.int32([0, 0]))
    assert action.tolist() == [ITM.TURN_LEFT] * 2 and bool(torch.isfinite(goal).all())
    assert st.obstacle.explored.any()


# --- the VQA veto and the monocular-depth fallback ---------------------------------
@pytest.fixture(scope="module")
def vqa_bridges():
    from tests.test_torch_blip2_vqa import bridges

    return bridges()


def _vqa_pair(stacks, vqa_bridges, capacity=None, yes=42):
    jmodels, tmodels = stacks
    jb, tb = vqa_bridges
    jcfg = dataclasses.replace(JCFG, use_vqa=True, vqa_slot_capacity=capacity)
    return (JFS.FullStackPerception(jcfg, **jmodels, blip2_vqa=jb, yes_token_id=yes),
            FS.FullStackPerception(port_config(jcfg), **tmodels, blip2_vqa=tb, yes_token_id=yes, device="cpu"))


@pytest.fixture(scope="module")
def yes_token(stacks, vqa_bridges):
    """The port's first answer on the first valid slot of the test frames."""
    _, tp = _vqa_pair(stacks, vqa_bridges)
    t5, answers = tp.vqa_bridge.t5, []
    generate = t5.generate
    t5.generate = lambda *a, **kw: answers.append(generate(*a, **kw)) or answers[-1]
    try:
        tp.batch(_frames(), "toilet")
    finally:
        t5.generate = generate
    _, _, valid = _pair(stacks)[1].batch(_frames(), "toilet")  # the detections the veto was asked about
    return int(answers[0][:, 0].reshape(valid.shape)[valid][0])


@pytest.mark.parametrize("target,capacity", [("toilet", None), ("fireplace", 2)])
def test_vqa_batch_matches_jax(stacks, vqa_bridges, yes_token, target, capacity):
    jp, tp = _vqa_pair(stacks, vqa_bridges, capacity, yes_token)
    rgb = _frames()
    jc, jm, jv = jp.batch(rgb, target)
    tc, tm, tv = tp.batch(rgb, target)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=COS_ATOL, rtol=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert float(np.mean(tm.numpy() != np.asarray(jm))) <= MASK_FLIPS
    _, plain = _pair(stacks)
    _, _, pv = plain.batch(rgb, target)
    assert not (tv & ~pv).any(), "the veto only narrows"
    if target == "toilet":
        assert tv.any() and (pv & ~tv).any(), "the veto keeps some detections and drops others"


def test_vqa_packed_fused_step_matches_jax(stacks, vqa_bridges, yes_token):
    jp, tp = _vqa_pair(stacks, vqa_bridges, 2, yes_token)
    jlayout, tlayout = _layout(JPK), _layout(PK)
    jstep = jp.make_fused_step("greedy", JSPEC, JCFG, "toilet", layout=jlayout)
    tstep = tp.make_fused_step("greedy", SPEC, CFG, "toilet", layout=tlayout)
    jfresh = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (2, *x.shape)), JITM.create_state(JSPEC, JCFG))
    jstate = jax.tree_util.tree_map(jnp.copy, jfresh)
    tstate = ITM.create_state(SPEC, CFG, batch=2, device="cpu")
    buf = np.zeros(tlayout.total, np.uint8)
    views = PK.pack_views(buf, tlayout)
    for obs, seeds, steps, reset in _dispatches():
        _fill(views, obs, seeds, steps, reset)
        jout, jstate = jstep(jstate, jfresh, jnp.asarray(buf))
        tout, tstate = tstep(tstate, None, torch.from_numpy(buf.copy()))
        jout, tout = np.asarray(jout), tout.numpy()
        np.testing.assert_array_equal(tout[:, :2], jout[:, :2])
        np.testing.assert_allclose(tout[:, 2:], jout[:, 2:], atol=GOAL_ATOL, rtol=0)
    np.testing.assert_array_equal(tstate.objmap.cursor.numpy(), np.asarray(jstate.objmap.cursor))


def test_vqa_run_full_stack_episode_matches_jax(stacks, vqa_bridges, yes_token):
    jp, tp = _vqa_pair(stacks, vqa_bridges, None, yes_token)
    env_kw = dict(width=W, height=H, max_steps=EPISODE_STEPS // 2)
    jres, _ = JFS.run_full_stack_episode(JENV.FakeObjectNavEnv(JENV.open_room_plan(seed=1), JENV.EnvConfig(**env_kw)),
                                         JSPEC, JCFG, perception=jp, seed=1)
    tres, _ = FS.run_full_stack_episode(
        TENV.FakeObjectNavEnv(TENV.open_room_plan(seed=1), TENV.EnvConfig(**env_kw)), SPEC, CFG, perception=tp, seed=1,
        device="cpu")
    assert tres.steps == jres.steps == EPISODE_STEPS // 2
    for name in ("success", "target_detected", "target_seen", "failure_cause", "called_stop", "collisions"):
        assert getattr(tres, name) == getattr(jres, name), name
    for name in ("spl", "soft_spl", "path_length", "distance_to_goal"):
        assert abs(getattr(tres, name) - getattr(jres, name)) <= SPL_ATOL, name


@pytest.fixture(scope="module")
def depth_models():
    from vlfm_tpu.models import zoedepth as JZ
    from vlfm_tpu_torch.models import zoedepth as Z

    p = numpy_params(JZ.ZoeDepthModule(JZ.ZoeDepthJaxConfig.tiny_test()), jnp.zeros((1, 64, 64, 3)), seed=2)
    return (JZ.ZoeDepth(JZ.ZoeDepthJaxConfig.tiny_test(), jax.tree_util.tree_map(jnp.asarray, p)),
            Z.ZoeDepth.from_jax_params(Z.ZoeDepthConfig.tiny_test(), p, device="cpu"))


def test_monodepth_triggers_on_all_ones(stacks, depth_models):
    jmodels, tmodels = stacks
    jz, tz = depth_models
    jp = JFS.FullStackPerception(JCFG, **jmodels, monodepth=jz)
    tp = FS.FullStackPerception(CFG, **tmodels, monodepth=tz, device="cpu")
    rgb = _frames(1)[0]
    ones = np.ones((H, W), np.float32)
    _, _, valid, obj_depth = tp(rgb, "toilet", ones)
    _, _, jvalid, jdepth = jp(rgb, "toilet", ones)
    assert valid.any() and np.array_equal(valid, np.asarray(jvalid)), "the trigger needs a valid detection"
    assert obj_depth.shape == ones.shape and not np.all(obj_depth == 1.0), "depth was not inferred"
    assert obj_depth.min() >= 0.0 and obj_depth.max() <= 1.0
    np.testing.assert_allclose(obj_depth, np.asarray(jdepth), atol=1e-6, rtol=0)
    sensor = np.random.default_rng(2).uniform(0, 1, (H, W)).astype(np.float32)
    assert tp(rgb, "toilet", sensor)[3] is sensor, "sensor depth must pass through untouched"
    assert tp(rgb, "toilet", None)[3] is None


class _NoDepthCamera:
    """An environment whose camera gives all-ones depth, as the robot's RGB
    gripper camera does."""

    def __init__(self, env):
        self.env = env

    def _ones(self, o):
        return dict(o, depth=np.ones_like(o["depth"]))

    def reset(self):
        return self._ones(self.env.reset())

    def step(self, action):
        return self._ones(self.env.step(action))

    def __getattr__(self, name):
        return getattr(self.env, name)


def test_episode_passes_inferred_depth_only(stacks, depth_models, monkeypatch):
    jmodels, tmodels = stacks
    jz, tz = depth_models
    jp = JFS.FullStackPerception(JCFG, **jmodels, monodepth=jz)
    tp = FS.FullStackPerception(CFG, **tmodels, monodepth=tz, device="cpu")
    env_kw = dict(width=W, height=H, max_steps=EPISODE_STEPS // 2)
    seen, step = [], FS.itm.step

    def spy(state, obs, cos, masks, valid, keys, object_depth=None, **kw):
        seen.append((bool(valid.any()), object_depth))
        return step(state, obs, cos, masks, valid, keys, object_depth, **kw)

    monkeypatch.setattr(FS.itm, "step", spy)
    for camera in (lambda e: e, _NoDepthCamera):
        seen.clear()
        jres, _ = JFS.run_full_stack_episode(
            camera(JENV.FakeObjectNavEnv(JENV.open_room_plan(seed=1), JENV.EnvConfig(**env_kw))), JSPEC, JCFG,
            perception=jp, seed=1)
        tres, _ = FS.run_full_stack_episode(
            camera(TENV.FakeObjectNavEnv(TENV.open_room_plan(seed=1), TENV.EnvConfig(**env_kw))), SPEC, CFG,
            perception=tp, seed=1, device="cpu")
        for name in ("steps", "success", "target_detected", "failure_cause", "collisions"):
            assert getattr(tres, name) == getattr(jres, name), name
        assert abs(tres.path_length - jres.path_length) <= SPL_ATOL
        inferred = [d is not None for _, d in seen]
        assert len(seen) == EPISODE_STEPS // 2
        if camera is _NoDepthCamera:
            assert inferred == [v for v, _ in seen] and any(inferred)
            assert all(d.shape == (1, H, W) and not torch.all(d == 1.0) for _, d in seen if d is not None)
        else:
            assert not any(inferred)
