"""vlfm_tpu_torch's runner utilities, on the CPU: checkpoints, value-map
record and replay, and the step timers.

- ``runner/checkpoint.py``: a mid-episode checkpoint of the robot's state
  (the reality policy's maps, recurrence and key) restores into a fresh
  policy that then acts exactly as the live one; a batched ``itm``
  ``PolicyState`` and a model's ``state_dict`` round-trip bit for bit with
  their dtypes (as tests/test_checkpoint_and_batched.py does in JAX); a
  shape that differs from ``like``'s raises.
- ``mapping/value_map_io.py``: a recording made by JAX's recorder replays
  in the port to JAX's replayed map (within REPLAY_ATOL, but for cone-edge
  cells on an atan2/cos ulp tie, EDGE_FLIP_FRACTION), the port writes
  the same files as JAX's recorder, and the port's replay of its own
  recording equals updates from the recorded (16-bit) depths bit for bit
  and the live map within tests/test_components.py's 2e-4.
- ``utils/profiling.py``: ``StepTimer`` counts and summarises its
  sections, ``time_fn`` and ``force_sync`` take CPU tensors (nothing to
  wait for), and ``trace`` writes a Chrome trace.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_reality import CFG, SPEC, make_env, make_hooks
from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.mapping import value_map as JVM
from vlfm_tpu.mapping import value_map_io as JIO
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.utils.geometry import xyz_yaw_to_tf_matrix as jax_tf
from vlfm_tpu_torch.mapping import value_map as VM
from vlfm_tpu_torch.mapping import value_map_io as IO
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.policy import itm as ITM
from vlfm_tpu_torch.policy import reality as R
from vlfm_tpu_torch.runner.checkpoint import map_tensors, restore_pytree, save_pytree
from vlfm_tpu_torch.utils import profiling as P
from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix

REPLAY_ATOL = 1e-6  # the same inputs through JAX's value map and the port's
EDGE_FLIP_FRACTION = 1e-3  # cone-edge cells on an atan2/cos ulp tie, of the cells updated (test_torch_step.py)
LIVE_ATOL = 2e-4  # tests/test_components.py: 16-bit depth against the live f32 depth
RESUME_AT = R.NUM_INIT_YAWS + 2  # a detection has reached the object map


def _equal_trees(a, b) -> bool:
    flat_a, flat_b = [], []
    map_tensors(flat_a.append, a)
    map_tensors(flat_b.append, b)
    return len(flat_a) == len(flat_b) and all(
        x.dtype == y.dtype and x.device == y.device and torch.equal(x, y) for x, y in zip(flat_a, flat_b))


# --- checkpoints -------------------------------------------------------------
def test_mid_episode_checkpoint_resumes_to_identical_actions(tmp_path):
    env = make_env()
    live = R.RealityITMPolicyV2(SPEC, CFG, device="cpu", **make_hooks())
    obs = env.reset("toilet")
    for _ in range(RESUME_AT):
        obs = env.step(live.get_action(obs))
    assert bool(live.state.objmap.slot_used.any())
    path = save_pytree(str(tmp_path / "robot.pt"), {"state": live.state, "rng": live.rng})
    assert os.path.isabs(path) and os.path.exists(path)

    hooks = make_hooks()  # the same hooks, fast-forwarded to the checkpoint
    for _ in range(RESUME_AT):
        hooks["score_fn"](None), hooks["detect_fn"](np.zeros((2, 2, 3), np.uint8))
    resumed = R.RealityITMPolicyV2(SPEC, CFG, device="cpu", **hooks)
    got = restore_pytree(path, {"state": resumed.state, "rng": resumed.rng})
    assert _equal_trees(got["state"], live.state) and torch.equal(got["rng"], live.rng)
    resumed.state, resumed.rng = got["state"], got["rng"]
    for _ in range(6):
        a, b = live.get_action(obs), resumed.get_action(obs)
        assert a == b
        obs = env.step(a)
    assert _equal_trees(resumed.state, live.state)


def test_batched_policy_state_round_trips_bit_for_bit(tmp_path):
    state = ITM.create_state(GridSpec2D(128, 20, 64), CFG, batch=3, device="cpu")
    gen = torch.Generator().manual_seed(0)

    def fill(t):
        if t.dtype == torch.bool:
            return torch.rand(t.shape, generator=gen) < 0.5
        if t.is_floating_point():
            return torch.randn(t.shape, generator=gen).to(t.dtype)
        return torch.randint(0, 1000, t.shape, generator=gen).to(t.dtype)

    state = map_tensors(fill, state)
    path = save_pytree(str(tmp_path / "batched.pt"), state)
    got = restore_pytree(path, ITM.create_state(GridSpec2D(128, 20, 64), CFG, batch=3, device="cpu"))
    assert type(got) is ITM.PolicyState and type(got.obstacle) is type(state.obstacle)
    assert _equal_trees(got, state)


def test_model_state_dict_round_trips_and_shapes_are_checked(tmp_path):
    src = PN.PointNavPolicy.init_random(3, depth_shape=(48, 64), discrete=False, device="cpu")
    path = save_pytree(str(tmp_path / "pointnav.pt"), src.module.state_dict())
    dst = PN.PointNavPolicy.init_random(4, depth_shape=(48, 64), discrete=False, device="cpu")
    got = restore_pytree(path, dst.module.state_dict())
    assert list(got) == list(src.module.state_dict())
    assert _equal_trees(got, src.module.state_dict())
    other = PN.PointNavPolicy.init_random(4, depth_shape=(96, 128), discrete=False, device="cpu")
    with pytest.raises(ValueError, match="visual_fc"):
        restore_pytree(path, other.module.state_dict())
    with pytest.raises(KeyError):
        restore_pytree(path, {"not_there": torch.zeros(1)})


# --- value-map record and replay ---------------------------------------------
def _updates(n=4, seed=0):
    """(values, depth, pose) of n views from a turning camera."""
    rng = np.random.default_rng(seed)
    for k in range(n):
        yield (np.array([0.3 + 0.1 * k], np.float32), rng.uniform(0.2, 1.0, (48, 64)).astype(np.float32),
               np.array([0.1 * k, -0.05 * k, 0.88], np.float32), np.float32(k * 0.5))


def test_jax_recording_replays_in_the_port(tmp_path):
    jspec, spec = JGrid(size=256, pixels_per_meter=20, pad=160), GridSpec2D(256, 20, 160)
    rec = JIO.ValueMapRecorder(str(tmp_path / "jax"), kwargs={"value_channels": 1})
    for vals, depth, xyz, yaw in _updates():
        rec.record(jnp.asarray(vals), depth, jax_tf(jnp.asarray(xyz), jnp.float32(yaw)), 0.5, 5.0, 1.38)
    want = JIO.replay(str(tmp_path / "jax"), spec=jspec)
    got = IO.replay(str(tmp_path / "jax"), spec=spec, device="cpu")
    assert got.conf.shape == (1, *np.asarray(want.conf).shape)
    allowed = EDGE_FLIP_FRACTION * 4 * 256 * 256  # 4 updates of a 256 x 256 window
    for name in ("conf", "values"):
        far = np.abs(getattr(got, name)[0].numpy() - np.asarray(getattr(want, name))) > REPLAY_ATOL
        assert far.sum() <= allowed, f"{name}: {far.sum()} cells differ (allowed {allowed})"
    assert float(got.conf.max()) > 0


def test_port_recording_is_jax_format_and_replays_exactly(tmp_path):
    spec = GridSpec2D(256, 20, 160)
    port = IO.ValueMapRecorder(str(tmp_path / "port"), kwargs={"value_channels": 1})
    ref = JIO.ValueMapRecorder(str(tmp_path / "jax"), kwargs={"value_channels": 1})
    live = VM.create(spec, 1, device="cpu")
    for vals, depth, xyz, yaw in _updates():
        tf = xyz_yaw_to_tf_matrix(torch.from_numpy(xyz), torch.tensor(yaw))
        port.record(torch.from_numpy(vals), torch.from_numpy(depth), tf, 0.5, 5.0, 1.38)
        ref.record(vals, depth, tf.numpy(), 0.5, 5.0, 1.38)
        live = VM.update(live, spec, torch.from_numpy(vals)[None], torch.from_numpy(depth)[None], tf[None],
                         0.5, 5.0, 1.38)
    for name in sorted(os.listdir(tmp_path / "jax")):
        a, b = (tmp_path / "port" / name).read_bytes(), (tmp_path / "jax" / name).read_bytes()
        assert a == b, name
    assert len(json.loads((tmp_path / "port" / "data.json").read_text())) == 4
    # replay = the same updates from the recorded depths, bit for bit
    want = VM.create(spec, 1, device="cpu")
    for depth, meta in IO.iter_recording(str(tmp_path / "port")):
        want = VM.update(want, spec, torch.tensor([meta["values"]]), torch.from_numpy(depth)[None],
                         torch.tensor([meta["tf_camera_to_episodic"]]), 0.5, 5.0, 1.38)
    got = IO.replay(str(tmp_path / "port"), spec=spec, device="cpu")
    assert torch.equal(got.conf, want.conf) and torch.equal(got.values, want.values)
    torch.testing.assert_close(got.conf, live.conf, atol=LIVE_ATOL, rtol=0)
    torch.testing.assert_close(got.values, live.values, atol=LIVE_ATOL, rtol=0)


def test_all_ones_depth_records_exactly(tmp_path):
    """The robot's value map sees all-ones depth, which the 16-bit PNG
    keeps exactly: replay equals the live map bit for bit."""
    spec = GridSpec2D(256, 20, 160)
    rec = IO.ValueMapRecorder(str(tmp_path))
    live = VM.create(spec, 1, device="cpu")
    ones = torch.ones(1, 48, 64)
    for vals, _, xyz, yaw in _updates():
        tf = xyz_yaw_to_tf_matrix(torch.from_numpy(xyz), torch.tensor(yaw))
        rec.record(vals, ones[0], tf, 0.0, 5.0, 1.38)
        live = VM.update(live, spec, torch.from_numpy(vals)[None], ones, tf[None], 0.0, 5.0, 1.38)
    got = IO.replay(str(tmp_path), spec=spec, device="cpu")
    assert torch.equal(got.conf, live.conf) and torch.equal(got.values, live.values)


# --- profiling ---------------------------------------------------------------
def test_step_timer_counts_and_summarises():
    timer = P.StepTimer()
    x = torch.ones(8)
    for k in range(3):
        with timer.section("step", sync_on=x):
            x = x + k
        if k < 2:
            with timer.section("render"):
                pass
    summary = timer.summary()
    assert set(summary) == {"step", "render"}
    assert summary["step"]["count"] == 3 and summary["render"]["count"] == 2
    for row in summary.values():
        assert set(row) == {"count", "mean_ms", "p50_ms", "max_ms"}
        assert 0 <= row["p50_ms"] <= row["max_ms"] and row["mean_ms"] <= row["max_ms"]
    assert len(timer.samples["step"]) == 3 and min(timer.samples["step"]) >= 0


def test_time_fn_force_sync_and_trace_on_the_cpu(tmp_path):
    calls = []

    def fn(a):
        calls.append(a)
        return {"out": (a * 2, [a])}

    secs = P.time_fn(fn, torch.ones(4), iters=3, warmup=2)
    assert secs >= 0 and len(calls) == 5
    P.force_sync({"a": torch.zeros(2), "b": None, "c": 3})  # CPU tensors only: nothing to wait for
    P.force_sync(None)
    with P.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
