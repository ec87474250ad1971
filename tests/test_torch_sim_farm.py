"""vlfm_tpu_torch's streamed farm, its ring and its host records, on the CPU.

Against vlfm_tpu's host code (which imports no jax): the observation and
result records are the same bytes for every transport flag (the port's
numpy box averages against JAX's cv2.INTER_AREA path), the packed layouts
have JAX's offsets where every field is 1, 2 or 4 bytes wide (an 8-byte
field is aligned to 8). Port against port, at
tests/test_farm_full_stack.py's small configuration (48x64 frames, a 512 px
map) and 16 steps per episode: the oracle farm equals
``run_episodes_recycled``; the model-perception farm equals
``run_full_stack_episode`` per seed; the compressed transport (u16
half-size depth, half-size RGB) runs its episodes to the end, oracle-scored
and with the models. Ring names carry the process id and the test's name,
every farm unlinks its rings when it returns, and the default names are
unique to a process and a call.
"""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from tests.test_torch_step import one_torch_thread, port_config, port_spec  # noqa: F401
from vlfm_tpu.config import CameraConfig as JCamera
from vlfm_tpu.config import VLFMConfig as JConfig
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.runner import packing as JPK
from vlfm_tpu.runner import sim_farm as JSF
from vlfm_tpu_torch.runner import obsring as RING
from vlfm_tpu_torch.runner import packing as PK
from vlfm_tpu_torch.runner import sim_farm as SF
from vlfm_tpu_torch.runner.episode_driver import run_episodes_recycled
from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, TURN_LEFT, open_room_plan
from vlfm_tpu_torch.runner.full_stack import FullStackPerception, run_full_stack_episode

JCFG = JConfig(camera=JCamera(height=48, width=64), max_frontiers=16, max_frontier_cells=256,
               object_map_slots=8, object_map_points_per_slot=128, max_detections_per_frame=4)
CFG, SPEC = port_config(JCFG), port_spec(JGrid(size=512, pixels_per_meter=20, pad=160))
H, W = 48, 64
ENV = EnvConfig(width=W, height=H, max_steps=16)
SEEDS = [0, 1, 2]  # three episodes on two lanes: one lane is recycled
SPL_ATOL = 1e-6
FLAGS = ("rgb", "depth_u16", "rgb_half", "depth_half")


def ring_prefix(name: str) -> str:
    return f"vlfm_t{os.getpid()}_{name}"


def farm(seeds, **kw):
    return SF.run_episodes_farm(seeds, lanes=2, pointnav="greedy", spec=SPEC, cfg=CFG, plan_name="open_room_plan",
                                env_cfg=ENV, workers=2, **kw)


def assert_same_results(got, want):
    for name in ("success", "steps", "target_detected", "target_seen", "failure_cause", "called_stop", "collisions"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("spl", "soft_spl", "path_length", "distance_to_goal"):
        assert abs(getattr(got, name) - getattr(want, name)) <= SPL_ATOL, name


def _observation(seed=1, turns=5):
    env = FakeObjectNavEnv(open_room_plan(seed=seed), EnvConfig(width=W, height=H, max_steps=40))
    o = env.reset()
    for _ in range(turns):
        o = env.step(TURN_LEFT)
    return env, o


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=4)),
                         ids=lambda f: "-".join(n for n, on in zip(FLAGS, f) if on) or "plain")
def test_obs_records_are_jaxs_bytes(flags):
    kw = dict(zip(FLAGS, flags))
    _, o = _observation()
    assert o["target_mask"].any()
    rec = SF.pack_obs(5, 3, 7, o, **kw)
    assert rec == JSF.pack_obs(5, 3, 7, o, **kw)
    assert len(rec) == SF.obs_slot_bytes(H, W, **kw) == JSF.obs_slot_bytes(H, W, **kw)
    assert SF.record_kind(rec) == SF.KIND_OBS
    got = SF.unpack_obs(rec, H, W, **kw)
    want = JSF.unpack_obs(rec, H, W, **kw)
    assert set(got) == set(want)
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)


def test_box_averages_match_jaxs_cv2():
    pytest.importorskip("cv2")
    assert JSF._cv2 is not None  # JAX's records go through cv2.INTER_AREA here
    rng = np.random.default_rng(0)
    for h, w in ((48, 64), (480, 640)):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        d = rng.random((h, w), np.float32)
        np.testing.assert_array_equal(SF._avg2x2_u8(img), JSF._avg2x2_u8(img))
        np.testing.assert_array_equal(SF._avg2x2_f32(d), JSF._avg2x2_f32(d))


def test_result_and_action_records_are_jaxs_bytes():
    env, o = _observation()
    env.step(TURN_LEFT)
    rec = SF.pack_result(1, 3, env, True, o["distance_to_goal"], env.shortest_path_length())
    assert rec == JSF.pack_result(1, 3, env, True, o["distance_to_goal"], env.shortest_path_length())
    assert SF.record_kind(rec) == JSF.record_kind(rec) == SF.KIND_RESULT
    for name in ("_OBS_HEAD", "_ACT_REC", "_RES_REC"):
        assert getattr(SF, name).format == getattr(JSF, name).format
    assert (SF.FLAG_DONE, SF.FLAG_TARGET_VISIBLE, SF.KIND_OBS, SF.KIND_RESULT) == (
        JSF.FLAG_DONE, JSF.FLAG_TARGET_VISIBLE, JSF.KIND_OBS, JSF.KIND_RESULT)


def _farm_specs(rgb, depth_dtype, half):
    dh, dw = (H // 2, W // 2) if half else (H, W)
    specs = [("depth", depth_dtype, (2, dh, dw))]
    specs += [("rgb", "uint8", (2, dh, dw, 3))] if rgb else [
        ("cos", "float32", (2, 1)), ("bits", "uint8", (2, (H * W + 7) // 8)), ("valid0", "uint8", (2,))]
    return specs + [("heading", "float32", (2,)), ("xy", "float32", (2, 2)), ("seeds", "int32", (2,)),
                    ("steps", "int32", (2,)), ("reset", "uint8", (2,))]


@pytest.mark.parametrize("rgb,depth_dtype,half", list(itertools.product((False, True), ("float32", "uint16"),
                                                                        (False, True))))
def test_farm_layouts_have_jaxs_offsets(rgb, depth_dtype, half):
    specs = _farm_specs(rgb, depth_dtype, half)
    got, want = PK.build_layout(specs), JPK.build_layout(specs)
    assert [tuple(f) for f in got.fields] == [tuple(f) for f in want.fields] and got.total == want.total


def test_eight_byte_fields_are_aligned_and_unpack_is_views():
    layout = PK.build_layout([("flag", "uint8", (3,)), ("t", "float64", (2,)), ("d", "uint16", (3,)),
                              ("x", "float32", (2,)), ("n", "int64", (1,))])
    assert [f.offset for f in layout.fields] == [0, 8, 24, 32, 40] and layout.total == 48
    assert JPK.build_layout([("flag", "uint8", (3,)), ("t", "float64", (2,))]).fields[1].offset == 4  # JAX's
    buf = np.zeros(layout.total, np.uint8)
    views = PK.pack_views(buf, layout)
    rng = np.random.default_rng(0)
    for v in views.values():
        v[...] = rng.integers(0, 200, v.shape).astype(v.dtype) if v.dtype.kind in "iu" else rng.normal(size=v.shape)
    dev = torch.from_numpy(buf)
    out = PK.unpack_device(layout, dev)
    for f in layout.fields:
        t = out[f.name]
        assert t.data_ptr() == dev.data_ptr() + f.offset  # a view, no copy
        np.testing.assert_array_equal(t.numpy(), views[f.name])
        assert t.numpy().dtype == views[f.name].dtype
    with pytest.raises(ValueError):
        PK.pack_views(np.zeros(layout.total + 4, np.uint8), layout)


def test_ring_round_trip_in_order():
    assert RING.ObservationRing.available()
    name = ring_prefix("ring")
    ring = RING.ObservationRing.create(name, slot_bytes=64, n_slots=8)
    try:
        producer = RING.ObservationRing.open(name)
        assert (producer.slot_bytes, producer.n_slots) == (64, 8)
        tickets = [producer.push(bytes([i]) * (i + 1)) for i in range(5)]
        assert tickets == list(range(5))
        got = ring.poll_batch(max_records=3) + ring.poll_batch(max_records=8)
        assert got == [(i, bytes([i]) * (i + 1)) for i in range(5)]
        assert ring.poll_batch() == []
        with pytest.raises(ValueError, match="exceeds slot size"):
            producer.push(bytes(65))
        producer.close()
    finally:
        ring.close()
    with pytest.raises(RuntimeError, match="obsring_open"):
        RING.ObservationRing.open(name)  # the owner unlinked it


def test_ring_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(RING, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "g++-does-not-exist")
    with pytest.raises((RuntimeError, OSError), match="g\\+\\+-does-not-exist"):
        RING.build()
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(RING, "SOURCE", broken)
    monkeypatch.delenv("CXX")
    with pytest.raises(RuntimeError, match="obsring build failed") as err:
        RING.build()
    assert "broken.cpp" in str(err.value)


@pytest.fixture(scope="module")
def recycled():
    results, _ = run_episodes_recycled(lambda s: FakeObjectNavEnv(open_room_plan(seed=s), ENV), SEEDS, lanes=2,
                                       pointnav="greedy", spec=SPEC, cfg=CFG, device="cpu")
    return results


def test_oracle_farm_equals_recycled_driver(recycled):
    results, stats = farm(SEEDS, ring_prefix=ring_prefix("oracle"), device="cpu")
    assert set(results) == set(SEEDS)
    assert stats.env_steps == sum(r.steps for r in results.values())
    assert stats.dispatches >= stats.env_steps // 2  # one dispatch steps both lanes
    assert stats.bytes_put > 0 and stats.bytes_put % stats.dispatches == 0  # one copy of one layout each
    for s in SEEDS:
        assert_same_results(results[s], recycled[s])
    assert any(r.target_detected for r in results.values())  # the oracle target mask reached the object map


def test_sharding_raises():
    """``sharding=`` is ported (tests/test_torch_mesh.py holds the sharded
    farm to the unsharded one); what is not an episode sharding of a
    ``parallel.mesh`` still raises, before any worker starts."""
    from vlfm_tpu_torch.parallel import mesh as M

    with pytest.raises(TypeError, match="episode_sharding"):
        farm(SEEDS, sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="episode_sharding"):
        farm(SEEDS, sharding=M.replicated(M.make_mesh(devices=["cpu"] * 2)))


@pytest.fixture(scope="module")
def perception():
    return FullStackPerception(CFG, device="cpu")


def test_perception_farm_equals_full_stack_episodes(perception):
    results, stats = farm(SEEDS, ring_prefix=ring_prefix("fs"), perception=perception)
    assert set(results) == set(SEEDS)
    assert stats.env_steps == sum(r.steps for r in results.values())
    for s in SEEDS:
        single, _ = run_full_stack_episode(FakeObjectNavEnv(open_room_plan(seed=s), ENV), SPEC, CFG,
                                           perception=perception, seed=s, device="cpu")
        assert_same_results(results[s], single)


@pytest.mark.parametrize("scored", ["oracle", "models"])
def test_compressed_transport_farm_runs_to_the_end(perception, scored):
    rgb = scored == "models"
    kw = dict(perception=perception) if rgb else dict(device="cpu")
    results, stats = farm(SEEDS[:2], ring_prefix=ring_prefix(f"c{scored}"), depth_u16=True, rgb_half=True,
                          depth_half=True, **kw)
    assert set(results) == set(SEEDS[:2])
    assert all(r.steps > 0 for r in results.values())
    assert stats.env_steps == sum(r.steps for r in results.values())
    full = SF.obs_slot_bytes(H, W, rgb=rgb)
    assert SF.obs_slot_bytes(H, W, rgb=rgb, depth_u16=True, rgb_half=True, depth_half=True) < full // 2
    assert stats.bytes_put > 0 and stats.t_put > 0.0


def test_farm_config_errors():
    with pytest.raises(ValueError, match="one episode per lane"):
        SF.run_episodes_farm(SEEDS[:1], lanes=2, pointnav="greedy", spec=SPEC, cfg=CFG, device="cpu")
    odd = dataclasses.replace(ENV, width=63)
    with pytest.raises(ValueError, match="even frame sizes"):
        SF.run_episodes_farm(SEEDS, lanes=2, pointnav="greedy", spec=SPEC, cfg=CFG, env_cfg=odd, rgb_half=True,
                             device="cpu")


def test_default_ring_names_are_unique_per_process_and_call(monkeypatch):
    """Two farms started with the default prefix, in one process or in two,
    never meet in /dev/shm: the rings' creation sees names that carry the
    process id and a per-call count."""
    names = []

    class Stop(Exception):
        pass

    def create(name, slot_bytes, n_slots):
        names.append(name)
        raise Stop

    monkeypatch.setattr(SF.ObservationRing, "create", staticmethod(create))
    for _ in range(2):
        with pytest.raises(Stop):
            farm(SEEDS, device="cpu")
    assert len(names) == 2 and names[0] != names[1]
    assert all(n.endswith("_obs") and f"{os.getpid()}_" in n for n in names)
