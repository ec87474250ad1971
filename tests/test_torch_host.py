"""vlfm_tpu_torch's host modules against their vlfm_tpu originals, and the
port's independence from jax and from vlfm_tpu.

The port carries its own ``config``, ``models.tokenizer``,
``models.coco_classes``, ``runner.fake_env``, ``runner.metrics`` and
``utils.measurements``, so that neither the package nor ``chip_smoke.py``
loads anything of the JAX package. Held here: the same config fields and
defaults, the same token ids, the same COCO class table and routing,
bit-identical environment frames along a spin and a walk for every floor
plan, the same shortest paths and oracle actions, the same episode results
and failure causes over a grid of inputs, and the same stairs measure.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vlfm_tpu import config as JCFG
from vlfm_tpu.models import coco_classes as JCOCO
from vlfm_tpu.models import tokenizer as JTOK
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu.runner import metrics as JM
from vlfm_tpu.utils import measurements as JMEAS
from vlfm_tpu_torch import config as CFG
from vlfm_tpu_torch.models import coco_classes as COCO
from vlfm_tpu_torch.models import tokenizer as TOK
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.runner import fake_env as ENV
from vlfm_tpu_torch.runner import metrics as M
from vlfm_tpu_torch.utils import measurements as MEAS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.type) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["CameraConfig", "VLFMConfig"])
def test_config_fields_and_defaults_match_jax(name):
    port, ref = getattr(CFG, name), getattr(JCFG, name)
    assert _fields(port) == _fields(ref)
    got, want = dataclasses.asdict(port()), dataclasses.asdict(ref())
    assert got == want


def test_config_derived_values_match_jax():
    kw = dict(text_prompt="a target_object|another target_object", map_size=512)
    port, ref = CFG.VLFMConfig(**kw), JCFG.VLFMConfig(**kw)
    assert port.value_channels == ref.value_channels == 2
    for attr in ("hfov", "fx", "fy", "object_map_cone_fov"):
        assert getattr(port.camera, attr) == getattr(ref.camera, attr)


@pytest.mark.parametrize("max_len", [8, 32])
def test_tokenizer_ids_match_jax(max_len):
    extra = ["chair", "##s", "seems", "like"]
    texts = [
        "Seems like there is a chair ahead.",
        "  CHAIRS, beds; and a sofa!  ",
        "",
        "x" * 40,
        "zebra-crossing #1",
    ]
    got_ids, got_mask = TOK.WordPieceTokenizer(TOK.toy_vocab(extra), max_len).encode_batch(texts)
    want_ids, want_mask = JTOK.WordPieceTokenizer(JTOK.toy_vocab(extra), max_len).encode_batch(texts)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert got_ids.dtype == torch.int32


def test_tokenizer_unknown_word_matches_jax():
    vocab = {"[CLS]": 0, "[SEP]": 1, "[PAD]": 2, "[UNK]": 3, "ab": 4, "##c": 5}
    for text in ("abc", "abd", "ab ab c"):
        assert TOK.WordPieceTokenizer(vocab).encode(text) == JTOK.WordPieceTokenizer(vocab).encode(text)


def test_tokenizer_from_vocab_file_matches_jax(tmp_path):
    """A BERT vocab.txt (one token per line, blank and repeated lines too)
    read by both packages: the same vocabulary and ids."""
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join([*TOK.toy_vocab(["chair", "##s", "toilet"]), "", "chair", "caf\u00e9"]) + "\n",
                     encoding="utf-8")
    texts = ["Seems like there is a chair ahead.", "toilets", "caf\u00e9 chairs", ""]
    got, want = TOK.WordPieceTokenizer.from_vocab_file(str(vocab), 12), JTOK.WordPieceTokenizer.from_vocab_file(
        str(vocab), 12)
    assert got.vocab == want.vocab and got.max_len == want.max_len == 12
    assert (got.cls_id, got.sep_id, got.pad_id, got.unk_id) == (want.cls_id, want.sep_id, want.pad_id, want.unk_id)
    got_ids, got_mask = got.encode_batch(texts)
    want_ids, want_mask = want.encode_batch(texts)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert TOK.WordPieceTokenizer.from_vocab_file(str(vocab)).max_len == 32


def test_coco_classes_match_jax():
    assert COCO.COCO_CLASSES == JCOCO.COCO_CLASSES
    assert len(COCO.COCO_CLASSES) == 80


@pytest.mark.parametrize("target", ["toilet", "toilet|bed", "fireplace", "fireplace|couch", "tv|remote"])
def test_is_coco_target_matches_jax(target):
    assert COCO.is_coco_target(target) == JCOCO.is_coco_target(target)
    assert COCO.is_coco_target(target) is (target != "fireplace")


PLANS = ["two_room_plan", "furnished_room_plan", "stairs_plan", "hidden_stairs_plan", "open_room_plan"]


def _walk(port, ref, actions):
    pairs = [(port.reset(), ref.reset())]
    pairs += [(port.step(a), ref.step(a)) for a in actions]
    assert port.collisions == ref.collisions
    assert port.path_length == ref.path_length
    for got, want in pairs:
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    return pairs


@pytest.mark.parametrize("seed", [0, 3])
def test_fake_env_frames_match_jax(seed):
    """A spin, a walk into the far wall (with collisions) and a stop."""
    cfg = dict(width=96, height=72, max_steps=40)
    port = ENV.FakeObjectNavEnv(ENV.two_room_plan(seed), ENV.EnvConfig(**cfg))
    ref = JENV.FakeObjectNavEnv(JENV.two_room_plan(seed), JENV.EnvConfig(**cfg))
    assert dataclasses.asdict(port.plan) == dataclasses.asdict(ref.plan)
    actions = [ENV.TURN_LEFT] * 11 + [ENV.TURN_RIGHT] * 2 + [ENV.MOVE_FORWARD] * 24 + [ENV.STOP]
    pairs = _walk(port, ref, actions)
    assert port.collisions > 0
    assert pairs[-1][0]["done"]


@pytest.mark.parametrize("plan", PLANS[1:])
@pytest.mark.parametrize("seed", [0, 5])
def test_other_floor_plans_give_jaxs_frames(plan, seed):
    """Each other floor plan: the same plan, and bit-equal frames along a
    walk, a half spin and a walk back (the stairs plans raise ``agent_z``)."""
    cfg = dict(width=96, height=72, max_steps=40)
    port = ENV.FakeObjectNavEnv(getattr(ENV, plan)(seed), ENV.EnvConfig(**cfg))
    ref = JENV.FakeObjectNavEnv(getattr(JENV, plan)(seed), JENV.EnvConfig(**cfg))
    assert dataclasses.asdict(port.plan) == dataclasses.asdict(ref.plan)
    pairs = _walk(port, ref, [ENV.MOVE_FORWARD] * 10 + [ENV.TURN_LEFT] * 6 + [ENV.MOVE_FORWARD] * 10
                  + [ENV.TURN_RIGHT] * 3)
    if "stairs" in plan:
        assert max(o["agent_z"] for o, _ in pairs) > 0


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("seed", [0, 1])
def test_shortest_path_and_oracle_action_match_jax(plan, seed):
    """The BFS geodesic start-to-target length and feasibility, and the
    oracle's action at every pose of an oracle-driven walk."""
    cfg = dict(width=32, height=24, max_steps=40)
    port = ENV.FakeObjectNavEnv(getattr(ENV, plan)(seed), ENV.EnvConfig(**cfg))
    ref = JENV.FakeObjectNavEnv(getattr(JENV, plan)(seed), JENV.EnvConfig(**cfg))
    assert port.shortest_path_length() == ref.shortest_path_length()
    assert port.path_feasible == ref.path_feasible
    port.reset(), ref.reset()
    for _ in range(30):
        action = port.oracle_action()
        assert action == ref.oracle_action()
        if action == ENV.STOP:
            break
        port.step(action), ref.step(action)
        assert (port.x, port.y, port.yaw) == (ref.x, ref.y, ref.yaw)


def test_traveled_stairs_matches_jax():
    port, ref = MEAS.TraveledStairs(), JMEAS.TraveledStairs()
    assert port.traveled_stairs == ref.traveled_stairs is False
    for z in (0.0, 0.3, 0.95, 0.2, -0.1):
        port.update(z), ref.update(z)
        assert port.traveled_stairs == ref.traveled_stairs
    assert port.traveled_stairs
    port.reset(), ref.reset()
    assert port.traveled_stairs == ref.traveled_stairs is False


_BOOLS = (False, True)


@pytest.mark.parametrize("called_stop,target_detected,target_seen,traveled_stairs,feasible",
                         list(itertools.product(_BOOLS, repeat=5)))
def test_compute_result_and_failure_cause_match_jax(called_stop, target_detected, target_seen, traveled_stairs,
                                                   feasible):
    """Every combination of the taxonomy's flags, at distances inside and
    outside the success radius, with and without a false-positive test and
    an authoritative success."""
    for dist, fp, override in itertools.product((0.4, 2.5), (None, False, True), (None, True)):
        kw = dict(called_stop=called_stop, distance_to_goal=dist, success_radius=1.0, shortest_path=6.0,
                  path_length=7.5, steps=120, max_steps=500, target_detected=target_detected,
                  target_seen=target_seen, collisions=3, false_positive=fp, traveled_stairs=traveled_stairs,
                  feasible=feasible, success_override=override)
        assert dataclasses.asdict(M.compute_result(**kw)) == dataclasses.asdict(JM.compute_result(**kw))
        flags = dict(target_detected=target_detected, false_positive=bool(fp), stop_called=called_stop,
                     target_seen=target_seen, traveled_stairs=traveled_stairs, feasible=feasible)
        assert M.determine_failure_cause(**flags) == JM.determine_failure_cause(**flags)


def test_aggregate_and_json_helpers_match_jax():
    kw = dict(distance_to_goal=2.0, success_radius=1.0, shortest_path=5.0, path_length=6.0, steps=50,
              max_steps=500, target_detected=True, target_seen=True)
    results = [M.compute_result(called_stop=s, **kw) for s in (True, False, True)]
    jresults = [JM.compute_result(called_stop=s, **kw) for s in (True, False, True)]
    assert M.aggregate(results) == JM.aggregate(jresults)
    info = {"a": 1, "b": {"c": 2.5, "d": np.zeros(3), "e": "x"}, "f": [1, 2], "g": None, "h": np.ones(2)}
    assert M.remove_numpy_arrays(info) == JM.remove_numpy_arrays(info)
    assert M.extract_scalars_from_info(info) == JM.extract_scalars_from_info(info)


@pytest.mark.parametrize("target", [(1.0, -2.0), (3.3, 4.1)])
def test_target_seen_and_false_positive_match_jax(target):
    """The map-based seen test on the port's grid (a numpy map and a
    tensor) and the nav-goal test, against JAX's on its grid."""
    from vlfm_tpu.mapping.grid import GridSpec2D as JGrid

    spec, jspec = GridSpec2D(512, 20, 160), JGrid(512, 20, 160)
    explored = np.zeros((832, 832), bool)
    for r0, c0 in ((300, 300), (480, 420)):
        explored[r0:r0 + 40, c0:c0 + 40] = True
    assert M.target_bbox_px(spec, target) == JM.target_bbox_px(jspec, target)
    want = JM.was_target_seen(explored, jspec, target)
    assert M.was_target_seen(explored, spec, target) == want
    assert M.was_target_seen(torch.from_numpy(explored), spec, target) == want
    for goal in ((1.2, -2.1), (0.0, 0.0)):
        assert M.was_false_positive(goal, target, 0.3) == JM.was_false_positive(goal, target, 0.3)


def test_chip_smoke_and_profile_script_import_nothing_of_jax():
    """Every module of the package (a walk, so later modules are covered
    too), ``chip_smoke.py`` and the profile script load neither jax nor
    anything of vlfm_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vlfm_tpu_torch\n"
        "mods = sorted(m.name for m in pkgutil.walk_packages(vlfm_tpu_torch.__path__, 'vlfm_tpu_torch.'))\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for m in ('vlfm_tpu_torch.run', 'vlfm_tpu_torch.runner.imitation', 'vlfm_tpu_torch.adapters.habitat',\n"
        "          'vlfm_tpu_torch.reality.robots', 'vlfm_tpu_torch.reality.envs', 'vlfm_tpu_torch.policy.reality',\n"
        "          'vlfm_tpu_torch.runner.checkpoint', 'vlfm_tpu_torch.mapping.value_map_io',\n"
        "          'vlfm_tpu_torch.utils.profiling', 'vlfm_tpu_torch.runner.weights',\n"
        "          'vlfm_tpu_torch.convert_checkpoints'):\n"
        "    assert m in mods, m\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'scripts')\n"
        "import profile_torch_step\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vlfm_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 60


# Runs in a spawned process, as the farm starts its workers: one episode
# of one lane through the farm's worker loop, then the modules it loaded.
_WORKER_PROBE = """
import sys
from vlfm_tpu_torch.runner import sim_farm
from vlfm_tpu_torch.runner.fake_env import EnvConfig
sim_farm.worker_main(OBS, ACT, [0], [3], "open_room_plan", EnvConfig(width=32, height=24, max_steps=2), 2,
                     True, True, True, True)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "vlfm_tpu", "torch"))
sys.exit(f"the worker loaded {bad}" if bad else 0)
"""


def test_spawned_farm_worker_imports_neither_jax_nor_torch():
    """A farm worker, spawned as ``run_episodes_farm`` spawns it, runs an
    episode (two actions, then its result record) without loading jax,
    vlfm_tpu or torch: nothing in it can open the card."""
    import multiprocessing as mp

    from vlfm_tpu_torch.runner import sim_farm as SF
    from vlfm_tpu_torch.runner.obsring import ObservationRing

    obs_name, act_name = f"vlfm_t{os.getpid()}_probe_obs", f"vlfm_t{os.getpid()}_probe_act"
    obs = ObservationRing.create(obs_name, SF.obs_slot_bytes(24, 32, True, True, True, True), 16)
    act = ObservationRing.create(act_name, SF._ACT_REC.size, 16)
    try:
        code = _WORKER_PROBE.replace("OBS", repr(obs_name)).replace("ACT", repr(act_name))
        proc = mp.get_context("spawn").Process(target=exec, args=(code, {}))
        proc.start()
        kinds = []
        for step in range(3):
            for _ in range(2000):
                got = obs.poll_batch()
                if got:
                    break
                proc.join(0.01)
            assert len(got) == 1, f"no record from the worker at step {step}"
            kinds.append(SF.record_kind(got[0][1]))
            if step < 2:
                act.push(SF._ACT_REC.pack(0, 3, step, ENV.TURN_LEFT))
        proc.join(60)
        assert proc.exitcode == 0
        assert kinds == [SF.KIND_OBS, SF.KIND_OBS, SF.KIND_RESULT]
    finally:
        obs.close()
        act.close()


# --- the evaluation path's host copies -----------------------------------------
from vlfm_tpu.policy import action_replay as JAR  # noqa: E402
from vlfm_tpu.policy import oracle_fbe as JFBE  # noqa: E402
from vlfm_tpu.runner import analyze_logs as JAN  # noqa: E402
from vlfm_tpu.runner import log_saver as JLOG  # noqa: E402
from vlfm_tpu.utils import video as JVID  # noqa: E402
from vlfm_tpu.utils import visualization as JVIS  # noqa: E402
from vlfm_tpu_torch.policy import action_replay as AR  # noqa: E402
from vlfm_tpu_torch.policy import oracle_fbe as FBE  # noqa: E402
from vlfm_tpu_torch.runner import analyze_logs as AN  # noqa: E402
from vlfm_tpu_torch.runner import log_saver as LOG  # noqa: E402
from vlfm_tpu_torch.utils import video as VID  # noqa: E402
from vlfm_tpu_torch.utils import visualization as VIS  # noqa: E402


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read() for name in sorted(os.listdir(d))}


def _ledger(mod, d):
    """Claims, logs and the stale-claim rule through one package, into d."""
    scene = "data/scene_datasets/hm3d/val/abc/abc.basis.glb"
    out = [mod.claim_episode("3", scene, d), mod.claim_episode("3", scene, d), mod.is_evaluated("3", scene, d)]
    mod.log_episode("3", scene, {"success": True, "spl": 0.5, "target_object": "bed"}, d)
    out += [mod.is_evaluated("3", scene, d), mod.claim_episode("3", scene, d)]
    out.append(mod.claim_episode(7, "two_room", d))
    stale = os.path.join(d, "7_two_room.json")
    old = os.stat(stale).st_mtime - mod.STALE_CLAIM_SECONDS - 5
    os.utime(stale, (old, old))
    out += [mod.is_evaluated(7, "two_room", d), os.path.exists(stale), mod.claim_episode(7, "two_room", d)]
    mod.log_episode(9, "two_room", {"success": False, "failure_cause": "timeout", "spl": 0.0}, d)
    return out


def test_log_saver_matches_jax(tmp_path, monkeypatch):
    got, want = _ledger(LOG, str(tmp_path / "port")), _ledger(JLOG, str(tmp_path / "jax"))
    assert got == want == [True, False, True, True, False, True, False, False, True]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    monkeypatch.setenv("ZSOS_LOG_DIR", str(tmp_path / "env"))
    assert LOG.claim_episode("1", "s") and not JLOG.claim_episode("1", "s")


def test_analyze_logs_matches_jax(tmp_path, monkeypatch, capsys):
    d = str(tmp_path)
    rows = [(True, "toilet", None), (False, "toilet", "false_positive"), (False, "bed", "timeout"),
            (False, "bed", "false_positive"), (True, "chair", None)]
    for i, (success, target, cause) in enumerate(rows):
        LOG.log_episode(i, "scene", {"success": success, "spl": 0.3 * i, "soft_spl": 0.1 * i,
                                     "target_object": target, "failure_cause": cause}, d)
    LOG.claim_episode(99, "scene", d)  # an empty claim is skipped
    got, want = AN.load_logs(d), JAN.load_logs(d)
    assert got == want and len(got) == 5
    assert AN.summarize(got) == JAN.summarize(want)
    assert AN.summarize([]) == JAN.summarize([]) == {"episodes": 0}
    outs = []
    for mod in (AN, JAN):
        monkeypatch.setattr(sys, "argv", ["analyze_logs", d])
        mod.main()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]


def test_action_replay_matches_jax(tmp_path):
    actions = [2, 2, 1, 1, 3, 1, 0]
    paths = []
    for mod, sub in ((AR, "port"), (JAR, "jax")):
        rec = mod.ActionRecorder(str(tmp_path / sub))
        for a in actions:
            rec.record(np.int64(a))
        paths.append(rec.flush("ep5"))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    assert AR.repeat_elements(actions, 2) == JAR.repeat_elements(actions, 2)
    for tf, sf in ((1, 1), (2, 1), (1, 3)):
        port, ref = AR.ActionReplayPolicy(paths[0], tf, sf), JAR.ActionReplayPolicy(paths[1], tf, sf)
        assert port.actions == ref.actions
        assert [port.act() for _ in range(len(port.actions) + 2)] == [ref.act() for _ in range(len(ref.actions) + 2)]


def _seeded_maps(seed=0):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 1, (96, 96)).astype(np.float32)
    values[rng.uniform(size=values.shape) < 0.3] = 0.0
    obstacles = rng.uniform(size=(96, 96)) < 0.1
    navigable = rng.uniform(size=(96, 96)) > 0.2
    explored = rng.uniform(size=(96, 96)) < 0.5
    frontiers = rng.integers(0, 96, (5, 2))
    positions = [np.array([0.1 * i, -0.05 * i]) for i in range(8)]
    return values, obstacles, navigable, explored, frontiers, positions


def test_visualization_matches_jax():
    from vlfm_tpu.mapping.grid import GridSpec2D as JGrid

    spec, jspec = GridSpec2D(96, 20, 16), JGrid(96, 20, 16)
    values, obstacles, navigable, explored, frontiers, positions = _seeded_maps()
    traj, jtraj = VIS.TrajectoryVisualizer(spec), JVIS.TrajectoryVisualizer(jspec)
    markers = [(np.array([0.3, 0.2]), {"radius": 4, "color": (0, 255, 0)})]
    got_v = VIS.render_value_map(values, spec, traj=traj, positions=positions, yaw=0.7, markers=markers)
    want_v = JVIS.render_value_map(values, jspec, traj=jtraj, positions=positions, yaw=0.7, markers=markers)
    np.testing.assert_array_equal(got_v, want_v)
    got_o = VIS.render_obstacle_map(obstacles, navigable, explored, frontiers, traj=traj, positions=positions, yaw=1.1)
    want_o = JVIS.render_obstacle_map(obstacles, navigable, explored, frontiers, traj=jtraj, positions=positions,
                                      yaw=1.1)
    np.testing.assert_array_equal(got_o, want_o)
    cloud = np.random.default_rng(1).uniform(-2, 2, (40, 2))
    np.testing.assert_array_equal(VIS.paint_target_cloud(got_o.copy(), spec, cloud, downsample=2),
                                  JVIS.paint_target_cloud(want_o.copy(), jspec, cloud, downsample=2))
    rgb = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    depth = np.random.default_rng(3).uniform(0, 1, (48, 64)).astype(np.float32)
    texts = ["target: toilet", "a much longer line of text that has to wrap across the frame's width " * 2]
    frame = VIS.compose_frame(rgb, depth, [got_v, got_o], texts)
    np.testing.assert_array_equal(frame, JVIS.compose_frame(rgb, depth, [want_v, want_o], texts))
    info = {"success": 1.0, "spl": 0.25, "nested": {"mode": "explore", "dist": 2}, "skip": [1, 2]}
    np.testing.assert_array_equal(VIS.overlay_frame(frame, info, ["extra"]), JVIS.overlay_frame(frame, info, ["extra"]))
    np.testing.assert_array_equal(VIS.rotate_image(got_v, 0.4), JVIS.rotate_image(want_v, 0.4))
    np.testing.assert_array_equal(VIS.reorient_rescale_map(got_o), JVIS.reorient_rescale_map(want_o))


@pytest.mark.parametrize("delayed", [False, True], ids=["aligned", "delayed"])
def test_video_collector_matches_jax_and_writes_a_readable_file(tmp_path, delayed):
    import cv2

    values, obstacles, navigable, explored, _, _ = _seeded_maps(4)
    port, ref = VID.VideoCollector(maps_delayed=delayed), JVID.VideoCollector(maps_delayed=delayed)
    rng = np.random.default_rng(5)
    for t in range(4):
        rgb = rng.integers(0, 256, (30 + 2 * t, 40, 3), dtype=np.uint8)  # ragged heights pad to one size
        depth = rng.uniform(0, 1, rgb.shape[:2]).astype(np.float32)
        maps = [VIS.render_obstacle_map(obstacles, navigable, explored)]
        for coll in (port, ref):
            coll.collect(rgb, depth, maps, [f"step {t}"])
    got, want = port.flush("timeout"), ref.flush("timeout")
    assert len(got) == len(want) == (3 if delayed else 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    path = VID.write_video(got, str(tmp_path / "v.mp4"))
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(got)
    cap.release()


@pytest.mark.parametrize("plan,seed", [("two_room_plan", 0), ("open_room_plan", 1)])
def test_super_oracle_episode_matches_jax(plan, seed):
    cfg = dict(width=32, height=24, max_steps=120)
    got = FBE.run_super_oracle_episode(ENV.FakeObjectNavEnv(getattr(ENV, plan)(seed), ENV.EnvConfig(**cfg)))
    want = JFBE.run_super_oracle_episode(JENV.FakeObjectNavEnv(getattr(JENV, plan)(seed), JENV.EnvConfig(**cfg)))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.steps > 5 and got.path_length > 0
    assert FBE.SuperOracleFBEPolicy().act({"oracle_action": np.int64(2)}) == 2


def test_load_config_matches_jax(tmp_path, monkeypatch):
    import yaml

    d = {"camera": {"height": 96, "width": 128}, "max_frontiers": 16, "use_vqa": True}
    (tmp_path / "c.yaml").write_text(yaml.safe_dump(d))
    (tmp_path / "c.json").write_text(json.dumps(d))
    (tmp_path / "empty.json").write_text("")
    for src in (d, str(tmp_path / "c.yaml"), str(tmp_path / "c.json"), str(tmp_path / "empty.json")):
        assert dataclasses.asdict(CFG.load_config(src)) == dataclasses.asdict(JCFG.load_config(src))
    monkeypatch.setenv("MAP_FUSION_TYPE", "replace")
    assert CFG.load_config({}).map_fusion_type == JCFG.load_config({}).map_fusion_type == "replace"
    for mod in (CFG, JCFG):
        with pytest.raises(ValueError, match="Unknown config keys"):
            mod.load_config({"no_such_field": 1})
