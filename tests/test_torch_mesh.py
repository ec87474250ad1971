"""vlfm_tpu_torch's device mesh and the farm's ``sharding=`` on the CPU.

A 2-device CPU mesh (``make_mesh(devices=[cpu, cpu])``): an episode batch
split over its data axis gives JAX's shards leaf for leaf
(``jax.device_put`` with ``NamedSharding(mesh, P("data"))`` over two of
conftest's host devices) and concatenates back bit for bit; replicated
placement and ``shard_params_tp`` copy whole; ``best_devices`` raises when
asked for CUDA devices the box does not have (JAX falls back to CPU
devices there; the port does not hide the device). A (2, 2) mesh: the data
rows' lead devices, each row's block equal to JAX's shard on every model
column, and ``shard_params_tp`` splitting a ``Dense`` and keeping an
``nn.Linear`` whole (``tests/test_torch_tensor_parallel.py`` holds the split
to JAX's placement). The farm with ``sharding=episode_sharding(mesh)``
equals the unsharded farm field for field (tests/test_parallel.py holds
JAX's sharded farm so), oracle-fed with the greedy controller on the
(2, 1) and (2, 2) meshes, with a PointNav replicated per device, and with
the tiny full-stack perception.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.test_torch_sim_farm import CFG, ENV, SEEDS, SPEC, farm, ring_prefix
from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.parallel import mesh as JM
from vlfm_tpu_torch.models.layers import Dense
from vlfm_tpu_torch.models.pointnav import PointNavPolicy
from vlfm_tpu_torch.parallel import mesh as M
from vlfm_tpu_torch.policy import itm
from vlfm_tpu_torch.runner import sim_farm as SF
from vlfm_tpu_torch.runner.checkpoint import map_tensors
from vlfm_tpu_torch.runner.full_stack import FullStackPerception

CPU = torch.device("cpu")


def _batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"depth": torch.from_numpy(rng.random((b, 6, 8), np.float32)),
            "pose": (torch.from_numpy(rng.integers(0, 9, (b, 3)).astype(np.int32)),
                     torch.from_numpy(rng.random(b) < 0.5)),
            "name": "lanes"}


def test_make_mesh_shapes_and_devices():
    mesh = M.make_mesh(devices=[CPU, "cpu"])
    assert mesh.shape == {"data": 2, "model": 1} and mesh.axis_names == ("data", "model")
    assert mesh.data_devices() == [CPU, CPU]
    mesh4 = M.make_mesh(devices=[CPU] * 4, model_parallel=2)
    assert mesh4.shape == {"data": 2, "model": 2}
    assert mesh4.data_devices() == [CPU, CPU] and mesh4.model_devices(1) == [CPU, CPU]
    named = M.make_mesh(devices=[torch.device("cpu", i) for i in range(4)], model_parallel=2)
    assert named.data_devices() == [torch.device("cpu", 0), torch.device("cpu", 2)]
    assert named.model_devices(1) == [torch.device("cpu", 2), torch.device("cpu", 3)]
    assert M.episode_sharding(named).data_devices() == named.data_devices()
    with pytest.raises(ValueError):
        M.make_mesh(devices=[CPU] * 3, model_parallel=2)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the box has CUDA devices")
def test_best_devices_raises_without_cuda_devices():
    with pytest.raises(RuntimeError, match=r"need 2 CUDA devices, have 0.*devices=\[torch.device\('cpu'\)\] \* 2"):
        M.best_devices(2)
    with pytest.raises(RuntimeError, match="need 1 CUDA devices"):
        M.make_mesh()


def test_episode_shards_match_jax_and_gather_back():
    batch = _batch()
    mesh = M.make_mesh(devices=[CPU] * 2)
    blocks = M.shard_episode_batch(batch, mesh)
    assert len(blocks) == 2 and blocks[0]["name"] == "lanes"
    jmesh = JMesh(np.asarray(jax.devices("cpu")[:2]).reshape(2, 1), ("data", "model"))
    jtree = jax.device_put({"depth": batch["depth"].numpy(), "pose": tuple(t.numpy() for t in batch["pose"])},
                           NamedSharding(jmesh, P("data")))
    for leaf, jleaf in ((lambda b: b["depth"], jtree["depth"]), (lambda b: b["pose"][0], jtree["pose"][0]),
                        (lambda b: b["pose"][1], jtree["pose"][1])):
        shards = sorted(jleaf.addressable_shards, key=lambda s: s.index[0].start)
        for r, shard in enumerate(shards):
            np.testing.assert_array_equal(leaf(blocks[r]).numpy(), np.asarray(shard.data))
    assert torch.equal(torch.cat([blk["depth"] for blk in blocks]), batch["depth"])
    for i in range(2):
        assert torch.equal(torch.cat([blk["pose"][i] for blk in blocks]), batch["pose"][i])
    with pytest.raises(ValueError, match="equal blocks"):
        M.shard_episode_batch(_batch(b=3), mesh)


def test_episode_blocks_on_a_model_axis_match_jax_for_every_column():
    """On a (2, 2) mesh an episode block lives on its row's lead device; JAX's
    ``P("data")`` replicates it over the model axis, so every column's shard
    equals the row's block."""
    batch = _batch()
    blocks = M.shard_episode_batch(batch, M.make_mesh(devices=[CPU] * 4, model_parallel=2))
    assert len(blocks) == 2
    jmesh = JM.make_mesh(4, model_parallel=2)
    jtree = jax.device_put({"depth": batch["depth"].numpy(), "pose": tuple(t.numpy() for t in batch["pose"])},
                           NamedSharding(jmesh, P("data")))
    for leaf, jleaf in ((lambda b: b["depth"], jtree["depth"]), (lambda b: b["pose"][0], jtree["pose"][0]),
                        (lambda b: b["pose"][1], jtree["pose"][1])):
        shards = {s.device: s for s in jleaf.addressable_shards}
        for r in range(2):
            for c in range(2):
                np.testing.assert_array_equal(leaf(blocks[r]).numpy(), np.asarray(shards[jmesh.devices[r, c]].data))


def _leaves(tree):
    out = []
    map_tensors(out.append, tree)
    return out


def test_episode_sharding_splits_the_maps_of_a_policy_state():
    """The maps' leaves lead with the lane axis; PointNav's (L, B, 512)
    recurrence does not, so the farm makes each block's state itself."""
    state = itm.create_state(SPEC, CFG, batch=2, device="cpu")._replace(pointnav=None)
    blocks = M.shard_episode_batch(state, M.make_mesh(devices=[CPU] * 2))
    one = itm.create_state(SPEC, CFG, batch=1, device="cpu")._replace(pointnav=None)
    for block in blocks:
        assert type(block) is type(state)
        got, want = _leaves(block), _leaves(one)
        assert len(got) == len(want) > 10 and all(torch.equal(a, b) for a, b in zip(got, want))


def test_replicated_and_shard_params_tp_copy_whole():
    mesh = M.make_mesh(devices=[CPU] * 2)
    params = {"w": torch.arange(6.0).reshape(3, 2), "b": torch.ones(3)}
    for copies in (M.replicated(mesh).place(params), M.shard_params_tp(params, mesh)):
        assert len(copies) == 2
        for c in copies:
            assert torch.equal(c["w"], params["w"]) and c["w"].data_ptr() != params["w"].data_ptr()
    module = torch.nn.Linear(3, 2)
    mods = M.shard_params_tp(module, mesh)
    assert all(m is not module and torch.equal(m.weight, module.weight) for m in mods)
    # A model axis of 2: each row's copy splits its Dense over the row's
    # devices and keeps the plain nn.Linear whole.
    net = torch.nn.Sequential(Dense(3, 4), torch.nn.Linear(4, 2))
    rows = M.shard_params_tp(net, M.make_mesh(devices=[CPU] * 4, model_parallel=2))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    for row in rows:
        assert row is not net and isinstance(row[0], M.SplitDense) and type(row[1]) is torch.nn.Linear
        assert torch.equal(torch.cat(list(row[0].weights)), net[0].weight)
        assert all(w.data_ptr() != net[0].weight.data_ptr() for w in row[0].weights)
        torch.testing.assert_close(row(x), net(x), atol=1e-6, rtol=0)


def _assert_results_equal(got, want):
    assert set(got) == set(want)
    for seed in want:
        assert dataclasses.asdict(got[seed]) == dataclasses.asdict(want[seed]), seed


@pytest.fixture(scope="module")
def unsharded():
    return farm(SEEDS, ring_prefix=ring_prefix("mesh_ref"), device="cpu")[0]


def test_sharded_oracle_farm_equals_unsharded(unsharded):
    sharding = M.episode_sharding(M.make_mesh(devices=[CPU] * 2))
    results, stats = farm(SEEDS, ring_prefix=ring_prefix("mesh_sh"), sharding=sharding)
    _assert_results_equal(results, unsharded)
    assert stats.env_steps == sum(r.steps for r in results.values())
    with pytest.raises(ValueError, match="do not split"):
        farm(SEEDS, sharding=M.episode_sharding(M.make_mesh(devices=[CPU] * 4)))


def test_farm_over_a_data_and_model_mesh_equals_unsharded(unsharded):
    """The (2, 2) mesh splits the lanes over its two data rows' lead
    devices, as JAX's farm tier splits them over its data axis."""
    sharding = M.episode_sharding(M.make_mesh(devices=[CPU] * 4, model_parallel=2))
    results, _ = farm(SEEDS, ring_prefix=ring_prefix("mesh_tp"), sharding=sharding)
    _assert_results_equal(results, unsharded)


def test_sharded_farm_replicates_pointnav():
    """A PointNav on the CPU is copied to each data row; the episodes equal
    the unsharded farm's with the same network (the maps and the greedy
    part bit for bit; PointNav's own numbers do not depend on the split,
    lanes being independent on the CPU)."""
    pn = PointNavPolicy.init_random(0, depth_shape=tuple(CFG.depth_image_shape), device="cpu")

    def pn_farm(name, **kw):
        return SF.run_episodes_farm(SEEDS[:2], lanes=2, pointnav=pn, spec=SPEC, cfg=CFG,
                                    plan_name="open_room_plan", env_cfg=ENV, workers=2,
                                    ring_prefix=ring_prefix(name), **kw)[0]

    want = pn_farm("mesh_pn_ref", device="cpu")
    got = pn_farm("mesh_pn_sh", sharding=M.episode_sharding(M.make_mesh(devices=[CPU] * 2)))
    _assert_results_equal(got, want)


def test_sharded_perception_farm_equals_unsharded():
    perception = FullStackPerception(CFG, device="cpu")
    want = farm(SEEDS[:2], ring_prefix=ring_prefix("mesh_fs_ref"), perception=perception)[0]
    got = farm(SEEDS[:2], ring_prefix=ring_prefix("mesh_fs_sh"), perception=perception,
               sharding=M.episode_sharding(M.make_mesh(devices=[CPU] * 2)))[0]
    _assert_results_equal(got, want)
