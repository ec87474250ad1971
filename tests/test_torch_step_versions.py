"""vlfm_tpu_torch's policy step in its other frontier scorings against
vlfm_tpu's, on the CPU, with the greedy controller.

``v1`` (the cosine cached at a frontier's first sight, with the frontier
cache), ``v3`` (V2 with the exploration channel where the target channel
stays below ``exploration_thresh``; two prompt channels fed different
seeded cosines) and ``fbe`` (the nearest frontier), each over the same 16
steps of ``two_room_plan(seed=0)`` as tests/test_torch_step.py, at
``__graft_entry__.py``'s small map and camera, with the same checks and
tolerances; V1 also holds the frontier cache's positions (1e-6 m), cosines
(exactly: both caches store the step's f32 input) and valid flags. The
cache's own update, sort and lazy-encoding test, lane by lane, against
JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_step import (GOAL_ATOL, SPIN_THEN_MOVES, assert_info_close, assert_state_close,  # noqa: F401
                                   one_torch_thread, port_config, port_spec, run_both)
from vlfm_tpu.config import CameraConfig, VLFMConfig
from vlfm_tpu.mapping import frontier_map as JFM
from vlfm_tpu.mapping.grid import GridSpec2D as JGrid
from vlfm_tpu.policy import itm as JITM
from vlfm_tpu_torch.mapping import frontier_map as FM
from vlfm_tpu_torch.policy import itm as ITM

JSPEC = JGrid(size=512, pixels_per_meter=20, pad=160)
BASE = VLFMConfig(camera=CameraConfig(height=96, width=128))
CONFIGS = {
    "v1": BASE,
    "v3": dataclasses.replace(BASE, text_prompt="Seems like there is a target_object ahead.|There is a lot of "
                              "area to explore ahead.", exploration_thresh=0.3),
    "fbe": BASE,
}


def _cosines(cfg, version):
    """Per step (C,) cosines: V3's channels differ, so its threshold picks."""
    if version != "v3":
        return None
    rng = np.random.default_rng(7)
    return list(rng.uniform(0.05, 0.6, (len(SPIN_THEN_MOVES), cfg.value_channels)).astype(np.float32))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def run(request):
    version = request.param
    jcfg = CONFIGS[version]
    tcfg, tspec = port_config(jcfg), port_spec(JSPEC)

    def jstep(*a):
        return JITM.step(*a, pointnav="greedy", spec=JSPEC, cfg=jcfg, version=version)

    def tstep(*a):
        return ITM.step(*a, pointnav="greedy", spec=tspec, cfg=tcfg, version=version)

    return version, run_both(jstep, tstep, jcfg, tcfg, JSPEC, tspec, cosines=_cosines(jcfg, version))


def test_every_step_matches_jax(run):
    version, (infos, _, _) = run
    for ji, ti in infos:
        assert_info_close(ti, ji)
    assert [int(ti.mode[0]) for _, ti in infos][12:] == [ITM.MODE_EXPLORE] * (len(infos) - 12), version
    assert min(int(ti.num_frontiers[0]) for _, ti in infos[12:]) > 0


def test_final_state_matches_jax(run):
    version, (_, jstate, tstate) = run
    assert_state_close(tstate, jstate, len(SPIN_THEN_MOVES), check_pointnav=False)
    cache, jcache = tstate.frontier_cache, jstate.frontier_cache
    np.testing.assert_array_equal(cache.valid[0].numpy(), np.asarray(jcache.valid))
    np.testing.assert_allclose(cache.positions[0].numpy(), np.asarray(jcache.positions), atol=GOAL_ATOL, rtol=0)
    np.testing.assert_array_equal(cache.cosines[0].numpy(), np.asarray(jcache.cosines))
    assert bool(cache.valid.any()) == (version == "v1")


def _frontier_sets(seed):
    """(steps, F, 2) frontier lists on a 0.05 m grid that keep some
    positions, lose some and gain some from step to step."""
    rng = np.random.default_rng(seed)
    pool = np.round(rng.uniform(-4, 4, (12, 2)) / 0.05) * 0.05
    fr = np.zeros((5, 8, 2), np.float32)
    valid = np.zeros((5, 8), bool)
    for t in range(5):
        pick = rng.choice(12, size=rng.integers(2, 8), replace=False)
        fr[t, : len(pick)] = pool[pick]
        valid[t, : len(pick)] = True
    return fr, valid


@pytest.mark.parametrize("capacity", [6, 16])  # 6: some new frontiers find no free slot
def test_frontier_cache_matches_jax_lane_by_lane(capacity):
    lanes = [_frontier_sets(s) for s in range(3)]
    cos = np.random.default_rng(9).uniform(0, 1, (5, 3)).astype(np.float32)
    state = FM.create(capacity, batch=3, device="cpu")
    jstates = [JFM.create(capacity) for _ in lanes]
    for t in range(5):
        fr = torch.from_numpy(np.stack([f[t] for f, _ in lanes]))
        valid = torch.from_numpy(np.stack([v[t] for _, v in lanes]))
        need = FM.needs_encoding(state, fr, valid)
        state = FM.update(state, fr, valid, torch.from_numpy(cos[t]))
        for i, (f, v) in enumerate(lanes):
            assert bool(need[i]) == bool(JFM.needs_encoding(jstates[i], jnp.asarray(f[t]), jnp.asarray(v[t])))
            jstates[i] = JFM.update(jstates[i], jnp.asarray(f[t]), jnp.asarray(v[t]), jnp.float32(cos[t, i]))
            for got, want in zip(state, jstates[i]):
                np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    pos, vals, valid = FM.sort_waypoints(state)
    for i, js in enumerate(jstates):
        for got, want in zip((pos, vals, valid), JFM.sort_waypoints(js)):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    cleared = FM.reset(state, torch.tensor([False, True, False]))
    assert not cleared.valid[1].any() and torch.equal(cleared.valid[0], state.valid[0])


def test_versions_and_controllers_are_checked():
    with pytest.raises(ValueError, match="version"):
        ITM.step(None, None, None, None, None, None, pointnav="greedy", spec=None, cfg=None, version="v4")
    with pytest.raises(ValueError, match="pointnav"):
        ITM.step(None, None, None, None, None, None, pointnav="pointnav", spec=None, cfg=None)
