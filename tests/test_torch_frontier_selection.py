"""vlfm_tpu_torch frontier selection and acyclic enforcer against vlfm_tpu,
on scripted cases (stickiness, cyclic suppression, the farthest-frontier
fallback, the V3 channel reduction). Every case runs through both packages
from the same numpy inputs and must give the same frontier, value and
acyclic state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.policy import acyclic as JAC
from vlfm_tpu.policy.frontier_selection import reduce_values_v3 as jax_reduce_v3
from vlfm_tpu.policy.frontier_selection import select_best_frontier as jax_select
from vlfm_tpu_torch.policy import acyclic as AC
from vlfm_tpu_torch.policy.frontier_selection import reduce_values_v3, select_best_frontier

FRONTIERS = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [2.0, 2.0]], np.float32)


def _history(entries):
    """The same acyclic history in both packages: (position, frontier, top-two)."""
    ac, jac = AC.create(16, device="cpu"), JAC.create(16)
    for pos, fr, tt in entries:
        args = [np.float32(a) for a in (pos, fr, tt)]
        ac = AC.add(ac, *(torch.from_numpy(a) for a in args))
        jac = JAC.add(jac, *(jnp.asarray(a) for a in args))
    return ac, jac


TOP = (0.9, 0.5)
CASES = {
    "picks_highest": dict(values=[0.1, 0.9, 0.5, 0.3]),
    "sticks_to_last": dict(values=[0.9, 0.1, 0.5, 0.3], last=(-1.0, 0.0), last_value=0.505),
    "sticks_to_close_last": dict(values=[0.9, 0.1, 0.5, 0.3], last=(-1.2, 0.3), last_value=0.495),
    "abandons_worse_last": dict(values=[0.9, 0.1, 0.5, 0.3], last=(-1.0, 0.0), last_value=0.8),
    "last_gone": dict(values=[0.9, 0.1, 0.5, 0.3], last=(5.0, 5.0), last_value=0.1),
    "cyclic_suppression": dict(
        values=[0.5, 0.9, 0.1, 0.3], history=[((0, 0), (0, 1), TOP)]),
    "all_cyclic_farthest": dict(
        values=[0.5, 0.9, 0.1, 0.3],
        history=[((0, 0), f, (0.9, 0.5)) for f in FRONTIERS.tolist()]),
    "invalid_masked": dict(values=[0.5, 0.9, 0.1, 0.95], valid=[True, False, True, False]),
    "one_valid_top_two_padded": dict(values=[0.5, 0.9, 0.1, 0.3], valid=[False, False, True, False]),
    "none_valid": dict(values=[0.5, 0.9, 0.1, 0.3], valid=[False] * 4),
    "ties_keep_order": dict(values=[0.4, 0.4, 0.4, 0.4]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_best_frontier_matches_jax(name):
    case = CASES[name]
    values = np.float32(case["values"])
    valid = np.array(case.get("valid", [True] * 4))
    last = np.float32(case.get("last", (0.0, 0.0)))
    last_value = np.float32(case.get("last_value", -np.inf))
    robot = np.float32([0.0, 0.0])
    ac, jac = _history(case.get("history", []))

    got = select_best_frontier(
        torch.from_numpy(FRONTIERS), torch.from_numpy(valid), torch.from_numpy(values),
        torch.from_numpy(robot), torch.from_numpy(last), torch.tensor(last_value), ac,
    )
    want = jax_select(
        jnp.asarray(FRONTIERS), jnp.asarray(valid), jnp.asarray(values),
        jnp.asarray(robot), jnp.asarray(last), jnp.float32(last_value), jac,
    )
    np.testing.assert_array_equal(got.frontier.numpy(), np.asarray(want.frontier))
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    assert bool(got.any_valid) == bool(want.any_valid)
    np.testing.assert_array_equal(got.last_frontier.numpy(), np.asarray(want.last_frontier))
    np.testing.assert_array_equal(got.acyclic.keys.numpy(), np.asarray(want.acyclic.keys))
    assert int(got.acyclic.count) == int(want.acyclic.count)


def test_repeated_choice_becomes_cyclic():
    """Three decisions in a row from one position, fed back as the reference
    feeds them: the acyclic state and the choices agree at every step."""
    values = np.float32([0.5, 0.9, 0.1, 0.3])
    valid = np.ones(4, bool)
    robot = np.float32([0.25, -0.5])
    ac, jac = AC.create(8, device="cpu"), JAC.create(8)
    last, jlast = torch.zeros(2), jnp.zeros(2)
    lv, jlv = torch.tensor(-np.inf), jnp.float32(-np.inf)
    for _ in range(3):
        got = select_best_frontier(torch.from_numpy(FRONTIERS), torch.from_numpy(valid),
                                   torch.from_numpy(values), torch.from_numpy(robot), last, lv, ac)
        want = jax_select(jnp.asarray(FRONTIERS), jnp.asarray(valid), jnp.asarray(values),
                          jnp.asarray(robot), jlast, jlv, jac)
        np.testing.assert_array_equal(got.frontier.numpy(), np.asarray(want.frontier))
        np.testing.assert_array_equal(got.acyclic.keys.numpy(), np.asarray(want.acyclic.keys))
        ac, jac = got.acyclic, want.acyclic
        # A sticky choice every step, as the policy feeds last_frontier back.
        last, jlast = got.last_frontier, want.last_frontier
        lv, jlv = got.last_value, want.last_value


def test_acyclic_membership_matches_jax():
    ac, jac = _history([((1, 2), (3, 4), (0.5, 0.25)), ((0, 0), (1, 1), (0.9, 0.8))])
    probes = np.float32([[1, 2, 3, 4, 0.5, 0.25], [1.01, 2, 3, 4, 0.5, 0.25], [0, 0, 1, 1, 0.9, 0.8]])
    for p in probes:
        args = (p[:2], p[2:4], p[4:])
        got = AC.check_cyclic(ac, *(torch.from_numpy(a) for a in args))
        assert bool(got) == bool(JAC.check_cyclic(jac, *(jnp.asarray(a) for a in args)))
    fr = np.float32([[1, 1], [2, 2], [3, 4]])
    tt = np.float32([0.9, 0.8])
    got = AC.check_cyclic_batch(ac, torch.zeros(2), torch.from_numpy(fr), torch.from_numpy(tt))
    want = JAC.check_cyclic_batch(jac, jnp.zeros(2), jnp.asarray(fr), jnp.asarray(tt))
    assert got.tolist() == np.asarray(want).tolist() == [True, False, False]


@pytest.mark.parametrize("thresh", [0.15, 0.5])
def test_reduce_values_v3_matches_jax(thresh):
    vals = np.float32([[0.1, 0.7], [0.2, 0.3], [0.6, 0.0]])
    valid = np.array([True, True, False])  # the invalid 0.6 must not count
    got = reduce_values_v3(torch.from_numpy(vals), torch.from_numpy(valid), thresh)
    want = jax_reduce_v3(jnp.asarray(vals), jnp.asarray(valid), thresh)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
