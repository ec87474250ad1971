"""vlfm_tpu_torch's PointNav stochastic heads against vlfm_tpu's, on the CPU.

JAX's ``init_params`` goes into the port through ``from_jax_params`` (as in
tests/test_torch_pointnav.py, at 96x128, B = 4 with lane 1 starting anew);
both ``act(deterministic=False, rng=key)`` run three recurrent steps, each
with its own key. The discrete head's draws (``categorical``) are equal;
the continuous head's (``mu + std * normal``) within CONT_ATOL = 1e-6,
since mu and std themselves differ in the last bits between flax and
torch while the normal draws are bit-equal (tests/test_torch_threefry_draws.py).
The draw is the next step's previous action in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pointnav import PN_ATOL, _inputs, _jax_params
from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.models import pointnav as JPN
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.ops import threefry as T

SHAPE = (96, 128)
CONT_ATOL = 1e-6


@pytest.mark.parametrize("discrete", [True, False])
def test_stochastic_act_matches_jax(discrete):
    params = _jax_params(SHAPE, discrete)
    jpolicy = JPN.PointNavPolicy(params, discrete=discrete)
    tpolicy = PN.PointNavPolicy.from_jax_params(params, SHAPE, device="cpu")
    depth, goal, state = _inputs(4, SHAPE, discrete)
    js = JPN.PointNavState(*(jnp.asarray(x) for x in state))
    ts = PN.PointNavState(*(torch.from_numpy(np.array(x)) for x in state))
    draws = []
    for step in range(3):
        ja, js = jpolicy.act(jnp.asarray(depth)[..., None], jnp.asarray(goal), js, deterministic=False,
                             rng=jax.random.PRNGKey(100 + step))
        ta, ts = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), ts, deterministic=False,
                             rng=T.PRNGKey(100 + step, device="cpu"))
        if discrete:
            assert ta.dtype == torch.int64 and ta.shape == (4, 1)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(ts.prev_action.numpy(), np.asarray(js.prev_action))
        else:
            assert ta.shape == (4, 2)
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=CONT_ATOL, rtol=0)
            np.testing.assert_allclose(ts.prev_action.numpy(), np.asarray(js.prev_action), atol=CONT_ATOL, rtol=0)
            assert torch.equal(ts.prev_action, ta)
        for name in ("h", "c"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=PN_ATOL,
                                       rtol=0)
        draws.append(ta)
        depth = depth[::-1].copy()
    # the deterministic head is the draw's centre: the argmax, or the mean
    ta_det, _ = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), ts)
    ja_det, _ = jpolicy.act(jnp.asarray(depth)[..., None], jnp.asarray(goal), js)
    np.testing.assert_allclose(ta_det.numpy().astype(np.float64), np.asarray(ja_det, np.float64), atol=PN_ATOL)
    assert any(not torch.equal(draws[0], d) for d in draws[1:])  # the keys move the draws


def test_stochastic_act_takes_one_key():
    tpolicy = PN.PointNavPolicy.init_random(0, device="cpu")
    depth, goal, _ = _inputs(2, (224, 224))
    state = PN.initial_state(2, device="cpu")
    with pytest.raises(ValueError, match="rng="):
        tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), state, deterministic=False)
    with pytest.raises(ValueError, match="one"):
        tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), state, deterministic=False,
                    rng=T.PRNGKey(torch.arange(2), device="cpu"))
