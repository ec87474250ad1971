"""vlfm_tpu_torch's PointNav against vlfm_tpu's, on the CPU.

JAX's ``init_params`` (from ``PRNGKey(0)``, ``visual_fc`` sized from the
depth shape as flax's init sizes it) goes into the port through
``PointNavPolicy.from_jax_params``; the same depth, goals and recurrent
states go through both ``act``s. Held to PN_ATOL = 1e-4 absolute (flax's
GroupNorm and torch's differ in the last bits): logits, ``h`` and ``c``;
exactly: the actions, the previous action and ``not_done``. At full width
(224x224, B = 2) and at 96x128, the discrete head and the continuous one,
the mask reset inside ``act`` and ``reset_episodes``.

The flatten order: JAX flattens the compression output as (h, w, c)
(vlfm_tpu/models/pointnav.py:91) and its torch-checkpoint converter does
not permute ``visual_fc``'s inputs (vlfm_tpu/models/torch_import.py:87),
while the reference's ``Flatten`` reads (c, h, w). A synthetic reference
state dict (made as tests/test_pointnav.py:70-118 makes it, copied: that
module is marked slow) loaded as it is by the port and converted by JAX
gives other logits; with its ``net.visual_fc.1.weight`` columns permuted
to (h, w, c) before JAX's converter, the two agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlfm_tpu.models import pointnav as JPN
from vlfm_tpu.models.torch_import import convert_torch_state_dict
from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.ops import threefry as T

PN_ATOL = 1e-4


def _synthetic_reference_state_dict(discrete: bool):
    """Random tensors with the reference checkpoint's names and shapes
    (tests/test_pointnav.py:70-118)."""
    rng = np.random.default_rng(0)

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.05

    sd = {}
    enc = "net.visual_encoder"
    sd[f"{enc}.backbone.conv1.0.weight"] = t(32, 1, 7, 7)
    sd[f"{enc}.backbone.conv1.1.weight"] = t(32)
    sd[f"{enc}.backbone.conv1.1.bias"] = t(32)
    inp = 32
    for li, planes in enumerate([32, 64, 128, 256], start=1):
        for bi in range(2):
            pre = f"{enc}.backbone.layer{li}.{bi}"
            cin = inp if bi == 0 else planes
            sd[f"{pre}.convs.0.weight"] = t(planes, cin, 3, 3)
            sd[f"{pre}.convs.1.weight"] = t(planes)
            sd[f"{pre}.convs.1.bias"] = t(planes)
            sd[f"{pre}.convs.3.weight"] = t(planes, planes, 3, 3)
            sd[f"{pre}.convs.4.weight"] = t(planes)
            sd[f"{pre}.convs.4.bias"] = t(planes)
            if bi == 0 and (cin != planes):
                sd[f"{pre}.downsample.0.weight"] = t(planes, cin, 1, 1)
                sd[f"{pre}.downsample.1.weight"] = t(planes)
                sd[f"{pre}.downsample.1.bias"] = t(planes)
        inp = planes
    sd[f"{enc}.compression.0.weight"] = t(128, 256, 3, 3)
    sd[f"{enc}.compression.1.weight"] = t(128)
    sd[f"{enc}.compression.1.bias"] = t(128)
    sd["net.visual_fc.1.weight"] = t(512, 2048)
    sd["net.visual_fc.1.bias"] = t(512)
    sd["net.tgt_embeding.weight"] = t(32, 3)
    sd["net.tgt_embeding.bias"] = t(32)
    if discrete:
        sd["net.prev_action_embedding_discrete.weight"] = t(5, 32)
        sd["action_distribution.linear.weight"] = t(4, 512)
        sd["action_distribution.linear.bias"] = t(4)
    else:
        sd["net.prev_action_embedding_cont.weight"] = t(32, 2)
        sd["net.prev_action_embedding_cont.bias"] = t(32)
        sd["action_distribution.mu_maybe_std.weight"] = t(4, 512)
        sd["action_distribution.mu_maybe_std.bias"] = t(4)
    for layer in range(2):
        in_sz = 576 if layer == 0 else 512
        sd[f"net.state_encoder.rnn.weight_ih_l{layer}"] = t(2048, in_sz)
        sd[f"net.state_encoder.rnn.weight_hh_l{layer}"] = t(2048, 512)
        sd[f"net.state_encoder.rnn.bias_ih_l{layer}"] = t(2048)
        sd[f"net.state_encoder.rnn.bias_hh_l{layer}"] = t(2048)
    return sd


def _jax_params(depth_shape, discrete=True):
    policy = JPN.PointNavPolicy({}, discrete=discrete)
    init = jax.jit(policy.init_params, static_argnames=("depth_shape",))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), depth_shape=depth_shape))


def _inputs(b, shape, discrete=True, seed=0):
    """Seeded depth, goals and a mid-episode recurrent state whose lane 1
    starts anew (``not_done`` False)."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0, 1, (b, *shape)).astype(np.float32)
    goal = np.stack([rng.uniform(0.2, 5, b), rng.uniform(-np.pi, np.pi, b)], axis=1).astype(np.float32)
    a = 1 if discrete else 2
    prev = rng.integers(0, 4, (b, 1)).astype(np.float32) if discrete else rng.uniform(-1, 1, (b, a)).astype(np.float32)
    state = [rng.normal(size=(2, b, 512)).astype(np.float32), rng.normal(size=(2, b, 512)).astype(np.float32), prev,
             (np.arange(b) != 1)[:, None]]
    return depth, goal, state


def _act_both(jpolicy, tpolicy, depth, goal, state):
    js = JPN.PointNavState(*(jnp.asarray(x) for x in state))
    ja, js2 = jpolicy.act(jnp.asarray(depth)[..., None], jnp.asarray(goal), js)
    ts = PN.PointNavState(*(torch.from_numpy(np.array(x)) for x in state))
    ta, ts2 = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), ts)
    return ja, js2, ta, ts2


def _jax_logits(jpolicy, jstate):
    return np.asarray(jpolicy._heads.apply({"params": jpolicy.params["heads"]}, jstate.h[-1]))


def _assert_states_close(ts, js):
    for name in ("h", "c"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=PN_ATOL, rtol=0)
    np.testing.assert_array_equal(ts.not_done.numpy(), np.asarray(js.not_done))


@pytest.mark.parametrize("shape", [(224, 224), (96, 128)])
def test_discrete_act_matches_jax(shape):
    params = _jax_params(shape)
    jpolicy = JPN.PointNavPolicy(params)
    tpolicy = PN.PointNavPolicy.from_jax_params(params, shape, device="cpu")
    assert tpolicy.module.net.visual_fc[1].in_features == 128 * np.prod(PN.compressed_hw(shape))
    state = _inputs(2, shape)[2]
    depth, goal, _ = _inputs(2, shape)
    for _ in range(2):  # a second step carries the recurrence
        ja, js, ta, ts = _act_both(jpolicy, tpolicy, depth, goal, state)
        np.testing.assert_allclose(tpolicy.logits(ts).numpy(), _jax_logits(jpolicy, js), atol=PN_ATOL, rtol=0)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(ts.prev_action.numpy(), np.asarray(js.prev_action))
        _assert_states_close(ts, js)
        assert ta.dtype == torch.int64 and ta.shape == (2, 1)
        state = [np.asarray(x) for x in js]
        depth = depth[::-1].copy()


def test_continuous_head_matches_jax():
    shape = (224, 224)
    params = _jax_params(shape, discrete=False)
    jpolicy = JPN.PointNavPolicy(params, discrete=False)
    tpolicy = PN.PointNavPolicy.from_jax_params(params, shape, device="cpu")
    assert not tpolicy.discrete
    depth, goal, state = _inputs(2, shape, discrete=False)
    ja, js, ta, ts = _act_both(jpolicy, tpolicy, depth, goal, state)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=PN_ATOL, rtol=0)
    np.testing.assert_allclose(ts.prev_action.numpy(), np.asarray(js.prev_action), atol=PN_ATOL, rtol=0)
    assert ta.shape == (2, 2) and bool((ta.abs() <= 1).all())
    _assert_states_close(ts, js)


def test_not_done_false_zeroes_the_recurrence_inside_act():
    """A lane with ``not_done`` False acts as a fresh episode, whatever its
    stale ``h``, ``c`` and previous action."""
    tpolicy = PN.PointNavPolicy.init_random(0, device="cpu")
    depth, goal, _ = _inputs(2, (224, 224))
    fresh = PN.initial_state(2, device="cpu")
    stale = fresh._replace(h=torch.ones_like(fresh.h), c=-torch.ones_like(fresh.c),
                           prev_action=torch.full_like(fresh.prev_action, 3.0))
    a1, s1 = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), fresh)
    a2, s2 = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), stale)
    assert torch.equal(a1, a2) and torch.equal(s1.h, s2.h) and torch.equal(s1.c, s2.c)
    assert bool(s1.not_done.all())


def test_reset_episodes_matches_jax():
    _, _, state = _inputs(3, (224, 224))
    done = np.array([True, False, True])
    want = JPN.reset_episodes(JPN.PointNavState(*(jnp.asarray(x) for x in state)), jnp.asarray(done))
    got = PN.reset_episodes(PN.PointNavState(*(torch.from_numpy(np.array(x)) for x in state)), torch.from_numpy(done))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got.h[:, 0].any() and got.h[:, 1].any()


def test_stochastic_heads_are_not_ported():
    """The stochastic heads are ported now (tests/test_torch_pointnav_stochastic.py
    holds them to JAX): ``deterministic=False`` draws with the key it is
    given, a valid action that the same key repeats, and refuses to run
    without one."""
    tpolicy = PN.PointNavPolicy.init_random(0, device="cpu")
    depth, goal, _ = _inputs(1, (224, 224))
    state = PN.initial_state(1, device="cpu")
    with pytest.raises(ValueError, match="rng="):
        tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), state, deterministic=False)
    key = T.PRNGKey(3, device="cpu")
    a1, _ = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), state, deterministic=False, rng=key)
    a2, _ = tpolicy.act(torch.from_numpy(depth), torch.from_numpy(goal), state, deterministic=False, rng=key)
    assert torch.equal(a1, a2) and a1.shape == (1, 1) and 0 <= int(a1) < 4


def test_init_random_is_seeded_and_finite():
    a, b = (PN.PointNavPolicy.init_random(0, device="cpu") for _ in range(2))
    c = PN.PointNavPolicy.init_random(1, device="cpu")
    sa, sb, sc = (p.module.state_dict() for p in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["net.visual_fc.1.weight"], sc["net.visual_fc.1.weight"])
    depth, goal, _ = _inputs(2, (224, 224))
    action, state = a.act(torch.from_numpy(depth), torch.from_numpy(goal), PN.initial_state(2, device="cpu"))
    assert bool(torch.isfinite(a.logits(state)).all()) and bool(((action >= 0) & (action < 4)).all())


@pytest.mark.parametrize("discrete", [True, False])
def test_reference_state_dict_loads_as_it_is(discrete):
    sd = _synthetic_reference_state_dict(discrete)
    tpolicy = PN.PointNavPolicy.from_reference_state_dict(sd, device="cpu")
    got = tpolicy.module.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_flatten_order_differs_between_the_packages():
    """The reference's (c, h, w) flatten in the port against JAX's (h, w, c)
    read of the same checkpoint: other logits; once the checkpoint's
    ``visual_fc`` columns are permuted to (h, w, c), the same."""
    sd = _synthetic_reference_state_dict(True)
    tpolicy = PN.PointNavPolicy.from_reference_state_dict(sd, device="cpu")
    depth, goal, _ = _inputs(2, (224, 224), seed=3)
    state = [np.asarray(x) for x in JPN.initial_state(2)]  # fresh episodes: the logits follow the features

    def jax_logits(ckpt):
        jpolicy = JPN.PointNavPolicy(convert_torch_state_dict(ckpt, discrete=True))
        _, js, _, ts = _act_both(jpolicy, tpolicy, depth, goal, state)
        return _jax_logits(jpolicy, js), tpolicy.logits(ts).numpy()

    as_is, port = jax_logits(sd)
    assert np.abs(as_is - port).max() > 10 * PN_ATOL
    h, w = PN.compressed_hw((224, 224))
    weight = sd["net.visual_fc.1.weight"]
    permuted = dict(sd)
    permuted["net.visual_fc.1.weight"] = weight.reshape(512, 128, h, w).transpose(0, 2, 3, 1).reshape(512, -1)
    fixed, port = jax_logits(permuted)
    np.testing.assert_allclose(port, fixed, atol=PN_ATOL, rtol=0)
