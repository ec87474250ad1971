"""vlfm_tpu_torch's PointNav behaviour cloning against vlfm_tpu's, on the CPU.

At tests/test_imitation.py's small shapes (48x64 depth, 3 episodes of at
most 16 steps in a 64x48 environment). Held:

- rollouts (direct and ``u16_half``): actions, goals and valid flags bit
  for bit (host code and numpy's RNG in both), depth within DEPTH_ATOL
  (the resizes' tolerance, tests/test_torch_blip2_itm.py);
- one batch (B = 2, T = 6) of ``bc_loss_fn`` from ``from_jax_params`` of
  JAX's ``init_params(PRNGKey(0), (48, 64))``: the loss within LOSS_RTOL,
  the accuracy equal, and every gradient within GRAD_RTOL and GRAD_ATOL
  times that tensor's largest entry of JAX's gradient tree (f32 sums in
  another order: see GRAD_ATOL), mapped through
  the transposes and the ``visual_fc`` permutation ``from_jax_params``
  applies (the map is linear, so gradients map as parameters do);
- Adam: optax's and torch's, fed the same mapped gradients for 3 steps,
  leave parameters within ADAM_ATOL (f32 order differs; ROADMAP Queue 3);
- ``train_pointnav_bc``: 3 steps at batch 2 train on the minibatches JAX
  draws, and ``fit_pointnav_to_greedy`` returns a policy that acts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_step import one_torch_thread  # noqa: F401
from vlfm_tpu.models.pointnav import PointNavPolicy as JPolicy
from vlfm_tpu.runner import fake_env as JENV
from vlfm_tpu.runner import imitation as JIM
from vlfm_tpu_torch.models import pointnav as PN
from vlfm_tpu_torch.runner import fake_env as TENV
from vlfm_tpu_torch.runner import imitation as IM

DEPTH_SHAPE = (48, 64)
ROLLOUT = dict(seed=7, depth_shape=DEPTH_SHAPE, max_steps=16)
DEPTH_ATOL = 1e-6
LOSS_RTOL = 1e-5
# rtol, and atol as a share of each tensor's largest entry: the conv weight
# gradients sum ~10^4 products in another order in XLA than in oneDNN, and a
# few entries that cancel land 2-3.4e-6 of the largest away (1e-6 leaves 3
# of ~3 M entries outside).
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ADAM_ATOL = 1e-6
KEYS = ("depth", "goal", "action", "valid")


def _rollouts(pkg, im, transport, **kw):
    env_cfg = pkg.EnvConfig(width=64, height=48, max_steps=30)
    return im.collect_pointnav_rollouts(3, env_cfg=env_cfg, transport=transport, **ROLLOUT, **kw)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's PointNav init from PRNGKey(0), compiled (flax's eager init
    takes twice as long), as numpy leaves."""
    pn = JPolicy({}, discrete=True)
    init = jax.jit(pn.init_params, static_argnames=("depth_shape",))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), depth_shape=DEPTH_SHAPE))


@pytest.fixture(scope="module")
def data():
    return _rollouts(JENV, JIM, None)


@pytest.fixture(scope="module")
def jax_loss_and_grads(jax_params, data):
    """JAX's loss, accuracy and gradient tree on the first 2 episodes' first
    6 steps."""
    batch = {k: jnp.asarray(data[k][:2, :6]) for k in KEYS}
    policy = JPolicy(jax_params, discrete=True)
    fn = jax.jit(jax.value_and_grad(lambda p: JIM.bc_loss_fn(policy, p, *(batch[k] for k in KEYS)), has_aux=True))
    (loss, acc), grads = fn(jax.tree_util.tree_map(jnp.asarray, jax_params))
    return float(loss), float(acc), jax.tree_util.tree_map(np.asarray, grads), batch


def _port_policy(params):
    return PN.PointNavPolicy.from_jax_params(params, DEPTH_SHAPE, device="cpu")


def _mapped(tree):
    """A JAX PointNav tree (parameters or gradients) under the port's names."""
    return PN._reference_state_dict_from_jax(tree, DEPTH_SHAPE)


@pytest.mark.parametrize("transport", [None, "u16_half"], ids=["direct", "u16-half"])
def test_rollouts_match_jax(transport):
    want = _rollouts(JENV, JIM, transport)
    got = _rollouts(TENV, IM, transport, device="cpu")
    for k in ("action", "valid", "goal"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["depth"].shape == want["depth"].shape == (3, 16, *DEPTH_SHAPE, 1)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=DEPTH_ATOL, rtol=0)
    assert want["valid"].sum() > 30 and len(set(want["action"][want["valid"]].tolist())) > 1


def test_bc_loss_and_gradients_match_jax(jax_params, jax_loss_and_grads):
    jloss, jacc, jgrads, batch = jax_loss_and_grads
    policy = _port_policy(jax_params)
    loss, acc = IM.bc_loss_fn(policy, *(torch.from_numpy(np.array(batch[k])) for k in KEYS))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= LOSS_RTOL * abs(jloss)
    assert float(acc) == jacc
    want = _mapped(jgrads)
    got = {name: p.grad for name, p in policy.module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g is not None and g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale, err_msg=name)


def test_adam_steps_match_optax(jax_params, jax_loss_and_grads):
    """Three updates from the same gradients (scaled 1, -0.5, 2) by optax's
    adam(1e-3) and by the port's optimiser."""
    jgrads = jax_loss_and_grads[2]
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    opt = optax.adam(1e-3)
    state = opt.init(jp)
    policy = _port_policy(jax_params)
    params = dict(policy.module.named_parameters())
    topt = torch.optim.Adam(params.values(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    mapped = _mapped(jgrads)
    for scale in (1.0, -0.5, 2.0):
        g = jax.tree_util.tree_map(lambda x: jnp.asarray(x) * scale, jgrads)
        updates, state = opt.update(g, state)
        jp = optax.apply_updates(jp, updates)
        for name, p in params.items():
            p.grad = torch.from_numpy(np.array(mapped[name])) * scale
        topt.step()
    want = _mapped(jax.tree_util.tree_map(np.asarray, jp))
    moved = 0
    for name, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=ADAM_ATOL, rtol=0, err_msg=name)
        moved += int(not np.array_equal(want[name], _mapped(jax_params)[name]))
    assert moved == len(params)


class _RecordingRandom:
    """numpy with ``random.default_rng`` recording each ``choice``."""

    def __init__(self, drawn):
        self._drawn = drawn

    def default_rng(self, seed):
        rng, drawn = np.random.default_rng(seed), self._drawn

        class Rec:
            def choice(self, *a, **kw):
                out = rng.choice(*a, **kw)
                drawn.append(out)
                return out

        return Rec()

    def __getattr__(self, name):
        return getattr(np.random, name)


class _RecordingNumpy:
    def __init__(self, drawn):
        self.random = _RecordingRandom(drawn)

    def __getattr__(self, name):
        return getattr(np, name)


def test_train_pointnav_bc_draws_jaxs_minibatches(jax_params, data, monkeypatch):
    """JAX's trainer with its update stubbed out (only its draws matter
    here) against the port's, whose loss sees each step's minibatch."""
    jdrawn = []
    monkeypatch.setattr(JIM, "np", _RecordingNumpy(jdrawn))
    monkeypatch.setattr(jax, "jit", lambda fn: lambda p, s, *batch: (p, s, 0.0, 0.0))
    JIM.train_pointnav_bc(JPolicy(jax_params, discrete=True), data, steps=3, batch=2)
    monkeypatch.undo()
    assert len(jdrawn) == 3

    seen = []
    real = IM.bc_loss_fn

    def spy(policy, depth, goal, action, valid):
        seen.append((goal.numpy().copy(), action.numpy().copy()))
        return real(policy, depth, goal, action, valid)

    monkeypatch.setattr(IM, "bc_loss_fn", spy)
    policy = _port_policy(jax_params)
    before = [p.detach().clone() for p in policy.module.parameters()]
    trained, metrics = IM.train_pointnav_bc(policy, data, steps=3, batch=2)
    assert trained is policy and len(seen) == 3
    for idx, (goal, action) in zip(jdrawn, seen):
        np.testing.assert_array_equal(goal, data["goal"][idx])
        np.testing.assert_array_equal(action, data["action"][idx])
    assert set(metrics) == {"loss", "accuracy"} and np.isfinite(metrics["loss"])
    assert any(not torch.equal(b, p) for b, p in zip(before, policy.module.parameters()))


def test_fit_pointnav_to_greedy_returns_a_policy_that_acts():
    policy, metrics = IM.fit_pointnav_to_greedy(depth_shape=DEPTH_SHAPE, episodes=2, train_steps=2, batch=2,
                                                env_cfg=TENV.EnvConfig(width=64, height=48, max_steps=30),
                                                max_steps=6, device="cpu")
    assert isinstance(policy, PN.PointNavPolicy) and 0.0 <= metrics["accuracy"] <= 1.0
    state = PN.initial_state(2, device="cpu")
    action, _ = policy.act(torch.rand(2, *DEPTH_SHAPE), torch.tensor([[2.0, 0.5], [1.0, -1.0]]), state)
    assert action.shape == (2, 1) and bool(((action >= 0) & (action < PN.NUM_ACTIONS)).all())
