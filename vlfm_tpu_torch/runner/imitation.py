"""Behaviour cloning of the PointNav network onto the greedy controller.

Counterpart of ``vlfm_tpu/runner/imitation.py``. No trained PointNav
checkpoint is at hand offline, so the deployed architecture
(``models/pointnav.py``: GN ResNet-18, 2-layer LSTM, categorical head;
the reference's pointnav_policy.py:51-121, nh_pointnav_policy.py:14-162)
is fitted by behaviour cloning of the deterministic rho-theta greedy
controller on synthetic point-goal episodes, so that the network, not the
greedy rule, can produce every action of an episode.

- ``collect_pointnav_rollouts``: the host environment and numpy's RNG, as
  in JAX, so the episodes, goals and labels are JAX's bit for bit. Depth
  goes through the serving seam on the device, one batched call per
  episode (``utils/img.resize_area``; with ``transport="u16_half"`` the
  farm's u16 half-size seam first: ``ops/resize.resize_bilinear``).
- ``bc_loss_fn``: a teacher-forced unroll over the time axis with
  gradients on (``PointNavPolicy.act`` is ``no_grad``): the trunk and the
  head batched over every step, a Python loop over ``lstm_step`` where JAX
  runs ``lax.scan``.
- ``train_pointnav_bc``: ``torch.optim.Adam`` with optax's defaults,
  minibatches drawn as JAX draws them.

On the card the loss, its backward and the updates run under
``precision.exact_f32`` (no TF32), as PointNav serves, so the fitted
weights are trained on the function they serve.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.models.pointnav import HIDDEN_SIZE, NUM_LSTM_LAYERS, PointNavPolicy
from vlfm_tpu_torch.models.precision import exact_f32
from vlfm_tpu_torch.ops.resize import resize_bilinear
from vlfm_tpu_torch.runner import fake_env as FE
from vlfm_tpu_torch.utils.img import resize_area

# habitat action ids (habitat_policies.py:54-58)
STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3
HALF_TURN = math.radians(15.0)


def _greedy_action(theta: float) -> int:
    """The deterministic rho-theta teacher — the greedy branch of
    ``policy/itm.py:greedy_action`` (turn toward the goal outside +-15 deg,
    else step forward)."""
    if theta > HALF_TURN:
        return TURN_LEFT
    if theta < -HALF_TURN:
        return TURN_RIGHT
    return MOVE_FORWARD


def _depth_seam(frames: np.ndarray, transport: Optional[str], env_cfg: FE.EnvConfig, depth_shape,
                device) -> np.ndarray:
    """One episode's frames through the serving seam on ``device``, one
    call: (t, H, W) f32 camera depth, or (t, H/2, W/2) u16 for
    ``u16_half`` (dequantised, bilinear back to the camera grid, as the
    farm's dispatch does), resized to ``depth_shape``; (t, h, w, 1) numpy."""
    x = torch.from_numpy(frames).to(device)
    with exact_f32(device):
        if transport == "u16_half":
            d = x.to(torch.float32) * (1.0 / 65535.0)
            x = resize_bilinear(d[..., None], env_cfg.height, env_cfg.width)[..., 0]
        out = resize_area(x, tuple(depth_shape))
    return out[..., None].cpu().numpy()


def collect_pointnav_rollouts(
    n_episodes: int,
    *,
    seed: int = 0,
    env_cfg: Optional[FE.EnvConfig] = None,
    depth_shape: Tuple[int, int] = (224, 224),
    max_steps: int = 48,
    plan_name: str = "open_room_plan",
    stop_radius: float = 0.9,
    goal_range: Tuple[float, float] = (1.5, 4.0),
    transport: Optional[str] = None,
    device: torch.device | str = default_device(),
) -> Dict[str, np.ndarray]:
    """Greedy point-goal rollouts in the synthetic env.

    Each episode spawns the agent at the plan start, samples a point goal
    ``goal_range`` metres away at a random bearing, and follows the greedy
    teacher until ``rho < stop_radius`` or ``max_steps``. Observations are
    the env's rendered depth, resized to ``depth_shape`` by the resample
    the deployed policy applies (``utils/img.resize_area``), on
    ``device``, one batched call per episode.

    ``transport='u16_half'`` replicates the streamed farm's observation
    seam (``sim_farm.pack_obs`` with depth_half and depth_u16, then the
    dispatch's dequantisation and bilinear upsample, then
    ``itm.step``'s resize): frames are 2x2 box-averaged and u16-quantised
    on the host, dequantised, upsampled to camera resolution and resized on
    the device, so the training distribution is what the network sees
    inside the farm. ``None`` resizes the f32 frames directly.

    Returns numpy arrays: depth (N, T, h, w, 1) f32; goal (N, T, 2) f32
    rho-theta; action (N, T) i32 teacher labels; valid (N, T) bool.
    """
    if transport not in (None, "u16_half"):
        raise ValueError(f"unknown transport {transport!r}")
    env_cfg = env_cfg or FE.EnvConfig()
    plan_fn = getattr(FE, plan_name)
    rng = np.random.default_rng(seed)
    h, w = depth_shape
    N, T = n_episodes, max_steps
    depth = np.zeros((N, T, h, w, 1), np.float32)
    goal = np.zeros((N, T, 2), np.float32)
    action = np.zeros((N, T), np.int32)
    valid = np.zeros((N, T), bool)

    for n in range(N):
        env = FE.FakeObjectNavEnv(plan_fn(seed=seed + n), env_cfg)
        o = env.reset()
        dist = rng.uniform(*goal_range)
        bearing = rng.uniform(-np.pi, np.pi)
        gx = env.x + dist * math.cos(bearing)
        gy = env.y + dist * math.sin(bearing)
        frames = []
        n_t = 0
        for t in range(T):
            lx, ly = gx - env.x, gy - env.y
            c, s = math.cos(-env.yaw), math.sin(-env.yaw)
            rho = math.hypot(lx, ly)
            theta = math.atan2(s * lx + c * ly, c * lx - s * ly)
            if rho < stop_radius:
                break
            a = _greedy_action(theta)
            d = np.asarray(o["depth"], np.float32)
            if transport == "u16_half":
                dh = 0.25 * (d[0::2, 0::2] + d[0::2, 1::2] + d[1::2, 0::2] + d[1::2, 1::2])  # sim_farm._avg2x2_f32
                d = (np.clip(dh, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
            frames.append(d)
            goal[n, t] = (rho, theta)
            action[n, t] = a
            valid[n, t] = True
            n_t = t + 1
            o = env.step(a)
            if o["done"]:
                break
        if frames:
            depth[n, :n_t] = _depth_seam(np.stack(frames), transport, env_cfg, depth_shape, device)
    return {"depth": depth, "goal": goal, "action": action, "valid": valid}


def bc_loss_fn(policy: PointNavPolicy, depth: torch.Tensor, goal: torch.Tensor, action: torch.Tensor,
               valid: torch.Tensor):
    """Teacher-forced BC loss over a (B, T) batch on the policy's device:
    depth (B, T, h, w, 1), goal (B, T, 2) rho-theta, action (B, T) integer
    labels, valid (B, T) bool.

    The recurrence is the one ``PointNavPolicy.act`` runs at serving:
    ``not_done`` False at t = 0 zeroes the state and the previous action,
    True after it, and the previous action is the teacher's (point goals
    are fixed within an episode, so the deployed goal-change reset never
    fires mid-episode). Under teacher forcing every step's LSTM input is
    known up front, so ``PointNavNet.features`` runs once on the B x T
    frames and the head once on the B x T outputs; only ``lstm_step``
    loops over time (where JAX scans all three: one Python step per frame
    made ~21,000 launches per Adam step on the card). Returns (masked mean
    NLL, accuracy) as 0-dim tensors; the loss carries the graph to the
    policy's parameters."""
    net, head = policy.module.net, policy.module.action_distribution
    b, t = action.shape
    dev = depth.device
    prev = torch.cat([torch.zeros((b, 1), dtype=torch.float32, device=dev), action[:, :-1].to(torch.float32)], 1)
    not_done = (torch.arange(t, device=dev) > 0).expand(b, t)
    with exact_f32(dev):
        feats = net.features(depth[..., 0].flatten(0, 1), goal.flatten(0, 1), prev.reshape(b * t, 1),
                             not_done.reshape(b * t, 1)).reshape(b, t, -1)
        h = torch.zeros((NUM_LSTM_LAYERS, b, HIDDEN_SIZE), dtype=torch.float32, device=dev)
        c = torch.zeros_like(h)
        outs = []
        for i in range(t):
            m = not_done[None, :, i, None].to(feats.dtype)  # (1, B, 1) over the layers
            out, h, c = net.lstm_step(feats[:, i], h * m, c * m)
            outs.append(out)
        logits = head(torch.stack(outs, dim=1))  # (B, T, A)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, action[..., None].to(torch.int64))[..., 0]
        vw = valid.to(torch.float32)
        loss = (nll * vw).sum() / vw.sum().clamp(min=1.0)
        acc = ((logits.argmax(dim=-1) == action) & valid).sum() / valid.sum().clamp(min=1)
    return loss, acc


def train_pointnav_bc(
    policy: PointNavPolicy,
    data: Dict[str, np.ndarray],
    *,
    steps: int = 150,
    lr: float = 1e-3,
    batch: int = 8,
    seed: int = 0,
):
    """Adam BC on greedy rollouts, in place on ``policy``'s parameters.

    Adam has optax's defaults (beta 0.9 / 0.999, epsilon 1e-8 added
    outside the square root). Minibatch indices come from
    ``np.random.default_rng(seed).choice(n, size=min(batch, n),
    replace=False)``, the sequence JAX draws; they are drawn up front and
    copied to the device once. Returns (policy, {loss, accuracy} of the
    last step)."""
    params = list(policy.module.parameters())
    dev = params[0].device
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n = data["action"].shape[0]
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, size=min(batch, n), replace=False) for _ in range(steps)]) if steps else None
    dd = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in data.items()}
    idx = torch.from_numpy(idx).to(dev) if steps else None
    loss = acc = torch.zeros(())
    with exact_f32(dev):
        for i in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, acc = bc_loss_fn(policy, *(dd[k][idx[i]] for k in ("depth", "goal", "action", "valid")))
            loss.backward()
            opt.step()
    return policy, {"loss": float(loss.detach()), "accuracy": float(acc)}


def fit_pointnav_to_greedy(
    *,
    depth_shape: Tuple[int, int] = (224, 224),
    episodes: int = 24,
    train_steps: int = 150,
    batch: int = 8,
    lr: float = 1e-3,
    seed: int = 0,
    env_cfg: Optional[FE.EnvConfig] = None,
    max_steps: int = 48,
    transport: Optional[str] = None,
    device: torch.device | str = default_device(),
):
    """Collect greedy rollouts, BC-train the real network (its discrete
    head: the teacher's labels are actions) from
    ``PointNavPolicy.init_random(seed)`` on ``device``, and return the
    trained ``PointNavPolicy`` and {loss, accuracy}: the offline stand-in
    for the reference's pointnav_weights.pth."""
    data = collect_pointnav_rollouts(
        episodes, seed=seed, env_cfg=env_cfg, depth_shape=depth_shape,
        max_steps=max_steps, transport=transport, device=device,
    )
    policy = PointNavPolicy.init_random(seed, depth_shape=depth_shape, discrete=True, device=device)
    return train_pointnav_bc(policy, data, steps=train_steps, lr=lr, batch=batch, seed=seed)
