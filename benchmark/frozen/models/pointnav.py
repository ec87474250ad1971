"""PointNav depth-goal controller: ResNet-18 (GroupNorm) + 2-layer LSTM.

Counterpart of ``vlfm_tpu/models/pointnav.py`` (reference:
vlfm/policy/utils/non_habitat_policy/nh_pointnav_policy.py:14-162,
resnet.py:69-153, rnn_state_encoder.py:55-66). NCHW ``nn.Module``s whose
parameter names are the reference checkpoint's
(``net.visual_encoder.backbone.layer1.0.convs.0.weight``, ...,
``net.state_encoder.rnn.weight_ih_l0``, ``action_distribution.linear``),
so ``from_reference_state_dict`` loads the upstream layout as it is.

One ``act`` is one recurrent step for a batch of B episodes: 2x
average-pool, the GN ResNet-18, a 3x3 compression to 128 channels,
``visual_fc`` on the flattened (c, h, w) map, the goal and previous-action
embeddings, one LSTM step (state zeroed where ``not_done`` is False) and
the head: deterministic, the argmax of the 4 logits or the tanh mean of
the continuous head; stochastic (``deterministic=False, rng=key``), a
draw from ``jax.random.categorical`` or ``mu + std * jax.random.normal``
as ``ops/threefry.py`` restates them, bit for bit.

The JAX module flattens the compression output in NHWC (h, w, c) order
(pointnav.py:91), where the reference's ``Flatten`` reads NCHW (c, h, w),
and ``vlfm_tpu/models/torch_import.py`` does not permute ``visual_fc``'s
inputs. So ``from_jax_params`` permutes them, and the port then computes
the JAX package's function; ``from_reference_state_dict`` does not, and
the port then computes the reference's.

Precision: f32 throughout, as JAX's ``cast_for_serving`` leaves PointNav.
``act`` runs whole under ``precision.exact_f32``: its convolutions, linear
layers and LSTM products take no TF32 on the card, whatever the caller
set (``torch.set_float32_matmul_precision`` or the backends' flags).
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.frozen.device import default_device
from benchmark.frozen.models.precision import exact_f32
from benchmark.frozen.ops import threefry

NUM_ACTIONS = 4  # STOP, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT
HIDDEN_SIZE = 512
NUM_LSTM_LAYERS = 2
BASE_PLANES = 32
NGROUPS = 16
COMPRESSION_CHANNELS = 128
EMBED = 32


class PointNavState(NamedTuple):
    h: torch.Tensor  # (L, B, 512)
    c: torch.Tensor  # (L, B, 512)
    prev_action: torch.Tensor  # (B, 1) the last discrete action as a float, or (B, 2)
    not_done: torch.Tensor  # (B, 1) bool; False resets the recurrence


def initial_state(batch: int, discrete: bool = True, *,
                  device: torch.device | str = default_device()) -> PointNavState:
    return PointNavState(
        h=torch.zeros((NUM_LSTM_LAYERS, batch, HIDDEN_SIZE), dtype=torch.float32, device=device),
        c=torch.zeros((NUM_LSTM_LAYERS, batch, HIDDEN_SIZE), dtype=torch.float32, device=device),
        prev_action=torch.zeros((batch, 1 if discrete else 2), dtype=torch.float32, device=device),
        not_done=torch.zeros((batch, 1), dtype=torch.bool, device=device),
    )


def reset_episodes(state: PointNavState, done: torch.Tensor) -> PointNavState:
    """Zero the recurrence of the episodes flagged in the (B,) bool ``done``."""
    keep = ~done
    return PointNavState(
        h=state.h * keep[None, :, None],
        c=state.c * keep[None, :, None],
        prev_action=state.prev_action * keep[:, None],
        not_done=state.not_done & keep[:, None],
    )


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.convs = nn.Sequential(
            _conv3x3(inplanes, planes, stride), nn.GroupNorm(NGROUPS, planes), nn.ReLU(True),
            _conv3x3(planes, planes), nn.GroupNorm(NGROUPS, planes),
        )
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False), nn.GroupNorm(NGROUPS, planes)
            )

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(self.convs(x) + residual)


class ResNet18GN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.Conv2d(1, BASE_PLANES, 7, stride=2, padding=3, bias=False),
            nn.GroupNorm(NGROUPS, BASE_PLANES), nn.ReLU(True),
        )
        inplanes = BASE_PLANES
        for li in range(4):
            planes = BASE_PLANES * 2**li
            stride = 1 if li == 0 else 2
            self.add_module(f"layer{li + 1}", nn.Sequential(BasicBlock(inplanes, planes, stride),
                                                             BasicBlock(planes, planes)))
            inplanes = planes
        self.final_channels = inplanes

    def forward(self, x):
        x = F.max_pool2d(self.conv1(x), 3, stride=2, padding=1)  # pads with -inf, as flax
        for li in range(4):
            x = getattr(self, f"layer{li + 1}")(x)
        return x


class ResNetEncoder(nn.Module):
    """2x average pool -> ResNet-18 (GN) -> 3x3 compression to 128 channels."""

    def __init__(self):
        super().__init__()
        self.backbone = ResNet18GN()
        self.compression = nn.Sequential(
            nn.Conv2d(self.backbone.final_channels, COMPRESSION_CHANNELS, 3, padding=1, bias=False),
            nn.GroupNorm(1, COMPRESSION_CHANNELS), nn.ReLU(True),
        )

    def forward(self, depth):  # (B, 1, H, W)
        return self.compression(self.backbone(F.avg_pool2d(depth, 2)))


class _StateEncoder(nn.Module):
    def __init__(self, input_size: int):
        super().__init__()
        self.rnn = nn.LSTM(input_size, HIDDEN_SIZE, NUM_LSTM_LAYERS)  # parameters only: ``lstm_step`` runs them


def compressed_hw(depth_shape) -> tuple[int, int]:
    """Spatial size of the compression output for a (H, W) depth image:
    the 2x average pool floors, the 7x7/2 stem, the 3x3/2 max pool and the
    three stride-2 stages each take ceil(n / 2)."""
    def down(n, k, p):
        return (n + 2 * p - k) // 2 + 1

    out = []
    for n in depth_shape:
        n = down(down(n // 2, 7, 3), 3, 1)
        for _ in range(3):
            n = down(n, 3, 1)
        out.append(n)
    return out[0], out[1]


class PointNavNet(nn.Module):
    def __init__(self, depth_shape, discrete: bool):
        super().__init__()
        h, w = compressed_hw(depth_shape)
        self.discrete = discrete
        if discrete:
            self.prev_action_embedding_discrete = nn.Embedding(NUM_ACTIONS + 1, EMBED)
        else:
            self.prev_action_embedding_cont = nn.Linear(2, EMBED)
        self.tgt_embeding = nn.Linear(3, EMBED)
        self.visual_encoder = ResNetEncoder()
        self.visual_fc = nn.Sequential(nn.Flatten(), nn.Linear(COMPRESSION_CHANNELS * h * w, HIDDEN_SIZE),
                                       nn.ReLU(True))
        self.state_encoder = _StateEncoder(HIDDEN_SIZE + 2 * EMBED)

    def features(self, depth, pointgoal, prev_action, mask):
        """(B, 576) LSTM input: visual ++ goal ++ previous-action embeddings."""
        vis = self.visual_fc(self.visual_encoder(depth[:, None]))
        goal = torch.stack([pointgoal[:, 0], torch.cos(-pointgoal[:, 1]), torch.sin(-pointgoal[:, 1])], dim=-1)
        goal = self.tgt_embeding(goal)
        if self.discrete:
            prev = torch.where(mask[:, 0], prev_action[:, 0].to(torch.int64) + 1, 0)
            pa = self.prev_action_embedding_discrete(prev)
        else:
            pa = self.prev_action_embedding_cont(mask * prev_action)
        return torch.cat([vis, goal, pa], dim=-1)

    def lstm_step(self, x, h, c):
        """One step of the 2-layer LSTM, gate order i, f, g, o.
        x: (B, I); h, c: (L, B, 512)."""
        rnn = self.state_encoder.rnn
        new_h, new_c = [], []
        for layer in range(NUM_LSTM_LAYERS):
            gates = (F.linear(x, getattr(rnn, f"weight_ih_l{layer}"), getattr(rnn, f"bias_ih_l{layer}"))
                     + F.linear(h[layer], getattr(rnn, f"weight_hh_l{layer}"), getattr(rnn, f"bias_hh_l{layer}")))
            i, f, g, o = gates.chunk(4, dim=-1)
            ct = torch.sigmoid(f) * c[layer] + torch.sigmoid(i) * torch.tanh(g)
            x = torch.sigmoid(o) * torch.tanh(ct)
            new_h.append(x)
            new_c.append(ct)
        return x, torch.stack(new_h), torch.stack(new_c)


class CategoricalHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.linear = nn.Linear(HIDDEN_SIZE, NUM_ACTIONS)

    def forward(self, x):
        return self.linear(x)


class GaussianHead(nn.Module):
    def __init__(self):
        super().__init__()
        self.mu_maybe_std = nn.Linear(HIDDEN_SIZE, 4)

    def forward(self, x):
        mu, log_std = self.mu_maybe_std(x).chunk(2, dim=-1)
        return torch.tanh(mu), torch.exp(torch.clamp(log_std, -5, 2))


class PointNavModule(nn.Module):
    def __init__(self, depth_shape=(224, 224), discrete: bool = True):
        super().__init__()
        self.net = PointNavNet(depth_shape, discrete)
        self.action_distribution = CategoricalHead() if discrete else GaussianHead()


def _conv(w):  # flax HWIO -> torch OIHW
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _dense(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _gn(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["scale"])
    sd[f"{name}.bias"] = np.asarray(p["bias"])


def _reference_state_dict_from_jax(params_np: Mapping[str, Any], depth_shape=(224, 224)) -> dict:
    """A ``vlfm_tpu`` PointNav tree {trunk, heads, lstm} (numpy leaves) under
    the reference checkpoint's names, ``visual_fc``'s input rows permuted
    from JAX's (h, w, c) flatten to the reference's (c, h, w)."""
    sd: dict = {}
    trunk = params_np["trunk"]
    vis = trunk["visual"]
    enc = "net.visual_encoder"
    bb = vis["backbone"]
    sd[f"{enc}.backbone.conv1.0.weight"] = _conv(bb["stem_conv"]["kernel"])
    _gn(sd, f"{enc}.backbone.conv1.1", bb["stem_gn"])
    for li in range(1, 5):
        for bi in range(2):
            blk, pre = bb[f"layer{li}_block{bi}"], f"{enc}.backbone.layer{li}.{bi}"
            sd[f"{pre}.convs.0.weight"] = _conv(blk["conv1"]["kernel"])
            _gn(sd, f"{pre}.convs.1", blk["gn1"])
            sd[f"{pre}.convs.3.weight"] = _conv(blk["conv2"]["kernel"])
            _gn(sd, f"{pre}.convs.4", blk["gn2"])
            if "down_conv" in blk:
                sd[f"{pre}.downsample.0.weight"] = _conv(blk["down_conv"]["kernel"])
                _gn(sd, f"{pre}.downsample.1", blk["down_gn"])
    sd[f"{enc}.compression.0.weight"] = _conv(vis["comp_conv"]["kernel"])
    _gn(sd, f"{enc}.compression.1", vis["comp_gn"])
    h, w = compressed_hw(depth_shape)
    kernel = np.asarray(trunk["visual_fc"]["kernel"])  # (h * w * c, 512), rows in (h, w, c) order
    sd["net.visual_fc.1.weight"] = (
        kernel.reshape(h, w, COMPRESSION_CHANNELS, -1).transpose(3, 2, 0, 1).reshape(kernel.shape[1], -1)
    )
    sd["net.visual_fc.1.bias"] = np.asarray(trunk["visual_fc"]["bias"])
    _dense(sd, "net.tgt_embeding", trunk["tgt_embed"])
    if "prev_action_embed" in trunk:
        sd["net.prev_action_embedding_discrete.weight"] = np.asarray(trunk["prev_action_embed"]["embedding"])
    else:
        _dense(sd, "net.prev_action_embedding_cont", trunk["prev_action_fc"])
    for layer in range(NUM_LSTM_LAYERS):
        p = params_np["lstm"][f"layer{layer}"]
        for k, v in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"), ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            sd[f"net.state_encoder.rnn.{v}_l{layer}"] = np.asarray(p[k])
    heads = params_np["heads"]
    if "action_logits" in heads:
        _dense(sd, "action_distribution.linear", heads["action_logits"])
    else:
        _dense(sd, "action_distribution.mu_maybe_std", heads["mu_maybe_std"])
    return sd


class PointNavPolicy:
    """The recurrent controller, batched over episodes."""

    def __init__(self, module: PointNavModule):
        self.module = module.eval()
        self.discrete = module.net.discrete

    @classmethod
    @torch.no_grad()
    def init_random(cls, seed: int = 0, depth_shape=(224, 224), discrete: bool = True,
                    device: torch.device | str = default_device()) -> "PointNavPolicy":
        """Random f32 weights on ``device`` from a seeded generator there:
        lecun-normal weights, unit GroupNorm scales, zero biases (the same
        seed gives other numbers than JAX's init)."""
        module = PointNavModule(depth_shape, discrete).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if p.ndim >= 2:
                    p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
                else:
                    p.fill_(1.0 if isinstance(mod, nn.GroupNorm) and name == "weight" else 0.0)
        return cls(module)

    @classmethod
    def from_reference_state_dict(cls, sd: Mapping[str, Any], depth_shape=(224, 224),
                                  device: torch.device | str = default_device()) -> "PointNavPolicy":
        """Load a reference checkpoint (nh_pointnav_policy.py's names, numpy
        arrays or tensors) as it is. Every parameter must be present and
        every shape must match."""
        discrete = "action_distribution.linear.weight" in sd
        module = PointNavModule(depth_shape, discrete)
        module.load_state_dict({k: torch.as_tensor(np.array(v, np.float32)) for k, v in sd.items()}, strict=True)
        return cls(module.to(device))

    @classmethod
    def from_jax_params(cls, params_np: Mapping[str, Any], depth_shape=(224, 224),
                        device: torch.device | str = default_device()) -> "PointNavPolicy":
        """Load a ``vlfm_tpu`` PointNav tree (numpy leaves), sized for
        ``depth_shape`` as flax's init sizes ``visual_fc``."""
        return cls.from_reference_state_dict(_reference_state_dict_from_jax(params_np, depth_shape),
                                             depth_shape, device)

    @torch.no_grad()
    def act(self, depth: torch.Tensor, pointgoal: torch.Tensor, state: PointNavState, *,
            deterministic: bool = True, rng: torch.Tensor | None = None):
        """One step for B episodes: depth (B, H, W) in [0, 1], pointgoal (B, 2)
        (rho, theta). Returns ((B, 1) int64 action, or the (B, 2) continuous
        action; the new state). Deterministic: the argmax, or the mean.
        Otherwise ``rng`` is one (2,) threefry key for the batch, as JAX's
        ``act`` takes it: the discrete head draws ``categorical(rng,
        logits)``, the continuous head ``mu + std * normal(rng, mu.shape)``,
        and the draw is the next step's previous action."""
        if not deterministic and rng is None:
            raise ValueError("a stochastic act needs rng=, one (2,) threefry key")
        net = self.module.net
        mask = state.not_done
        with exact_f32(depth.device):
            feats = net.features(depth, pointgoal, state.prev_action, mask)
            m = mask[None].to(feats.dtype)  # (1, B, 1) over the layers
            out, h, c = net.lstm_step(feats, state.h * m, state.c * m)
            if self.discrete:
                logits = self.module.action_distribution(out)
                if deterministic:
                    action = torch.argmax(logits, dim=-1, keepdim=True)
                else:
                    action = threefry.categorical(rng, logits)[:, None]
                prev = action.to(torch.float32)
            else:
                mu, std = self.module.action_distribution(out)
                action = mu if deterministic else mu + std * threefry.normal(rng, tuple(mu.shape))
                prev = action
        return action, PointNavState(h=h, c=c, prev_action=prev, not_done=torch.ones_like(mask))

    @torch.no_grad()
    def logits(self, state: PointNavState) -> torch.Tensor:
        """(B, 4) logits of the discrete head at the state's last LSTM
        output (its top layer's ``h``): the logits the last ``act`` chose
        its action from."""
        with exact_f32(state.h.device):
            return self.module.action_distribution(state.h[-1])
