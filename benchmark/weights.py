"""Random weights from the run's seed, made by the benchmark on the device.

The benchmark, not the port, makes every weight, so the plain reference
can make the same ones again: each model's parameters are drawn in the
order of the frozen copy's module (``benchmark/frozen``), under its
parameter names, with the scales of the port's ``init_random`` at commit
7359553 (lecun-normal kernels, unit norms, zero biases, N(0, 1/dim)
embeddings, per-model overrides), from one ``torch.Generator`` on the
device in chunks of ``CHUNK`` values. ``load_`` copies them into any module
whose parameters carry those names and shapes (the port's modules do), in
that module's dtype: a bf16 parameter is the round-to-nearest of the f32
value the reference gets.
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from benchmark.frozen.models.layers import Norm

CHUNK = 1 << 26  # values per generator call: 256 MiB of f32


def stream_seed(seed: int, tag: str) -> int:
    """One generator seed per (run seed, model): any whole seed, a name mixed in."""
    return (int(seed) * 0x9E3779B1 + zlib.crc32(tag.encode())) % (1 << 63)


def _plan(module: nn.Module, rule: str, stds: Dict[str, float], fills: Dict[str, float]):
    """[(name, shape, std or None, constant)] in ``named_parameters`` order:
    a std draws N(0, std^2), None fills the constant."""
    kind: Dict[int, Tuple[Optional[float], float]] = {}
    if rule == "flax":  # the port's models/params.py:init_random_
        for mod in module.modules():
            weight = mod._parameters.get("weight")
            if isinstance(mod, Norm):
                kind[id(mod.weight)] = (None, 1.0)
                if mod._parameters.get("bias") is not None:
                    kind[id(mod.bias)] = (None, 0.0)
            elif isinstance(mod, nn.Embedding):
                kind[id(mod.weight)] = (mod.embedding_dim ** -0.5, 0.0)
            elif weight is not None and weight.ndim >= 2:
                kind[id(weight)] = (weight[0].numel() ** -0.5, 0.0)
                if mod._parameters.get("bias") is not None:
                    kind[id(mod.bias)] = (None, 0.0)
    elif rule == "pointnav":  # the port's models/pointnav.py:PointNavPolicy.init_random
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if p.ndim >= 2:
                    kind[id(p)] = (p[0].numel() ** -0.5, 0.0)
                else:
                    kind[id(p)] = (None, 1.0 if isinstance(mod, nn.GroupNorm) and name == "weight" else 0.0)
    else:
        raise ValueError(f"unknown init rule {rule!r}")
    plan = []
    for name, p in module.named_parameters():
        leaf = name.rpartition(".")[2]
        std, const = kind.get(id(p), (stds.get(leaf, 0.02), 0.0))
        if std == 0.0:
            std, const = None, 0.0
        for suffix, value in fills.items():
            if name.endswith(suffix):
                std, const = None, value
        plan.append((name, tuple(p.shape), std, const))
    return plan


def stream(template: nn.Module, seed: int, tag: str, device, rule: str = "flax",
           stds: Optional[Dict[str, float]] = None,
           fills: Optional[Dict[str, float]] = None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, f32 tensor on ``device``) for every parameter of ``template``
    (a frozen-copy module, e.g. on ``meta``), in order, drawn in chunks."""
    plan = _plan(template, rule, stds or {}, fills or {})
    total = sum(int(torch.Size(shape).numel()) for _, shape, std, _ in plan if std is not None)
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, tag))
    buf, pos, drawn = torch.empty(0, device=device), 0, 0
    for name, shape, std, const in plan:
        n = int(torch.Size(shape).numel())
        if std is None:
            yield name, torch.full(shape, const, dtype=torch.float32, device=device)
            continue
        pieces = []
        while n > 0:
            if pos == buf.numel():
                size = min(CHUNK, total - drawn)
                buf, pos = torch.randn(size, generator=gen, device=device, dtype=torch.float32), 0
                drawn += size
            take = min(n, buf.numel() - pos)
            pieces.append(buf[pos:pos + take])
            pos += take
            n -= take
        flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        yield name, (flat * std).reshape(shape)


@torch.no_grad()
def load_(module: nn.Module, weights: Iterator[Tuple[str, torch.Tensor]]) -> nn.Module:
    """Copy every (name, tensor) into ``module``'s parameter of that name,
    cast to its dtype; every parameter must be given once, with its shape."""
    own = dict(module.named_parameters())
    seen = set()
    for name, t in weights:
        if name not in own or tuple(own[name].shape) != tuple(t.shape):
            raise RuntimeError(f"{type(module).__name__} has no parameter {name} of shape {tuple(t.shape)}")
        own[name].copy_(t)
        seen.add(name)
    missing = sorted(own.keys() - seen)
    if missing:
        raise RuntimeError(f"{type(module).__name__}: no weight made for {missing[:5]} ({len(missing)} in all)")
    return module
