"""Parameters of the port's models: JAX trees in, seeded random init.

``state_dict_from_jax_params`` maps a ``vlfm_tpu`` flax parameter tree
(numpy leaves) onto a port module whose submodules carry the flax scope
names. ``init_random_`` fills a module from a ``torch.Generator`` with the
flax initializers' scales (the same seed gives other numbers than JAX's
init).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from benchmark.frozen.models.layers import Norm


@torch.no_grad()
def init_random_(module: nn.Module, gen: torch.Generator, stds: Mapping[str, float] | None = None) -> None:
    """Fill every parameter from ``gen``: unit/zero norms, N(0, 1/dim) rows
    of an ``nn.Embedding``, lecun-normal weights of every other module whose
    ``weight`` has two or more axes (Dense, Conv, the SAM upscale) with zero
    biases. Any other parameter is N(0, std²), with std taken from ``stds``
    by the parameter's own name (0 means zeros), else 0.02 (flax's scale for
    learned embeddings)."""
    stds = stds or {}
    seen = set()
    for mod in module.modules():
        weight = mod._parameters.get("weight")
        if isinstance(mod, Norm):
            mod.weight.fill_(1.0)
            if mod._parameters.get("bias") is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, mod.embedding_dim**-0.5, generator=gen)
        elif weight is not None and weight.ndim >= 2:
            weight.normal_(0.0, weight[0].numel() ** -0.5, generator=gen)
            if mod._parameters.get("bias") is not None:
                mod.bias.zero_()
        else:
            continue
        seen.update(id(p) for p in mod.parameters(recurse=False))
    for name, p in module.named_parameters():
        if id(p) in seen:
            continue
        std = stds.get(name.rpartition(".")[2], 0.02)
        if std == 0.0:
            p.zero_()
        else:
            p.normal_(0.0, std, generator=gen)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")  # one writable, contiguous copy
    if a.dtype.name == "bfloat16":  # numpy's bf16 (ml_dtypes) has no torch twin
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def port_layout(params_np: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's parameter names for a JAX parameter tree (numpy leaves),
    each leaf re-laid out as a numpy view, nothing copied:
    Dense ``kernel`` (in, out) -> ``weight`` (out, in); Conv ``kernel`` HWIO
    -> ``weight`` OIHW (a depthwise (3, 3, 1, C) becomes (C, 1, 3, 3), SAM's
    upscale (2, 2, Cin, Cout) becomes (Cout, Cin, 2, 2));
    ``Embed.embedding`` -> ``weight``; norm ``scale`` -> ``weight``. Every
    other leaf keeps its name and layout."""
    out: Dict[str, np.ndarray] = {}
    for name, leaf in _flatten(params_np).items():
        scope, _, leaf_name = name.rpartition(".")
        a = np.asarray(leaf)
        if leaf_name == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            leaf_name = "weight"
        elif leaf_name in ("embedding", "scale"):
            leaf_name = "weight"
        out[f"{scope}.{leaf_name}" if scope else leaf_name] = a
    return out


def state_dict_from_jax_params(params_np: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``port_layout`` as contiguous CPU tensors, one copy per leaf."""
    return {name: _to_tensor(a) for name, a in port_layout(params_np).items()}


@torch.no_grad()
def load_jax_params_(module: nn.Module, params_np: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree (numpy leaves) into ``module``'s
    parameters and buffers, one leaf at a time, so a load holds one leaf's
    copy beyond the tree and the module. Strict, as ``load_state_dict``: a
    missing or unexpected name, or another shape, raises before anything is
    copied."""
    layout = port_layout(params_np)
    own = module.state_dict(keep_vars=True)
    missing, unexpected = sorted(own.keys() - layout.keys()), sorted(layout.keys() - own.keys())
    shapes = [n for n in own.keys() & layout.keys() if tuple(own[n].shape) != layout[n].shape]
    if missing or unexpected or shapes:
        raise RuntimeError(f"loading a JAX tree into {type(module).__name__}: missing {missing}, unexpected "
                           f"{unexpected}, other shapes {[(n, layout[n].shape, tuple(own[n].shape)) for n in shapes]}")
    for name, a in layout.items():
        own[name].copy_(_to_tensor(a))
    return module
