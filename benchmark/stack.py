"""Build a configuration's models and policy settings, on either side.

``side="program"`` builds them from the port (``vlfm_tpu_torch``), cast for
serving as the configuration states; ``side="reference"`` builds the same
architectures from the frozen copy (``benchmark/frozen``) in float32, every
``compute_dtype`` set to float32 and no cast; ``side="control"`` is the
reference computed in float8, the precision below the configuration's:
each parameter that the serving cast would put in bfloat16, and the input
of every linear and convolution of such a model, rounded through float8
(e4m3, one scale per tensor), the products accumulated in float32; a model
served in float32 keeps float32 (its control is TF32, ``reference.py``).
Every side takes the benchmark's weights (``weights.py``) from the same
seed, so the reference never reads a weight the port made.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict

import torch

from benchmark import weights as W

PACKAGES = {"program": "vlfm_tpu_torch", "reference": "benchmark.frozen", "control": "benchmark.frozen"}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def package(side: str, module: str):
    return importlib.import_module(f"{PACKAGES[side]}.{module}")


def _f32(cfg):
    """``cfg`` with every nested ``compute_dtype`` set to float32."""
    changes = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "compute_dtype":
            changes[f.name] = torch.float32
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            changes[f.name] = _f32(v)
    return dataclasses.replace(cfg, **changes)


def model_config(spec: Dict[str, Any], side: str):
    mod = package(side, spec["module"])
    cls = getattr(mod, spec["config"])
    cfg = getattr(cls, spec["preset"])() if spec.get("preset") else cls()
    fields = {k: DTYPES.get(v, v) if k.endswith("dtype") else v for k, v in spec.get("fields", {}).items()}
    cfg = dataclasses.replace(cfg, **fields)
    return cfg if side == "program" else _f32(cfg)


def _net(spec: Dict[str, Any], side: str, device):
    mod = package(side, spec["module"])
    net_cls = getattr(mod, spec["net"])
    if "config" in spec:
        cfg = model_config(spec, side)
        return cfg, net_cls(cfg, device=device)
    args = {k: tuple(v) if isinstance(v, list) else v for k, v in spec.get("args", {}).items()}
    return None, net_cls(**args).to(device)


def _served_names(spec: Dict[str, Any]) -> set:
    """Names of the parameters the serving cast puts in the serving dtype
    (the frozen copy's rule, run on a ``meta`` module)."""
    if spec.get("serve", "float32") == "float32":
        return set()
    from benchmark.frozen.models.precision import cast_for_serving

    _, net = _net(spec, "reference", "meta")
    dtype = DTYPES[spec["serve"]]
    cast_for_serving(net, dtype)
    return {n for n, p in net.named_parameters() if p.dtype == dtype}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to e4m3's 448), back in ``x``'s dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / 448.0
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def _fp8_round_(net: torch.nn.Module, names: set) -> None:
    """The control's float8: the served weights rounded through e4m3, and
    the input of every linear and convolution rounded so at each call
    (the products accumulate in float32)."""
    if not names:
        return
    with torch.no_grad():
        for n, p in net.named_parameters():
            if n in names:
                p.copy_(fp8_round(p))
    for mod in net.modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            mod.register_forward_pre_hook(lambda m, args: (fp8_round(args[0]), *args[1:]))


def weight_stream(spec: Dict[str, Any], seed: int, role: str, device):
    _, template = _net(spec, "reference", "meta")
    return W.stream(template, seed, role, device, rule=spec.get("rule", "flax"), stds=spec.get("stds"),
                    fills=spec.get("fills"))


@torch.no_grad()
def build_model(spec: Dict[str, Any], role: str, seed: int, side: str, device):
    """One model (the wrapper the port's callers take) with the benchmark's
    weights for ``(seed, role)``."""
    cfg, net = _net(spec, side, device)
    if side == "program" and spec.get("serve", "float32") != "float32":
        package(side, "models.precision").cast_for_serving(net, DTYPES[spec["serve"]])
    W.load_(net, weight_stream(spec, seed, role, device))
    if side == "control":
        _fp8_round_(net, _served_names(spec))
    wrapper = getattr(package(side, spec["module"]), spec["wrapper"])
    return wrapper(cfg, net) if cfg is not None else wrapper(net)


def vlfm_config(config: Dict[str, Any], side: str):
    """The policy's ``VLFMConfig`` and map ``GridSpec2D`` of the configuration."""
    cmod = package(side, "config")
    fields = dict(config["vlfm"])
    cam = cmod.CameraConfig(**fields.pop("camera"))
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    cfg = cmod.VLFMConfig(camera=cam, **fields)
    spec = package(side, "mapping.grid").GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    return cfg, spec
