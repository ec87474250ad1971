"""Serving bundles: convert the published checkpoints once, serve anywhere.

Counterpart of ``vlfm_tpu/runner/weights.py`` and
``vlfm_tpu/models/torch_import.py:load_torch_file``. A bundle is one
directory:

    bundle/
      manifest.json   # {"models": {name: config}, "vocab": "vocab.txt"}
      itm.pt          # torch.save'd state dict of the port's BLIP2ITMModule
      detector.pt     # OwlViTDetectionModule
      sam.pt          # SamModule (MobileSAM's TinyViT or the ViT-det encoder)
      gdino.pt        # GroundingDinoModule
      zoedepth.pt     # ZoeDepthModule
      vqa_bridge.pt   # BLIP2VisualPrefixModule ("vqa" in the manifest)
      vqa_t5.pt       # its T5Module
      vocab.txt       # BERT WordPiece vocab (optional)

written by ``python -m vlfm_tpu_torch.convert_checkpoints`` (the published
state dicts -> the converters -> ``cast_for_serving`` -> ``save_bundle``)
and read by ``load_bundle`` and ``run.py --weights-dir``. Every entry is
optional. The manifest has the JAX package's schema: configs are dataclass
field dicts with a ``__class__`` name and ``{"__dtype__": name}`` for a
dtype. The JAX package stores its entries as orbax trees (an ``itm/``
directory in place of ``itm.pt``); such a bundle is refused, never served
by random models.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vlfm_tpu_torch.device import default_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
# manifest name -> (the module of its model, the wrapper class, the torch module class)
_ENTRIES = {
    "itm": ("blip2_itm", "BLIP2ITM", "BLIP2ITMModule"),
    "detector": ("owl_vit", "OwlViTDetector", "OwlViTDetectionModule"),
    "sam": ("sam", "SAM", "SamModule"),
    "gdino": ("grounding_dino", "GroundingDinoDetector", "GroundingDinoModule"),
    "zoedepth": ("zoedepth", "ZoeDepth", "ZoeDepthModule"),
}
_CONFIG_MODULES = ("blip2_itm", "owl_vit", "sam", "tinyvit", "vit", "qformer", "grounding_dino", "swin",
                   "zoedepth", "blip2_vqa", "t5_vqa")
CONVERTER = "python -m vlfm_tpu_torch.convert_checkpoints"


class BundleError(ValueError):
    """A directory that is not a serving bundle of this package."""


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A torch checkpoint (``.pth``/``.pt``/``.bin``) as name -> numpy
    array, on the CPU, a ``state_dict`` wrapper unwrapped. bf16 tensors come
    back as f32 (numpy has no bf16 of its own); the serving cast makes the
    same bf16 of them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in ckpt.items()}


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """A published state dict as numpy arrays: ``.safetensors`` through the
    ``safetensors`` package, anything else through ``load_torch_file``."""
    if not path.endswith(".safetensors"):
        return load_torch_file(path)
    try:
        from safetensors.numpy import load_file
    except ImportError as e:
        raise ImportError(f"reading {path} needs the `safetensors` package, which is not installed; "
                          "save the state dict with torch.save instead") from e
    return load_file(path)


def _cfg_to_dict(cfg: Any) -> Any:
    if isinstance(cfg, (bool, int, float, str)) or cfg is None:
        return cfg
    if dataclasses.is_dataclass(cfg):
        out = {"__class__": type(cfg).__name__}
        for f in dataclasses.fields(cfg):
            out[f.name] = _cfg_to_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, (tuple, list)):
        return [_cfg_to_dict(v) for v in cfg]
    if isinstance(cfg, torch.dtype):
        name = str(cfg).removeprefix("torch.")
        assert name in _DTYPES, f"unsupported dtype field {name}"
        return {"__dtype__": name}
    raise TypeError(f"cannot write {cfg!r} into a manifest")


def _cfg_from_dict(d: Any, registry: Mapping[str, type]) -> Any:
    if isinstance(d, dict) and "__dtype__" in d:
        return _DTYPES[d["__dtype__"]]
    if isinstance(d, dict) and "__class__" in d:
        if d["__class__"] not in registry:
            raise BundleError(f"the manifest names config class {d['__class__']}, which vlfm_tpu_torch does not "
                              f"have; write the bundle with {CONVERTER}")
        cls = registry[d["__class__"]]
        kwargs = {k: _cfg_from_dict(v, registry) for k, v in d.items() if k != "__class__"}
        for f in dataclasses.fields(cls):  # tuple (of tuple) fields, e.g. Swin's depths, arrive as lists
            if isinstance(kwargs.get(f.name), list):
                kwargs[f.name] = tuple(tuple(v) if isinstance(v, list) else v for v in kwargs[f.name])
        return cls(**kwargs)
    if isinstance(d, list):
        return [_cfg_from_dict(v, registry) for v in d]
    return d


def _config_registry() -> Dict[str, type]:
    """Every dataclass config type of the bundled model families, by name."""
    reg: Dict[str, type] = {}
    for m in _CONFIG_MODULES:
        mod = importlib.import_module(f"vlfm_tpu_torch.models.{m}")
        for name, obj in vars(mod).items():
            if dataclasses.is_dataclass(obj) and isinstance(obj, type):
                reg[name] = obj
    return reg


def _files(manifest: Mapping[str, Any]) -> list:
    """The entry files a manifest names."""
    return [f for name in manifest["models"] for f in (("vqa_bridge", "vqa_t5") if name == "vqa" else (name,))]


def read_manifest(path: str) -> Dict[str, Any]:
    """A bundle's manifest, checked: ``BundleError`` where the directory has
    no manifest, or holds the JAX package's orbax entries, or lacks an
    entry the manifest names."""
    p = Path(path)
    if not (p / "manifest.json").is_file():
        raise BundleError(f"{path} holds no manifest.json: not a serving bundle; write one with {CONVERTER}")
    manifest = json.loads((p / "manifest.json").read_text())
    for f in _files(manifest):
        if (p / f).is_dir():
            raise BundleError(f"{path} is the JAX package's bundle ({f}/ is an orbax tree), which vlfm_tpu_torch "
                              f"does not read; convert the published checkpoints with {CONVERTER}")
        if not (p / f"{f}.pt").is_file():
            raise BundleError(f"{path}: the manifest names {f}, but {f}.pt is missing")
    return manifest


def save_bundle(path: str, *, itm=None, detector=None, sam=None, gdino=None, zoedepth=None, vqa=None,
                vocab_file: Optional[str] = None) -> str:
    """Save model wrappers (each optional; ``vqa`` a ``BLIP2VQA``, its
    bridge and T5 saved apart) as a serving bundle; returns its path."""
    p = Path(path).absolute()
    p.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {"models": {}}
    entries = [("itm", itm), ("detector", detector), ("sam", sam), ("gdino", gdino), ("zoedepth", zoedepth)]
    for name, model in entries:
        if model is not None:
            torch.save(model.module.state_dict(), p / f"{name}.pt")
            manifest["models"][name] = _cfg_to_dict(model.cfg)
    if vqa is not None:
        torch.save(vqa.module.state_dict(), p / "vqa_bridge.pt")
        torch.save(vqa.t5.module.state_dict(), p / "vqa_t5.pt")
        manifest["models"]["vqa"] = _cfg_to_dict(vqa.cfg)
    if vocab_file:
        shutil.copy(vocab_file, p / "vocab.txt")
        manifest["vocab"] = "vocab.txt"
    (p / "manifest.json").write_text(json.dumps(manifest, indent=2))
    return str(p)


def _load_module(module: torch.nn.Module, file: Path, dtype, device) -> torch.nn.Module:
    """``module`` with the entry's tensors in place of its own, in their
    stored dtypes, read straight to ``device``; every key must match."""
    sd = torch.load(file, map_location=device, weights_only=True, mmap=True)
    module.load_state_dict(sd, strict=True, assign=True)
    if dtype is not None:
        from vlfm_tpu_torch.models.precision import cast_for_serving

        cast_for_serving(module, dtype)
    return module


def load_bundle(path: str, dtype: Optional[torch.dtype] = None,
                device: torch.device | str = default_device()) -> SimpleNamespace:
    """Load a bundle into model wrappers on ``device``: namespace(itm,
    detector, sam, gdino, zoedepth, vqa, tokenizer), absent entries None,
    and ``seconds``, each entry's load time on the host's clock.
    ``dtype`` (e.g. torch.bfloat16) applies ``cast_for_serving`` on top of
    the stored dtypes, for an f32-converted bundle."""
    p = Path(path).absolute()
    manifest = read_manifest(str(p))
    reg = _config_registry()
    out: Dict[str, Any] = dict.fromkeys(("itm", "detector", "sam", "gdino", "zoedepth", "vqa", "tokenizer"))
    out["seconds"] = {}
    for name, cfg_d in manifest["models"].items():
        t0 = time.perf_counter()
        cfg = _cfg_from_dict(cfg_d, reg)
        if name == "vqa":
            from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VisualPrefixModule
            from vlfm_tpu_torch.models.t5_vqa import T5VQA, T5Module

            bridge = _load_module(BLIP2VisualPrefixModule(cfg, device=device), p / "vqa_bridge.pt", dtype, device)
            t5 = _load_module(T5Module(cfg.t5, device=device), p / "vqa_t5.pt", dtype, device)
            out[name] = BLIP2VQA(cfg, bridge, T5VQA(cfg.t5, t5))
        else:
            mod_name, wrapper, module_cls = _ENTRIES[name]
            mod = importlib.import_module(f"vlfm_tpu_torch.models.{mod_name}")
            module = getattr(mod, module_cls)(cfg, device=device)
            out[name] = getattr(mod, wrapper)(cfg, _load_module(module, p / f"{name}.pt", dtype, device))
        out["seconds"][name] = time.perf_counter() - t0
    if manifest.get("vocab") and (p / manifest["vocab"]).exists():
        from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer

        out["tokenizer"] = WordPieceTokenizer.from_vocab_file(str(p / manifest["vocab"]))
    return SimpleNamespace(**out)


def full_stack_from_bundle(cfg, bundle_dir: str, dtype: Optional[torch.dtype] = None,
                           device: torch.device | str = default_device()):
    """``FullStackPerception`` over a bundle's models (``run.py
    --weights-dir``). An entry the bundle lacks is the stack's tiny random
    default, as in JAX; the VQA bridge serves only under ``cfg.use_vqa``.
    The bundle's vocabulary, where it has one, tokenizes every prompt, its
    sequences cut to the detector text tower's position table."""
    from vlfm_tpu_torch.runner.full_stack import FullStackPerception

    b = load_bundle(bundle_dir, dtype=dtype, device=device)
    fsp = FullStackPerception(cfg, itm=b.itm, detector=b.detector, sam=b.sam,
                              blip2_vqa=b.vqa if cfg.use_vqa else None, monodepth=b.zoedepth, device=device)
    if b.tokenizer is not None:
        if b.detector is not None:  # 16 for the real OWL-ViT, as its HF processor truncates
            b.tokenizer.max_len = min(b.tokenizer.max_len, b.detector.cfg.text.max_position)
        fsp.tokenizer = fsp.engine.tokenizer = b.tokenizer
    return fsp
