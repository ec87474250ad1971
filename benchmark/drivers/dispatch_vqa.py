"""Driver: the packed fused dispatch of the HM3D evaluation with the detection veto on.

The ``dispatch`` driver's loop (``dispatch.py``, extended here), with
``cfg.use_vqa`` on and BLIP-2 flan-T5 built from the benchmark's weight
stream for the role ``vqa`` (``benchmark/weights.py``, drawn over the plain
reference's modules, the port's init rule: T5's relative-position tables
N(0, 1) and its query kernels scaled after the load by the configuration's
``scale_after_load``, on the port and the reference alike), cast for
serving and handed to ``FullStackPerception(cfg, ..., blip2_vqa=...)``: the
veto runs inside the pipeline of every dispatch, as the evaluation runs it.
The mix's ``detections.fills`` set the detector's rate of detections, on
the port and the reference alike.

For each sampled decision the veto's call on the timed path is captured:
its inputs (the frames' pre-veto masks, validity and phrase index), per
pass the annotated frames, the question ids and mask, the projected prefix,
each decoding step's logits at its position and the tokens, and its kept
validity. The large ones go by asynchronous copies into pinned host slabs
made at set-up, so a sampled decision holds no more device memory than any
other.

The check holds the stages outside the veto as ``dispatch``'s six numbers
do, the route, selection and masks on the pre-veto detections, with the
plain veto (``benchmark/plain_blip2_t5.py``, written apart from the port)
asked about what the port asked in the port's place: its kept validity
counts in ``select_off``. Three numbers are added:

- ``vqa_prefix_rms``: the projected prefix's RMS error over the
  reference's RMS, every asked slot of every sample;
- ``vqa_logit_rms``: the decoder's logits at every answer position, the
  reference (T5's weights rounded to the serving dtype as the port holds
  them, float32 products) teacher-forced on the port's prefix, question
  and tokens, the same over the reference's RMS; the same on the
  reference's own prefix, end to end, is printed beside it;
- ``answer_off``: the share of asked slots where the port asked about
  another frame or question than the reference's window holds there, or
  where a generated token differs from the reference's top-1 at a position
  whose top-1/top-2 margin is above the mix's ``tie_margin`` (the positions
  left out are printed).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from benchmark import plain_blip2_t5 as plain
from benchmark import reference, stack
from benchmark import weights as W
from benchmark.drivers import dispatch

VQA_NUMBERS = ("vqa_prefix_rms", "vqa_logit_rms", "answer_off")


def without_vqa(config: dict, use_vqa: bool = False) -> dict:
    """The configuration without the veto's model and with ``use_vqa`` as
    given: what the dispatch driver builds (the veto's model comes from
    here) and what the frozen reference builds (with no veto)."""
    return {**config, "models": {k: v for k, v in config["models"].items() if k != "vqa"},
            "vlfm": {**config["vlfm"], "use_vqa": use_vqa}}


def with_detections(config: dict, mix: dict) -> dict:
    """The configuration with the mix's detector fills (its detection rate)
    laid over the detector's own, for the port and the reference alike."""
    fills = mix.get("detections", {}).get("fills", {})
    det = config["models"]["detector"]
    det = {**det, "fills": {**det.get("fills", {}), **fills}}
    return {**config, "models": {**config["models"], "detector": det}}


def vqa_stream(spec: dict, seed: int, device):
    """The weights of the role ``vqa``, drawn over the plain model's names on
    ``meta`` (its norms, which the stream's rule does not know as such,
    filled with unit scales and zero biases)."""
    template = plain.BLIP2T5(plain.Dims.from_json(spec["widths"]), device="meta")
    return W.stream(template, seed, "vqa", device, rule="flax", stds=spec.get("stds"),
                    fills=plain.norm_fills(template))


@torch.no_grad()
def _scale_after_load(module: nn.Module, spec: dict) -> None:
    for suffix, factor in spec.get("scale_after_load", {}).items():
        for name, p in module.named_parameters():
            if name.endswith(suffix):
                p.mul_(factor)


def served_names(model: nn.Module, dtype: torch.dtype) -> set:
    """Parameters the port's serving cast puts in ``dtype`` (the frozen
    copy's rule run on a ``meta`` twin, every norm's parameters kept, as
    the port keeps them)."""
    from benchmark.frozen.models.precision import cast_for_serving

    twin = plain.BLIP2T5(model.dims, device="meta")
    norms = set(plain.norm_fills(twin))
    cast_for_serving(twin, dtype)
    return {n for n, p in twin.named_parameters() if p.dtype == dtype} - norms


@torch.no_grad()
def build_port_vqa(spec: dict, seed: int, device):
    """The port's ``BLIP2VQA`` at the configuration's preset, cast for
    serving (the ViT, Q-Former and projection, and T5, in ``serve``), with
    the benchmark's weights."""
    from vlfm_tpu_torch.models import blip2_vqa, t5_vqa
    from vlfm_tpu_torch.models.precision import cast_for_serving

    cfg = getattr(blip2_vqa.BLIP2VQAConfig, spec["preset"])()
    d = plain.Dims.from_json(spec["widths"])
    for part in ("vit", "qformer", "t5"):
        got, want = dataclasses.asdict(getattr(cfg, part)), dataclasses.asdict(getattr(d, part))
        if got != want:
            raise RuntimeError(f"the port's {spec['preset']} {part} is {got}, the configuration states {want}")
    if str(cfg.compute_dtype).rpartition(".")[2] != spec["compute"]:
        raise RuntimeError(f"the port's preset computes in {cfg.compute_dtype}, the configuration states "
                           f"{spec['compute']}")
    holder = nn.Module()
    holder.prefix = blip2_vqa.BLIP2VisualPrefixModule(cfg, device=device)
    holder.t5 = t5_vqa.T5Module(cfg.t5, device=device)
    for part in (holder.prefix, holder.t5):
        cast_for_serving(part, stack.DTYPES[spec["serve"]])
    W.load_(holder, vqa_stream(spec, seed, device))
    _scale_after_load(holder, spec)
    return blip2_vqa.BLIP2VQA(cfg, holder.prefix, t5_vqa.T5VQA(cfg.t5, holder.t5))


# T5's products in each control: (operand rounding, output rounding).
T5_CONTROLS = {"control": (plain.round_tf32, plain.same), "control_bf16": (plain.round_bf16, plain.round_bf16)}


@torch.no_grad()
def build_plain_vqa(spec: dict, seed: int, side: str, device) -> plain.BLIP2T5:
    """The plain model with the benchmark's weights, T5's served ones
    rounded to the serving dtype as the configuration states them (its
    embedding table held in that dtype, so the decoder's first norm
    normalises its rows in it).

    "reference": float32, TF32 off. "control", one precision down from
    what the configuration states: the prefix's served weights and every
    linear's input through float8 with TF32 on (its stated bfloat16, one
    down), T5's products in TF32 (its stated float32, one down).
    "control_bf16": the same prefix, T5's products in bfloat16 (LAVIS's
    precision), a reading beside the control's."""
    model = plain.BLIP2T5(plain.Dims.from_json(spec["widths"]), device=device, tf32=side != "reference")
    W.load_(model, vqa_stream(spec, seed, device))
    dtype = stack.DTYPES[spec["serve"]]
    served = served_names(model, dtype)
    t5_served = [p for name, p in model.t5.named_parameters() if f"t5.{name}" in served]
    for p in t5_served:  # loaded in the serving dtype, as the port loads them
        p.copy_(p.to(dtype).float())
    _scale_after_load(model, spec)
    for p in t5_served:  # and scaled there
        p.copy_(p.to(dtype).float())
    # Its embedding rows are looked up in that dtype, as the port looks them up.
    model.t5.embed.weight.data = model.t5.embed.weight.data.to(dtype)
    if side != "reference":
        stack._fp8_round_(model.prefix, {n[len("prefix."):] for n in served if n.startswith("prefix.")})
        plain.lower_matmuls_(model.t5, *T5_CONTROLS[side])
    return model.eval()


def veto_flops(spec: dict, rows: int, question_len: int, steps: int, device: str = "meta"):
    """[(FLOPs, compute dtype)] of the model's work in one veto pass of
    ``rows`` slots, whatever way the port computes it: the visual prefix;
    T5's encoder over the prefix and the question once; and the decoder
    once over the ``steps`` positions it generates, each position made
    once and the cross-attention's keys and values once a pass (what
    decoding with a cache computes, its self-attention products counted
    over all ``steps`` keys); counted on the plain modules (shapes only on
    ``meta``)."""
    model = plain.BLIP2T5(plain.Dims.from_json(spec["widths"]), device=device)
    d = model.dims
    dev = torch.device(device)
    s = d.vit.image_size
    out = [(reference.count_flops(model.prefix, torch.zeros(rows, s, s, 3, device=dev)), spec["compute"])]
    ids = torch.zeros(rows, question_len, dtype=torch.int64, device=dev)
    mask = torch.ones(rows, question_len, dtype=torch.bool, device=dev)
    prefix = torch.zeros(rows, d.qformer.num_queries, d.t5.d_model, device=dev)
    out.append((reference.count_flops(model.t5.encode, ids, mask, prefix), spec["t5_compute"]))
    n = d.qformer.num_queries + question_len
    enc = torch.zeros(rows, n, d.t5.d_model, device=dev)
    enc_mask = torch.ones(rows, n, dtype=torch.bool, device=dev)
    tokens = torch.zeros(rows, steps, dtype=torch.int64, device=dev)
    out.append((reference.count_flops(model.t5.decode, tokens, enc, enc_mask), spec["t5_compute"]))
    return out


# --- the capture on the timed path --------------------------------------------------------
class Slab:
    """One sample's pinned host buffers for the veto's large outputs."""

    def __init__(self, passes: int, rows: int, lanes: int, k: int, hw, queries: int, d_model: int,
                 steps: int, vocab: int, pin: bool):
        h, w = hw
        self.masks = torch.empty(lanes, k, h, w, dtype=torch.bool, pin_memory=pin)
        self.frames = torch.empty(passes, rows, h, w, 3, dtype=torch.uint8, pin_memory=pin)
        self.prefix = torch.empty(passes, rows, queries, d_model, dtype=torch.float32, pin_memory=pin)
        self.logits = torch.empty(passes, steps, rows, vocab, dtype=torch.float32, pin_memory=pin)


class VetoTap:
    """Stands where the pipeline reads its veto. Every call keeps its
    pre-veto valid count and its frames with a valid detection (device
    scalars, for the FLOPs' veto and SAM passes); while a slab is armed,
    the call's inputs and outputs go into it and into small device copies,
    which ``take`` brings to the host after the decision."""

    def __init__(self, veto, slabs: List[Slab]):
        self.veto, self.slabs = veto, slabs
        self.valid_counts: List[torch.Tensor] = []
        self.frames: List[torch.Tensor] = []
        self.slab: Optional[Slab] = None
        self.data: dict = {}
        prefix, t5 = veto.image_prefix, veto.vqa
        veto.image_prefix = self._prefix_tap(prefix)
        veto.vqa = self._t5_tap(t5)

    def arm(self, k: int) -> None:
        self.slab, self.data = self.slabs[k], {"passes": []}

    def __getattr__(self, name):
        return getattr(self.veto, name)

    def __call__(self, rgb, masks, valid, phrases, cls=None):
        self.valid_counts.append(valid.sum())
        self.frames.append(valid.any(dim=1).sum())
        s = self.slab
        if s is not None:
            s.masks.copy_(masks, non_blocking=True)
            self.data.update(valid=valid.clone(), cls=None if cls is None else cls.clone(), phrases=phrases)
        kept = self.veto(rgb, masks, valid, phrases, cls)
        if s is not None:
            self.data["kept"] = kept.clone()
        return kept

    def _prefix_tap(self, fn):
        def tapped(images):
            out = fn(images)
            s = self.slab
            if s is not None:
                p = len(self.data["passes"])
                s.frames[p].copy_(images, non_blocking=True)
                s.prefix[p].copy_(out, non_blocking=True)
                self.data["passes"].append({})
            return out
        return tapped

    def _t5_tap(self, t5):
        tap = self

        class Module:
            """T5's module inside ``generate``: the question and each step's logits."""

            def __init__(self, module):
                self._m, self.step = module, 0

            def __getattr__(self, name):
                return getattr(self._m, name)

            def encode(self, ids, mask, prefix=None):
                self.step = 0
                if tap.slab is not None:
                    tap.data["passes"][-1].update(ids=ids.clone(), mask=mask.clone())
                return self._m.encode(ids, mask, prefix)

            def decode_logits(self, tokens, enc, mask):
                out = self._m.decode_logits(tokens, enc, mask)
                if tap.slab is not None:
                    tap.slab.logits[len(tap.data["passes"]) - 1, self.step].copy_(out[:, self.step], non_blocking=True)
                self.step += 1
                return out

        tapped = copy.copy(t5)
        tapped.module = Module(t5.module)
        generate = tapped.generate

        def recorded(ids, mask, max_new_tokens=8, prefix=None):
            tokens = generate(ids, mask, max_new_tokens=max_new_tokens, prefix=prefix)
            if tap.slab is not None:
                tap.data["passes"][-1]["tokens"] = tokens.clone()
            return tokens

        tapped.generate = recorded
        return tapped

    def take(self) -> dict:
        """The armed call's record on the host (call after the decision's
        device work is waited for); disarms."""
        s, d = self.slab, self.data
        self.slab, self.data = None, {}
        if s is None or "kept" not in d:
            raise RuntimeError("a sampled decision ran no veto")
        rows = [p["tokens"].shape[0] for p in d["passes"]]
        passes = [dict(frames=s.frames[i, :r], prefix=s.prefix[i, :r], logits=s.logits[i, :, :r].transpose(0, 1),
                       ids=p["ids"].cpu(), mask=p["mask"].cpu(), tokens=p["tokens"].cpu())
                  for i, (p, r) in enumerate(zip(d["passes"], rows))]
        return dict(masks=s.masks, valid=d["valid"].cpu(), cls=None if d["cls"] is None else d["cls"].cpu(),
                    phrases=d["phrases"], kept=d["kept"].cpu(), passes=passes)


class Driver(dispatch.Driver):
    def __init__(self, cell, seed: int, device: str = "cuda"):
        config = with_detections(cell.config, cell.mix)
        spec, vqa_mix = config["models"]["vqa"], cell.mix["vqa"]
        if config["target"] != cell.mix.get("target", config["target"]):
            raise RuntimeError(f"the mix asks about {cell.mix['target']!r}, the configuration's target is "
                               f"{config['target']!r}")
        if config["vlfm"].get("vqa_slot_capacity") != vqa_mix["slot_capacity"]:
            raise RuntimeError("the mix's veto capacity is not the configuration's vqa_slot_capacity")
        dev = torch.device(device)
        self.vqa_spec, self.full_config = spec, config
        self.bridge = build_port_vqa(spec, seed, dev)
        view = copy.copy(cell)
        view.config = without_vqa(config, use_vqa=True)
        from vlfm_tpu_torch.runner import full_stack

        # The dispatch driver builds the stack itself: for that call the
        # stack's constructor takes this model as its veto's.
        real = full_stack.FullStackPerception

        def with_veto(cfg, **kw):
            return real(cfg, blip2_vqa=self.bridge, yes_token_id=spec["yes_token_id"], **kw)

        full_stack.FullStackPerception = with_veto
        try:
            super().__init__(view, seed, device)  # builds the stack with the veto, warms the cell's shapes
        finally:
            full_stack.FullStackPerception = real
        veto = self.perception.pipeline.vqa_veto
        if veto.max_answer_tokens != vqa_mix["answer_tokens"] or veto.slot_capacity != vqa_mix["slot_capacity"]:
            raise RuntimeError(f"the port's veto asks {veto.max_answer_tokens} tokens in windows of "
                               f"{veto.slot_capacity}; the mix states {vqa_mix}")
        slots = self.lanes * self.cfg.max_detections_per_frame
        cap = veto.slot_capacity
        self.rows = slots if cap is None or cap >= slots else cap
        self.question_len = len(veto.encode_text(veto.question_for(self.target.split("|")[0]))[0])
        d = plain.Dims.from_json(spec["widths"])
        slabs = [Slab(-(-slots // self.rows), self.rows, self.lanes, self.cfg.max_detections_per_frame,
                      (self.cfg.camera.height, self.cfg.camera.width), d.qformer.num_queries, d.t5.d_model,
                      veto.max_answer_tokens, d.t5.vocab_size, self.device.type == "cuda")
                 for _ in self.samples]
        self.tap = VetoTap(veto, slabs)
        self.perception.pipeline._pipe.vqa_veto = self.tap

    def decide(self):
        armed = self.n in self.samples and self.n not in self.records
        if armed:
            self.tap.arm(len(self.records))
        out = super().decide()
        if armed:
            self.records[self.n - 1]["veto"] = self.tap.take()
        return out

    @contextlib.contextmanager
    def _frames_before_veto(self):
        """``dispatch``'s frame count read from the tap: SAM's gated passes
        follow the frames with a detection before the veto, and the
        pipeline's proxy counts them after it."""
        kept, self.capture.frames = self.capture.frames, self.tap.frames
        try:
            yield
        finally:
            self.capture.frames = kept

    def flops_per_decision(self):
        """The dispatch's model calls, and the veto's passes at the
        window's mean count of them."""
        with self._frames_before_veto():
            out = super().flops_per_decision()
        slots = self.lanes * self.cfg.max_detections_per_frame
        counts = [int(c) for c in self.tap.valid_counts]
        passes = float(np.mean([1 if self.rows == slots else -(-n // self.rows) for n in counts])) if counts else 0.0
        steps = self.perception.pipeline.vqa_veto.max_answer_tokens
        return out + [(f * passes, dt) for f, dt in veto_flops(self.vqa_spec, self.rows, self.question_len, steps)]

    def summary(self) -> str:
        counts = [int(c) for c in self.tap.valid_counts]
        with self._frames_before_veto():
            frames = super().summary()
        return (f"{frames} before the veto; valid slots a veto call {np.mean(counts) if counts else 0:.2f} over "
                f"{len(counts)} calls")

    def close_program(self) -> None:
        super().close_program()
        self.tap = self.bridge = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, side: str = "reference"):
        return VQAReference(self.full_config, self.seed, self.device, self.lanes, side, self.cell.mix)


class VQAReference(reference.DispatchReference):
    """The frozen dispatch reference with the plain veto in the port's place."""

    def __init__(self, config: dict, seed: int, device, lanes: int, side: str, mix: dict):
        super().__init__(without_vqa(config), seed, device, lanes, "reference" if side == "reference" else "control")
        spec = config["models"]["vqa"]
        with reference.precision(self.tf32):
            self.vqa = build_plain_vqa(spec, seed, side, self.device)
        from benchmark.frozen.models.tokenizer import WordPieceTokenizer, toy_vocab

        tok = WordPieceTokenizer(toy_vocab(), max_len=spec["question_len"])
        vocab = self.vqa.dims.t5.vocab_size

        def encode_text(text):
            ids, mask = tok.encode_batch([text])
            return ids[0] % vocab, mask[0]

        self.veto = plain.Veto(self.vqa, encode_text, spec["yes_token_id"],
                               capacity=config["vlfm"]["vqa_slot_capacity"],
                               max_new_tokens=mix["vqa"]["answer_tokens"], prompt=self.cfg.vqa_prompt)
        self.tie = float(mix["check"]["tie_margin"])

    def _veto(self, rgb, masks, valid, v):
        with reference.precision(self.tf32):
            return self.veto(rgb, masks.to(self.device), valid.to(self.device), v["phrases"],
                             None if v["cls"] is None else v["cls"].to(self.device))

    def outputs(self, rec: dict, first: bool) -> dict:
        """This side's own outputs in the port's record form (the control in
        the port's place), its veto asked about the port's phrases."""
        dev = self.device
        rgb = torch.from_numpy(rec["inputs"]["rgb"]).to(dev)
        cos = self.cosines(rgb)
        detects = [(ids, *self.detect(rgb, ids)) for ids, _, _ in rec["detects"]]
        masks, valid, boxes = self.pipeline_from(rgb, detects)
        kept, asked = self._veto(rgb, masks, valid, rec["veto"])
        passes = [{k: a[k] for k in ("frames", "ids", "mask", "prefix", "logits", "tokens")} for a in asked]
        veto = dict(masks=masks, valid=valid, cls=rec["veto"]["cls"], phrases=rec["veto"]["phrases"], kept=kept,
                    passes=passes)
        post = masks & kept[:, :, None, None]
        out, after = self.step(None if first else rec["before"], rec["inputs"], cos, post, kept)
        return dict(inputs=rec["inputs"], before=rec["before"], cos=cos, detects=detects, masks=post, valid=kept,
                    boxes=boxes, out=out, after=after, veto=veto)

    def _selection(self, rgb: torch.Tensor, rec: dict, out_hw="camera") -> Dict[str, float]:
        """select_off and mask_off on the pre-veto detections, the plain
        veto's kept validity against the port's in select_off; and the
        veto's sums for the three VQA numbers."""
        dev = self.device
        v = rec["veto"]
        masks, valid, (xyxy, scores, cls) = self.pipeline_from(rgb, rec["detects"], out_hw)
        gv = v["valid"].to(dev)
        gx, gs, gc = (t.to(dev) for t in rec["boxes"])
        select = int((valid != gv).sum()) + int(((xyxy != gx).any(-1) & gv).sum()) + int(((cls != gc) & gv).sum())
        gm = v["masks"].to(dev)
        per_slot = (gm != masks).flatten(2).sum(-1)
        pixels = int(gv.sum()) * gm.shape[-1] * gm.shape[-2]
        kept, asked = self._veto(rgb, gm, gv, v)
        select += int((kept != rec["valid"].to(dev)).sum())
        out = {"select_off": float(select), "mask_off": float(per_slot[gv].sum()) / pixels if pixels else 0.0}
        out.update(self._vqa_sums(v["passes"], asked))
        return out

    def _vqa_sums(self, mine: List[dict], theirs: List[dict]) -> Dict[str, float]:
        """Squared errors and their reference's squares, asked and off slots,
        the positions left out as ties."""
        dev = self.device
        s = dict(prefix_sq=0.0, prefix_ref=0.0, logit_sq=0.0, logit_ref=0.0, asked=0, off=0, ties=0, frames_off=0,
                 logit_max=0.0, own_sq=0.0, own_ref=0.0)
        if len(mine) != len(theirs):
            s["off"] = s["asked"] = max(sum(len(p["tokens"]) for p in mine), 1)
            s["prefix_sq"] = s["logit_sq"] = math.inf
            return s
        for p, a in zip(mine, theirs):
            frames = p["frames"].to(dev)
            same_frame = (frames == a["frames"]).flatten(1).all(1)
            same_ids = (p["ids"].to(dev) == a["ids"]).all(1) & (p["mask"].to(dev) == a["mask"]).all(1)
            s["frames_off"] += int((~same_frame).sum())
            want = a["prefix"] if bool(same_frame.all()) else self._prefix(frames)
            got = p["prefix"].to(dev).double()
            s["prefix_sq"] += float((got - want.double()).pow(2).sum())
            s["prefix_ref"] += float(want.double().pow(2).sum())
            tokens = p["tokens"].to(dev)
            with reference.precision(self.tf32):
                forced = self.vqa.forced(p["prefix"].to(dev), p["ids"].to(dev), p["mask"].to(dev), tokens)
            lg = p["logits"].to(dev).double()
            if not bool(torch.isfinite(lg).all()):
                s["logit_sq"] = math.inf
            s["logit_sq"] += float((lg - forced.double()).pow(2).sum())
            s["logit_max"] = max(s["logit_max"], float((lg - forced.double()).abs().max()))
            s["logit_ref"] += float(forced.double().pow(2).sum())
            if bool(same_frame.all()) and bool(same_ids.all()):
                # End to end: the reference's own prefix, not the port's.
                with reference.precision(self.tf32):
                    own = self.vqa.forced(a["prefix"], a["ids"], a["mask"], tokens).double()
                s["own_sq"] += float((lg - own).pow(2).sum())
                s["own_ref"] += float(own.pow(2).sum())
            top = forced.topk(2, dim=-1)
            sure = (top.values[..., 0] - top.values[..., 1]) > self.tie
            differs = (top.indices[..., 0] != tokens) & sure
            off = differs.any(1) | ~same_frame | ~same_ids
            s["asked"] += tokens.shape[0]
            s["off"] += int(off.sum())
            s["ties"] += int((~sure).sum())
        return s

    def _prefix(self, frames):
        with reference.precision(self.tf32):
            return self.vqa.image_prefix(frames)

    def compare(self, records: List[dict], limits: Dict[str, float]) -> Dict[str, tuple]:
        per = [self.numbers(rec, first=i == 0) for i, rec in enumerate(records)]
        out = reference.summarise(per, reference.NUMBERS, limits)
        total = {k: sum(n[k] for n in per) for k in ("prefix_sq", "prefix_ref", "logit_sq", "logit_ref", "asked", "off",
                                                    "ties", "frames_off", "own_sq", "own_ref")}
        vals = {"vqa_prefix_rms": math.sqrt(total["prefix_sq"] / max(total["prefix_ref"], 1e-30)),
                "vqa_logit_rms": math.sqrt(total["logit_sq"] / max(total["logit_ref"], 1e-30)),
                "answer_off": total["off"] / total["asked"] if total["asked"] else 0.0}
        print(f"[check] veto: {total['asked']} slots asked over {len(per)} samples, {total['off']} off, "
              f"{total['frames_off']} asked about another frame, {total['ties']} answer positions left out as ties "
              f"(margin <= {self.tie}); largest logit error {max(n['logit_max'] for n in per):.6g}; logits on the "
              f"reference's own prefix (end to end) {math.sqrt(total['own_sq'] / max(total['own_ref'], 1e-30)):.6g} "
              f"relative RMS", file=sys.stderr)
        out.update({k: (vals[k], float(limits[k])) for k in VQA_NUMBERS})
        return out
