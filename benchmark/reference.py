"""The plain reference of the dispatch cells, and the numbers it compares.

The reference is the frozen copy (``benchmark/frozen``): the port's own
code at commit 7359553, its kernel wrappers on their plain versions, run in
float32 with TF32 off, its weights made again from the seed by
``weights.py``. It imports nothing of the port and reads nothing the port
made but the outputs it judges, and the state the port held before a
sampled decision: the policy's maps are the port's own state, so a later
decision is followed step by step from it, while the first sampled
decision (decision 0) starts from the reference's own fresh state.

What that holds the port to differs by layer. The models' numerics
(``itm_cos_rms``, ``owl_gap``, ``mask_off``) are held to a float32 run of
the same architectures, against which bfloat16 and kernel faults show. The
detection route and selection (``select_off``), the policy step's maps,
frontier choice and PointNav (``state_gap``) and the packed action
(``out_off``) are the same code on both sides: they are held only to what
the port computed at 7359553, so they catch a later change of those
layers' results, not a fault the port already had there. No reference
written apart from the port, from upstream VLFM's semantics, exists yet.

Per sampled decision, each stage is held to the reference on what the
port fed that stage:

- ``itm_cos_rms``: the root mean square of (cosine - reference's) of
  BLIP2-ITM on the frames, over every lane, prompt channel and sample of
  the run (a widest gap of single cosines swings too much at one lane);
- ``owl_gap``: OWL-ViT on the frames, for each of the dispatch's detect
  calls (the COCO prompts, the target), the worse of the boxes'
  ||port - reference|| / ||reference|| and the logits' RMS error over the
  larger of their RMS and 1 (a logit moves a sigmoid score by at most a
  quarter of its change, so below 1 the error counts in logit units: the
  random weights' logits sit near 0 on some seeds, where a relative error
  has no scale);
- ``select_off``: detections (validity, box, class) where the pipeline's
  route, threshold and top-K selection, applied by the reference to the
  port's own detector outputs, disagree with the port's (exact);
- ``mask_off``: the share of the valid detections' mask pixels where the
  reference's MobileSAM, on the port's boxes, disagrees;
- ``state_gap``: the policy state after the reference's step, from the
  same state and the port's perception, worst leaf: for a floating leaf
  (value map, its confidence, PointNav's recurrence, goals) its largest
  |difference| over the reference leaf's largest magnitude, for a boolean
  or integer leaf (obstacle, explored and navigable maps, object-map
  slots, frontier cache, ...) the share of its entries that differ;
- ``out_off``: the share of lanes whose packed output (action, detected,
  goal to 1 cm) differs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import stack

NUMBERS = ("itm_cos_rms", "owl_gap", "select_off", "mask_off", "state_gap", "out_off")


def to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def to_device(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_device(v, device) for v in x)
    return x


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 off for the block (the reference's float32), or the control's
    lower precisions on: TF32, with the frozen copy's ``exact_f32`` blocks
    (which would turn it off again around PointNav) left open,
    and float8 (e4m3) q, k and v in every attention of the frozen models,
    as an fp8 attention kernel takes them."""
    import sys

    from benchmark.frozen.models import layers

    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    swapped = []
    if tf32:
        for name, mod in list(sys.modules.items()):
            if name.startswith("benchmark.frozen.") and callable(getattr(mod, "exact_f32", None)):
                swapped.append((mod, "exact_f32", mod.exact_f32))
                mod.exact_f32 = lambda device: contextlib.nullcontext()
        for attr in ("attention", "fused_attention"):
            fn = getattr(layers, attr)
            swapped.append((layers, attr, fn))
            setattr(layers, attr, lambda q, k, v, *a, _fn=fn, **kw: _fn(stack.fp8_round(q), stack.fp8_round(k),
                                                                          stack.fp8_round(v), *a, **kw))
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c
        for mod, attr, fn in swapped:
            setattr(mod, attr, fn)


class ReplayDetector:
    """Stands in for the detector and returns the port's own detect outputs
    in call order, so the reference's pipeline runs its route, selection and
    SAM on exactly what the port's detector gave."""

    def __init__(self, real, detects, device):
        self.real, self.device = real, device
        self.detects = [(to_device(b, device), to_device(l, device)) for _, b, l in detects]

    def __getattr__(self, name):
        return getattr(self.real, name)

    def preprocess(self, rgb):
        return rgb

    def detect(self, images, input_ids, attention_mask):
        return self.detects.pop(0)


def _leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, value in zip(tree._fields, tree):
        yield from _leaves(value, f"{prefix}.{name}" if prefix else name)


def state_numbers(got, want) -> Dict[str, float]:
    """state_gap of a state against the reference's: the worst leaf."""
    gap = 0.0
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            raise RuntimeError(f"state leaf {name}: shape {tuple(g.shape)} against {tuple(w.shape)}")
        if not g.is_floating_point():
            gap = max(gap, float((g != w).double().mean()) if g.numel() else 0.0)
            continue
        g, w = g.double(), w.double()
        if not bool(torch.isfinite(g[~torch.isinf(g)]).all()):
            return {"state_gap": math.inf}  # a NaN
        if not bool(((torch.isinf(g) == torch.isinf(w)) & ((g == w) | ~torch.isinf(w))).all()):
            gap = max(gap, 1.0)  # an infinity where the reference has none, or of the other sign
        fin = torch.isfinite(w) & torch.isfinite(g)
        if bool(fin.any()):
            scale = float(w[fin].abs().max())
            gap = max(gap, float((g[fin] - w[fin]).abs().max()) / max(scale, 1e-6))
    return {"state_gap": gap}


def cos_sums(got: torch.Tensor, want: torch.Tensor) -> Dict[str, float]:
    """One sample's squared cosine errors, summed, and their count."""
    d = got.double() - want.double()
    return {"cos_sq": float(d.pow(2).sum()) if bool(torch.isfinite(d).all()) else math.inf, "cos_n": d.numel()}


def summarise(per_sample: List[Dict[str, float]], names, limits: Dict[str, float]) -> Dict[str, tuple]:
    """{number: (value, limit)}: ``itm_cos_rms`` over every sampled cosine,
    every other number the largest over the samples."""
    out = {"itm_cos_rms": math.sqrt(sum(n["cos_sq"] for n in per_sample) / max(sum(n["cos_n"] for n in per_sample), 1))}
    for k in names:
        if k != "itm_cos_rms":
            out[k] = max(n[k] for n in per_sample)
    return {k: (out[k], float(limits[k])) for k in names}


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over every entry."""
    want = want.double()
    return float(torch.linalg.vector_norm(got.double() - want)) / max(float(torch.linalg.vector_norm(want)), 1e-12)


def out_off(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of lanes whose (action, detected) differ or goal is 1 cm off."""
    got, want = got.double().cpu(), want.double().cpu()
    bad = (got[:, :2] != want[:, :2]).any(dim=1) | ((got[:, 2:] - want[:, 2:]).abs() > 0.01).any(dim=1)
    bad |= ~torch.isfinite(got).all(dim=1)
    return float(bad.double().mean())


class DispatchReference:
    """The frozen stack of a configuration on one side ("reference": f32,
    TF32 off; "control": float8-rounded weights, TF32 on)."""

    def __init__(self, config: dict, seed: int, device, lanes: int, side: str = "reference"):
        from benchmark.frozen.runner import full_stack

        self.config, self.device, self.lanes, self.side = config, torch.device(device), lanes, side
        self.tf32 = side == "control"
        self.cfg, self.spec = stack.vlfm_config(config, side)
        with precision(self.tf32):
            models = {role: stack.build_model(s, role, seed, side, self.device)
                      for role, s in config["models"].items()}
        self.models = models
        self.perception = full_stack.FullStackPerception(
            self.cfg, itm=models["itm"], detector=models["detector"], sam=models["sam"],
            det_threshold=self.cfg.non_coco_threshold, device=self.device)
        self.target = config["target"]
        self.version = config.get("version", "v2")

    # --- the stages ---------------------------------------------------------------
    @torch.no_grad()
    def cosines(self, rgb: torch.Tensor) -> torch.Tensor:
        p = self.perception
        with precision(self.tf32):
            return p.itm.cosine_cached_text(p.itm.preprocess(rgb), p.engine.text_features(self.target))

    @torch.no_grad()
    def detect(self, rgb: torch.Tensor, input_ids: torch.Tensor):
        """OWL-ViT's (boxes, logits) for one query set, with its mask."""
        pipe = self.perception.pipeline
        ids, mask = pipe._queries(self.target)
        if input_ids.shape[0] != ids.shape[0]:
            ids, mask = pipe.coco_detector._coco_queries()
        det = pipe.detector
        with precision(self.tf32):
            return det.detect(det.preprocess(rgb), ids, mask)

    @torch.no_grad()
    def pipeline_from(self, rgb: torch.Tensor, detects, out_hw="camera"):
        """The pipeline's route, selection and SAM on the given detect
        outputs; masks on the camera grid (the dispatch's ``out_hw``) or,
        with ``out_hw=None``, on the frame's."""
        pipe = self.perception.pipeline
        real = pipe.detector
        replay = ReplayDetector(real, detects, self.device)
        pipe.detector = replay
        if pipe.coco_detector is not None:
            pipe.coco_detector.detector = replay
        if out_hw == "camera":
            out_hw = (self.cfg.camera.height, self.cfg.camera.width)
        try:
            with precision(self.tf32):
                return pipe(rgb, self.target, out_hw)
        finally:
            pipe.detector = real
            if pipe.coco_detector is not None:
                pipe.coco_detector.detector = real

    @torch.no_grad()
    def step(self, before, inputs: Dict[str, np.ndarray], cos, masks, valid):
        """(packed out (B, 4), state after) of one dispatch's policy step."""
        from benchmark.frozen.policy import itm as ITM
        from benchmark.frozen.runner.episode_driver import observation, pack_outputs, step_keys

        dev = self.device
        state = (ITM.create_state(self.spec, self.cfg, batch=self.lanes, device=dev) if before is None
                 else to_device(before, dev))
        f = {k: torch.from_numpy(v).to(dev) for k, v in inputs.items()}
        with precision(self.tf32):
            state = ITM.reset_lanes(state, f["reset"].to(torch.bool))
            action, info, state = ITM.step(
                state, observation(f["depth"], f["xy"], f["heading"], self.cfg),
                cos.to(dev)[:, : self.cfg.value_channels], masks.to(dev), valid.to(dev),
                step_keys(f["seeds"], f["steps"]), pointnav=self.models["pointnav"], spec=self.spec,
                cfg=self.cfg, version=self.version)
            return pack_outputs(action, info), state

    def outputs(self, rec: dict, first: bool) -> dict:
        """A record of this side's own outputs on a sample's inputs (the
        control in the port's place)."""
        rgb = torch.from_numpy(rec["inputs"]["rgb"]).to(self.device)
        cos = self.cosines(rgb)
        detects = [(ids, *self.detect(rgb, ids)) for ids, _, _ in rec["detects"]]
        masks, valid, boxes = self.pipeline_from(rgb, detects)
        out, after = self.step(None if first else rec["before"], rec["inputs"], cos, masks, valid)
        return dict(inputs=rec["inputs"], before=rec["before"], cos=cos, detects=detects, masks=masks,
                    valid=valid, boxes=boxes, out=out, after=after)

    # --- the comparison --------------------------------------------------------------
    def _owl_gap(self, rgb: torch.Tensor, detects) -> float:
        gap = 0.0
        for ids, boxes, logits in detects:
            wb, wl = self.detect(rgb, ids.to(self.device))
            lg, bx, wl = logits.to(self.device).double(), boxes.to(self.device).double(), wl.double()
            if not bool(torch.isfinite(lg).all() and torch.isfinite(bx).all()):
                return math.inf
            logit_gap = float((lg - wl).pow(2).mean().sqrt()) / max(float(wl.pow(2).mean().sqrt()), 1.0)
            gap = max(gap, rel_l2(bx, wb), logit_gap)
        return gap

    def _selection(self, rgb: torch.Tensor, rec: dict, out_hw="camera") -> Dict[str, float]:
        """select_off and mask_off: the reference's route, selection and SAM
        on the port's own detect outputs, against the port's pipeline."""
        dev = self.device
        masks, valid, (xyxy, scores, cls) = self.pipeline_from(rgb, rec["detects"], out_hw)
        gv = rec["valid"].to(dev)
        gx, gs, gc = (t.to(dev) for t in rec["boxes"])
        select = int((valid != gv).sum()) + int(((xyxy != gx).any(-1) & gv).sum()) + int(((cls != gc) & gv).sum())
        gm = rec["masks"].to(dev)
        per_slot = (gm != masks).flatten(2).sum(-1)  # (B, K)
        pixels = int(gv.sum()) * gm.shape[-1] * gm.shape[-2]
        return {"select_off": float(select), "mask_off": float(per_slot[gv].sum()) / pixels if pixels else 0.0}

    def numbers(self, rec: dict, first: bool) -> Dict[str, float]:
        dev = self.device
        rgb = torch.from_numpy(rec["inputs"]["rgb"]).to(dev)
        n: Dict[str, float] = {}
        n.update(cos_sums(rec["cos"].to(dev), self.cosines(rgb)))
        n["owl_gap"] = self._owl_gap(rgb, rec["detects"])
        n.update(self._selection(rgb, rec))
        out, after = self.step(None if first else rec["before"], rec["inputs"], rec["cos"], rec["masks"],
                               rec["valid"])
        n.update(state_numbers(rec["after"], after))
        n["out_off"] = out_off(rec["out"], out)
        return n

    def compare(self, records: List[dict], limits: Dict[str, float]) -> Dict[str, tuple]:
        """{number: (over the samples, limit)}: the RMS of the cosines, the
        largest of every other number."""
        return summarise([self.numbers(rec, first=i == 0) for i, rec in enumerate(records)], NUMBERS, limits)


# --- FLOPs from shapes ------------------------------------------------------------------
def count_flops(fn, *args) -> int:
    """Matrix FLOPs of ``fn(*args)`` (``torch.utils.flop_counter``), on any device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.enable_grad(), FlopCounterMode(display=False) as counter:  # its module tracker needs grad
        fn(*args)
    return int(counter.get_total_flops())


def dispatch_flops(config: dict, lanes: int, sam_passes: float, device: str = "meta"):
    """[(FLOPs, compute dtype)] of one dispatch's model calls at ``lanes``:
    ITM's image branch, OWL-ViT's two detect calls (the 80 COCO prompts,
    the target), ``sam_passes`` gated MobileSAM passes of
    ``sam_frame_capacity`` frames and 8 boxes each, and PointNav's act;
    counted on the frozen copy's modules (shapes only on ``meta``)."""
    from benchmark.frozen.models.coco_classes import COCO_CLASSES
    from benchmark.frozen.models.pointnav import initial_state
    from benchmark.frozen.models.tokenizer import WordPieceTokenizer, toy_vocab

    specs = config["models"]
    cfg, _ = stack.vlfm_config(config, "reference")
    dev = torch.device(device)
    dt = {role: s.get("compute", s.get("serve", "float32")) for role, s in specs.items()}
    out = []
    _, itm = stack._net(specs["itm"], "reference", dev)
    s = stack.model_config(specs["itm"], "reference").vit.image_size
    out.append((count_flops(itm.image_feats, torch.zeros(lanes, s, s, 3, device=dev)), dt["itm"]))
    del itm
    dcfg, det = stack._net(specs["detector"], "reference", dev)
    tok = WordPieceTokenizer(toy_vocab(), max_len=8)
    s = dcfg.vision.image_size
    img = torch.zeros(lanes, s, s, 3, device=dev)
    for names in (COCO_CLASSES, config["target"].split("|")):
        ids, mask = tok.encode_batch(list(names))
        out.append((count_flops(det, img, ids.to(dev), mask.to(dev)), dt["detector"]))
    del det
    scfg, sam = stack._net(specs["sam"], "reference", dev)
    cap = min(cfg.sam_frame_capacity or lanes, lanes)
    s = scfg.vision.image_size
    one = count_flops(sam, torch.zeros(cap, s, s, 3, device=dev),
                      torch.zeros(cap, cfg.max_detections_per_frame, 4, device=dev))
    out.append((one * sam_passes, dt["sam"]))
    del sam
    _, pn = stack._net(specs["pointnav"], "reference", dev)
    h, w = cfg.depth_image_shape
    st = initial_state(lanes, discrete=specs["pointnav"].get("args", {}).get("discrete", True), device=dev)
    net = pn.net
    out.append((count_flops(lambda: net.lstm_step(net.features(
        torch.zeros(lanes, h, w, device=dev), torch.zeros(lanes, 2, device=dev), st.prev_action,
        st.not_done), st.h, st.c)), dt["pointnav"]))
    return out
