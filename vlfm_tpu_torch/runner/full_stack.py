"""The full stack: the real perception models in the episode loop.

Counterpart of ``vlfm_tpu/runner/full_stack.py``. Perception (BLIP2-ITM
scores, OWL-ViT detection with the COCO route and its open-vocabulary
retry, gated MobileSAM masks, with ``cfg.use_vqa`` the BLIP-2 / flan-T5
veto of each detection, and the monocular-depth fallback) feeds the batched
policy step instead of the environment's oracle: the complete system of the
reference, end to end.
With converted checkpoints this is the deployment configuration; with
random weights it runs every seam and measures the stack's throughput.

- ``FullStackPerception.batch``: one batched call per model family for a
  (B, H, W, 3) frame batch.
- ``FullStackPerception.make_fused_step``: the farm's dispatch over its lanes
  (unpack, perception, keys, lane resets and one batched ``step``) behind
  one host-to-device copy of a packed buffer and one (B, 4) read back. On
  the card it replays the lane reset and the step as one CUDA graph
  (``StepGraphs``).
- ``FullStackPerception.__call__``: one frame, with the all-ones-depth
  trigger of monocular depth (ZoeDepth) for the object map.
- ``run_full_stack_episode``: one episode (B = 1) with model perception.

The default SAM is a tiny MobileSAM; ``tiny_sam_config`` is the tiny
ViT-det SAM of JAX's ``tiny_sam_config``, and ``sam=`` takes a SAM with
either encoder (``SamConfig()`` is sam-vit-base's ViT-det).
"""

from __future__ import annotations

import contextlib
import itertools
import time
import weakref
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from vlfm_tpu_torch.config import VLFMConfig
from vlfm_tpu_torch.device import default_device
from vlfm_tpu_torch.mapping.grid import GridSpec2D
from vlfm_tpu_torch.models.blip2_itm import BLIP2ITM, BLIP2ITMConfig
from vlfm_tpu_torch.models.blip2_vqa import BLIP2VQA, BLIP2VQAConfig
from vlfm_tpu_torch.models.coco_detector import CocoDetector
from vlfm_tpu_torch.models.owl_vit import OwlViTDetConfig, OwlViTDetector
from vlfm_tpu_torch.models.sam import SAM, SamConfig, SamDecoderConfig, SamVisionConfig
from vlfm_tpu_torch.models.tokenizer import WordPieceTokenizer, toy_vocab
from vlfm_tpu_torch.ops import threefry
from vlfm_tpu_torch.ops.resize import resize_bilinear_hw
from vlfm_tpu_torch.parallel.detection_pipeline import DetectionPipeline, VQAVeto
from vlfm_tpu_torch.parallel.engine import PerceptionEngine
from vlfm_tpu_torch.policy import itm
from vlfm_tpu_torch.runner import packing
from vlfm_tpu_torch.runner.episode_driver import (
    DriverStats,
    env_result,
    observation,
    pack_outputs,
    read_back,
    step_inputs,
    step_keys,
)
from vlfm_tpu_torch.utils.measurements import TraveledStairs
from vlfm_tpu_torch.utils.profiling import count, span


def tiny_sam_config() -> SamConfig:
    """A tiny ViT-det SAM at 64 px, as JAX's ``tiny_sam_config``."""
    return SamConfig(
        vision=SamVisionConfig(
            image_size=64, patch_size=8, width=32, depth=2, heads=2,
            mlp_dim=128, window_size=2, global_attn_indexes=(1,), out_channels=16,
        ),
        decoder=SamDecoderConfig(
            hidden=16, layers=2, heads=2, mlp_dim=32, iou_head_depth=2, iou_head_hidden=16
        ),
        pe_dim=8,
    )


def _leaves(tree, out: list) -> list:
    """The tensors of a NamedTuple tree, in field order, appended to ``out``."""
    for v in tree:
        if isinstance(v, torch.Tensor):
            out.append(v)
        else:
            _leaves(v, out)
    return out


def write_into(state, new) -> None:
    """Copy each tensor of the state ``new`` into the tensor of ``state`` in
    its place, where they are not the same tensor, so ``state`` holds the new
    state. A new tensor that shares memory with a tensor of ``state`` is
    copied out first, so no write lands on what is still to be read."""
    dsts, srcs = _leaves(state, []), _leaves(new, [])
    held = {d.untyped_storage().data_ptr() for d in dsts}
    pairs = [(d, s.clone() if s.untyped_storage().data_ptr() in held else s)
             for d, s in zip(dsts, srcs) if s is not d]
    for d, s in pairs:
        d.copy_(s)


_streams: dict = {}


def dispatch_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream the fused dispatch and its graphs run on, one per card for
    the process. A capture needs a stream other than the default one, and
    cuBLAS keeps a workspace for each stream it runs on (tens of MiB on
    Hopper): the dispatch's work all on one stream keeps one workspace."""
    stream = _streams.get(device)
    if stream is None:
        stream = _streams[device] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def on_dispatch_stream(device: torch.device):
    """The block on ``dispatch_stream(device)``, ordered after the current
    stream's work and before its next; as it is on a CPU device or on that
    stream already."""
    if device.type != "cuda":
        yield
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    main, side = torch.cuda.current_stream(device), dispatch_stream(device)
    if main == side:
        yield
        return
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        main.wait_stream(side)


class _Graph:
    """One capture: the graph, its static inputs and outputs, and weak
    references to the state's tensors it was captured on."""

    def __init__(self, graph, sig, inputs, outputs, leaves):
        self.graph, self.sig, self.inputs, self.outputs = graph, sig, inputs, outputs
        self.refs = [weakref.ref(t) for t in leaves]

    def alive(self) -> bool:
        return all(r() is not None for r in self.refs)

    def holds(self, sig, leaves) -> bool:
        return sig == self.sig and len(leaves) == len(self.refs) and all(
            r() is t for r, t in zip(self.refs, leaves))


class StepGraphs:
    """``run(state, inputs)`` (the dispatch's lane reset and policy step,
    which writes the new state into ``state`` and returns its outputs) as
    CUDA graphs, one per state and input shapes.

    A CPU state runs ``run`` eagerly (``step.eager``). On the card the
    first call at a set of input shapes and dtypes runs eagerly on
    ``dispatch_stream`` (``step.eager``), which warms its libraries' handles
    there, and captures go on that stream; a later call at those shapes on
    the very state tensors of a live capture copies its inputs into the
    capture's and replays it inside a ``vlfm.step`` span
    (``step.graph_replays``); any other call captures anew on its state and
    replays (``step.graph_captures``). A capture holds
    its state by weak reference only: it is never replayed on other tensors
    or after they died, and it is dropped at the next capture once they
    died, so a dropped state frees its memory; each live state keeps its
    capture.

    Replayed outputs are the capture's buffers, overwritten by the next
    replay. The graph reads the step's weights (PointNav's) where they were
    at capture: a load into them in place is read, a module given new
    tensors needs a new dispatch."""

    def __init__(self, run: Callable):
        self.run = run
        self.graphs: List[_Graph] = []
        self.warm: set = set()

    def __call__(self, state, inputs: Tuple[torch.Tensor, ...]):
        leaves = _leaves(state, [])
        if not leaves[0].is_cuda:
            count("step.eager")
            return self.run(state, inputs)
        sig = tuple((t.shape, t.dtype, t.device) for t in inputs)
        g = next((g for g in self.graphs if g.holds(sig, leaves)), None)
        if g is not None:
            for dst, src in zip(g.inputs, inputs):
                dst.copy_(src)
            with span("vlfm.step"):
                g.graph.replay()
            count("step.graph_replays")
            return g.outputs
        device = leaves[0].device
        if sig not in self.warm:
            with on_dispatch_stream(device):
                outputs = self.run(state, inputs)
            self.warm.add(sig)
            count("step.eager")
            return outputs
        # Drop the captures whose state died before capturing, so their
        # memory is free for this one.
        self.graphs = [g for g in self.graphs if g.alive()]
        # The inputs are copied: the caller may keep the tensors it gave.
        static = tuple(t.clone(memory_format=torch.contiguous_format) for t in inputs)
        graph = torch.cuda.CUDAGraph()
        with on_dispatch_stream(device):
            graph.capture_begin()
            try:
                outputs = self.run(state, static)
            finally:
                graph.capture_end()
        graph.replay()
        self.graphs.append(_Graph(graph, sig, static, outputs, leaves))
        count("step.graph_captures")
        return outputs


class FullStackPerception:
    """(B, H, W, 3) uint8 frames and a target -> (cosines, detection masks,
    validity) through the real model architectures.

    With ``cfg.use_vqa`` the pipeline vetoes detections through
    ``blip2_vqa`` (a ``BLIP2VQA``; tiny random weights if none is given),
    or through a bare T5 ``vqa`` with an explicit ``image_prefix`` callable
    ((N, H, W, 3) uint8 -> (N, P, d_model)). Questions are the stack's
    tokenizer ids modulo T5's vocabulary, and ``yes_token_id`` is the
    answer that keeps a detection. ``monodepth`` (``infer_depth(rgb, min,
    max)``, e.g. ``models/zoedepth.ZoeDepth``) fills in depth for the
    object map where the camera gives none (``__call__``)."""

    def __init__(
        self,
        cfg: VLFMConfig,
        itm: Optional[BLIP2ITM] = None,
        detector: Optional[OwlViTDetector] = None,
        sam: Optional[SAM] = None,
        monodepth=None,
        det_threshold: float = 0.0,
        *,
        vqa=None,
        blip2_vqa: Optional[BLIP2VQA] = None,
        image_prefix: Optional[Callable] = None,
        yes_token_id: int = 42,
        device: torch.device | str = default_device(),
    ):
        if not cfg.use_vqa and (vqa is not None or blip2_vqa is not None or image_prefix is not None):
            raise ValueError("vqa=, blip2_vqa= and image_prefix= need cfg.use_vqa")
        if vqa is not None and (blip2_vqa is not None or image_prefix is None):
            raise ValueError("a bare vqa= takes image_prefix= and no blip2_vqa=")
        if monodepth is not None and not callable(getattr(monodepth, "infer_depth", None)):
            raise ValueError("monodepth= needs an infer_depth(rgb, min_depth, max_depth) method")
        self.cfg = cfg
        self.device = torch.device(device)
        self.itm = itm or BLIP2ITM.init_random(BLIP2ITMConfig.tiny(), seed=0, device=device)
        detector = detector or OwlViTDetector.init_random(OwlViTDetConfig.tiny(), seed=0, device=device)
        # MobileSAM (TinyViT encoder), the reference's vit_t (vlfm/vlm/sam.py:24-57)
        sam = sam or SAM.init_random(SamConfig.tiny_mobile_sam(), seed=0, device=device)
        self.monodepth = monodepth
        self.tokenizer = WordPieceTokenizer(toy_vocab(), max_len=8)
        self.engine = PerceptionEngine(itm=self.itm, tokenizer=self.tokenizer, text_prompt=cfg.text_prompt)

        det_vocab = detector.cfg.text.vocab_size

        def encode_queries(names):
            ids, mask = self.tokenizer.encode_batch(names)
            if det_vocab < 1000:  # toy configs: fold the real ids into the tiny vocabulary
                ids = ids % (det_vocab - 1) + 1
            return ids, mask

        coco = CocoDetector(detector, encode_queries, conf_threshold=cfg.coco_threshold,
                            max_detections=cfg.max_detections_per_frame)
        veto = self.vqa_bridge = None
        if cfg.use_vqa:
            if vqa is None:
                bridge = self.vqa_bridge = blip2_vqa or BLIP2VQA.init_random(BLIP2VQAConfig.tiny(), seed=0,
                                                                            device=device)
                vqa = bridge.t5

                def image_prefix(rgb):
                    return bridge.image_prefix(bridge.preprocess(rgb))

            def encode_question(text):
                ids, mask = self.tokenizer.encode_batch([text])
                return ids[0] % vqa.cfg.vocab_size, mask[0]

            veto = VQAVeto(vqa=vqa, encode_text=encode_question, yes_token_id=yes_token_id,
                           image_prefix=image_prefix, vqa_prompt=cfg.vqa_prompt,
                           slot_capacity=cfg.vqa_slot_capacity)
        self.pipeline = DetectionPipeline(
            detector, sam, encode_queries,
            coco_detector=coco,
            vqa_veto=veto,
            use_vqa=cfg.use_vqa,
            coco_threshold=cfg.coco_threshold,
            non_coco_threshold=det_threshold,
            max_detections=cfg.max_detections_per_frame,
            sam_frame_capacity=cfg.sam_frame_capacity,
        )
        self._fused_cache: dict = {}

    def _perceive(self, rgb: torch.Tensor, target: str, out_hw: Optional[Tuple[int, int]] = None):
        """ITM cosines (all prompt channels), masks and validity of a device
        frame batch, with the models read now (weights loaded after an
        earlier call are the ones served)."""
        with span("vlfm.perceive", frames=rgb.shape[0]):
            cos = self.itm.cosine_cached_text(self.itm.preprocess(rgb), self.engine.text_features(target))
            masks, valid, _ = self.pipeline(rgb, target, out_hw)
            return cos, masks, valid

    def batch(self, rgb_b, target: str):
        """(B, H, W, 3) uint8 (host numpy or a tensor) -> (cosines (B, C),
        masks (B, K, H, W) bool, valid (B, K) bool) on the device, one
        batched call per model family; C is ``cfg.value_channels``."""
        rgb = torch.as_tensor(rgb_b).to(self.device)
        cos, masks, valid = self._perceive(rgb, target)
        return cos[:, : self.cfg.value_channels], masks, valid

    def monocular_depth(self, rgb_b, depth, valid: torch.Tensor) -> Optional[torch.Tensor]:
        """The object map's depth for a (1, H, W, 3) uint8 frame (host numpy
        or a tensor) on the device: (1, H, W)
        inferred by ``monodepth``, normalised to the camera's range, when
        ``depth`` is given and all ones, a monodepth model is set and a
        detection is valid (one host read); else None, and the caller keeps
        ``depth`` (base_objectnav_policy.py:314-318;
        reality_policies.py:156-169)."""
        if depth is None or self.monodepth is None or not np.all(np.asarray(depth) == 1.0):
            return None
        if not bool(valid.any()):
            return None
        cam = self.cfg.camera
        return self.monodepth.infer_depth(torch.as_tensor(rgb_b).to(self.device), cam.min_depth, cam.max_depth)

    def __call__(self, rgb: np.ndarray, target: str, depth: Optional[np.ndarray] = None):
        """One (H, W, 3) frame -> numpy (cosines (C_all,), masks (K, H, W),
        valid (K,), object depth). The object depth is the inferred one
        where ``monocular_depth`` infers it, else ``depth`` itself, the same
        object."""
        rgb_b = torch.as_tensor(rgb).to(self.device)[None]
        cos, masks, valid = self._perceive(rgb_b, target)
        inferred = self.monocular_depth(rgb_b, depth, valid)
        object_depth = depth if inferred is None else inferred[0].cpu().numpy()
        return cos[0].cpu().numpy(), masks[0].cpu().numpy(), valid[0].cpu().numpy(), object_depth

    def make_fused_step(self, pointnav, spec: GridSpec2D, cfg: VLFMConfig, target: str, version: str = "v2",
                        layout: Optional[packing.Layout] = None):
        """The farm's dispatch as one call: unpack, dequantise and
        upsample depth, camera poses, per-lane keys ``fold_in(PRNGKey(seed),
        step)`` computed on the device, ITM cosines from the cached text
        features, the detection pipeline (with the VQA veto under
        ``cfg.use_vqa``), then the lane resets and one batched ``step``.

        Unpacked, the callable is
            (gstate, fresh, reset_mask, depth, heading, xy, rgb, seeds, steps)
            -> (actions, target_detected, goals, gstate')
        with each input copied to the device on its own. With ``layout`` it is
            (gstate, fresh, packed_u8) -> (out (B, 4) f32 [action, detected,
            goal_x, goal_y], gstate')
        where ``packed_u8`` is the (layout.total,) uint8 buffer of
        ``packing.pack_views``: it crosses in one copy (asynchronous from
        pinned host memory; the caller rewrites it only after reading this
        dispatch's ``out``), and ``out`` comes back in one read. The
        unpack is a set of typed views, so both forms compute on the same
        bits. ``fresh`` is JAX's fresh-state argument: ``reset_lanes``
        starts the reset lanes anew, so it may be None. The new state is
        written into ``gstate``'s tensors, and the ``gstate`` returned is
        the one given.

        u16 depth is dequantised with ``* (1/65535)``; depth or RGB at half
        size is brought to the camera grid on the device (depth bilinearly,
        the masks by resampling SAM's output to the camera grid), so
        ``step`` always sees (H, W). The callable is cached per (target,
        version, pointnav, spec, cfg, layout); the perception models are
        read at each call.

        The lane reset, ``step`` and the write into ``gstate`` go through
        ``StepGraphs``: on the card, after a first eager call, a call on the
        state of a live capture at its shapes replays one CUDA graph, which
        holds no host read (the flood and the labelling run as kernels).
        There is no switch: a CPU state runs eagerly. On the card the whole
        call runs on ``dispatch_stream``, ordered after the caller's work
        on its current stream and before its next.

        Each call is a ``vlfm.dispatch`` span whose ``decision`` is the
        callable's call count, with ``vlfm.dispatch.unpack`` (the copy, the
        views, depth brought to the camera grid, the camera poses and the
        keys), ``vlfm.perceive``, ``vlfm.reset_lanes`` and ``vlfm.step``
        (with their children) on an eager or a capturing call, or one
        ``vlfm.step`` around a replay, and, packed, ``vlfm.dispatch.pack``
        inside."""
        key = (target, version, id(pointnav), id(spec), id(cfg), layout)
        if key in self._fused_cache:
            return self._fused_cache[key][0]
        h, w = cfg.camera.height, cfg.camera.width
        device = self.device
        calls = itertools.count()

        def camera_inputs(depth, heading, xy, seeds, steps):
            """The step's observation (depth on the camera grid) and keys."""
            if depth.dtype == torch.uint16:  # u16 transport
                depth = depth.to(torch.float32) * (1.0 / 65535.0)
            if tuple(depth.shape[-2:]) != (h, w):  # half-size transport
                depth = resize_bilinear_hw(depth, h, w)
            return observation(depth, xy, heading, cfg), step_keys(seeds, steps)

        def policy_step(gstate, inputs):
            """Reset the lanes, step every lane, and write the new state into
            ``gstate``: (action, info)."""
            reset, depth, tf, xy, heading, cos, masks, valid, keys = inputs
            with span("vlfm.reset_lanes"):
                state = itm.reset_lanes(gstate, reset)
            action, info, state = itm.step(state, itm.Observation(depth, tf, xy, heading), cos, masks, valid, keys,
                                           pointnav=pointnav, spec=spec, cfg=cfg, version=version)
            write_into(gstate, state)
            return action, info

        graphs = StepGraphs(policy_step)

        def fused(gstate, reset_mask, obs, rgb, keys):
            cos, masks, valid = self._perceive(rgb, target, (h, w))
            return graphs(gstate, (reset_mask, *obs, cos[:, : cfg.value_channels], masks, valid, keys))

        if layout is not None:
            def call(gstate, fresh, packed_u8):
                with span("vlfm.dispatch", decision=next(calls)), on_dispatch_stream(device):
                    with span("vlfm.dispatch.unpack"):
                        f = packing.unpack_device(layout, torch.as_tensor(packed_u8).to(device, non_blocking=True))
                        reset = f["reset"].to(torch.bool)
                        obs, keys = camera_inputs(f["depth"], f["heading"], f["xy"], f["seeds"], f["steps"])
                    action, info = fused(gstate, reset, obs, f["rgb"], keys)
                    with span("vlfm.dispatch.pack"):
                        return pack_outputs(action, info), gstate
        else:
            def call(gstate, fresh, reset_mask, depth, heading, xy, rgb, seeds, steps):
                with span("vlfm.dispatch", decision=next(calls)), on_dispatch_stream(device):
                    with span("vlfm.dispatch.unpack"):
                        reset, depth, heading, xy, rgb, seeds, steps = (
                            torch.as_tensor(x).to(device) for x in (reset_mask, depth, heading, xy, rgb, seeds, steps))
                        obs, keys = camera_inputs(depth, heading, xy, seeds, steps)
                    action, info = fused(gstate, reset.to(torch.bool), obs, rgb, keys)
                    return action.clone(), info.target_detected.clone(), info.goal.clone(), gstate

        # the entry keeps (pointnav, spec, cfg) alive, so their ids stay unique
        self._fused_cache[key] = (call, (pointnav, spec, cfg))
        return call


def run_full_stack_episode(env, spec: GridSpec2D, cfg: VLFMConfig, pointnav="greedy",
                           perception: Optional[FullStackPerception] = None, seed: int = 0,
                           target: str = "toilet", device: torch.device | str = default_device()):
    """``run_episode`` with model perception instead of the environment's
    oracle: per env step one perception call and one ``step`` (B = 1), keys
    ``fold_in(PRNGKey(seed), step)``, so results do not depend on
    scheduling and equal the farm's. ``step`` takes an ``object_depth``
    only where ``monocular_depth`` inferred one. Returns (EpisodeResult,
    DriverStats)."""
    perception = perception or FullStackPerception(cfg, device=device)
    o = env.reset()
    state = itm.create_state(spec, cfg, device=device)
    stats = DriverStats()
    shortest = env.shortest_path_length()
    target_seen = target_detected = False
    stairs = TraveledStairs()
    last_goal = None
    key = threefry.PRNGKey(seed, device=device)
    t0 = time.time()
    while not o["done"]:
        cos, masks, valid = perception.batch(o["rgb"][None], target)
        obj_depth = perception.monocular_depth(o["rgb"][None], o["depth"], valid)
        obs = step_inputs([o], cfg, device)[0]  # depth and pose in one copy
        stairs.update(o.get("agent_z", 0.0))
        keys = threefry.fold_in(key, stats.env_steps)[None]  # step_keys' bits, with no copy
        action, info, state = itm.step(state, obs, cos.to(device), masks.to(device), valid.to(device), keys,
                                       None if obj_depth is None else obj_depth.to(device),
                                       pointnav=pointnav, spec=spec, cfg=cfg)
        back = read_back(action, info)
        target_seen = target_seen or o["target_visible"]
        target_detected = target_detected or bool(back[0, 1])
        last_goal = back[0, 2:]
        o = env.step(int(back[0, 0]))
        stats.env_steps += 1
    stats.wall_time = time.time() - t0
    result = env_result(env, o, shortest, env.cfg.max_steps, detected=target_detected, seen=target_seen,
                        stairs=stairs, last_goal=last_goal, explored=state.obstacle.explored[0], spec=spec)
    return result, stats
