"""The episode farm: sim worker processes feed the card over shared memory.

Counterpart of ``vlfm_tpu/runner/sim_farm.py``. It replaces the reference's
concurrency stack (habitat VectorEnv pickle pipes, per-request JPEG-base64
HTTP with lockfiles; vlfm/vlm/server_wrapper.py:57-164,
vlfm/utils/vlfm_trainer.py:99-105) with a host pipeline for one driver
process on the card:

- W worker processes each own a span of episode lanes. They run the numpy
  environment, copy fixed-layout observation records into a POSIX
  shared-memory ring (``runner/obsring.py``) and poll a second ring for the
  actions addressed to their lanes. Workers are spawned, import neither
  torch nor anything that touches CUDA, and start with
  ``CUDA_VISIBLE_DEVICES=""``.
- The driver drains whole observation batches, runs one fused dispatch
  over all lanes (``runner/packing.py``: one packed host-to-device copy
  from pinned memory, one (B, 4) read back) and pushes small action
  records back.
- All lanes form ONE group with one device state (one per data row of
  the mesh under ``sharding=``, ``parallel/mesh.py``). JAX splits them into two
  groups dispatched ping-pong, since its dispatch returns at once; the
  port's dispatch blocks the host (the step's sweep loops and gated SAM
  read back), so a second group would only halve the batch and double the
  dispatches. The workers still step their simulators in parallel.

Per-(episode seed, step) keys and per-lane resets make every episode's
result equal the synchronous drivers' (``run_episodes_recycled`` for the
oracle farm, ``run_full_stack_episode`` with ``perception``). The failure
taxonomy is the drivers': ``agent_z`` crosses the ring for TraveledStairs,
and the result record carries the target's pose, radius and feasibility so
the driver reads the map-based 'seen' test from the lanes' explored map
on the card and tests the last goal for a false positive.

Records carry f32 depth by default, so device inputs are bit-identical to
the in-process drivers'. ``depth_u16`` ships depth as u16 (dequantised on
the card), ``depth_half`` and ``rgb_half`` ship 2x2 box averages
(upsampled back to the camera grid on the card): opt-in compressions for
thin host links.
"""

from __future__ import annotations

import copy
import itertools
import multiprocessing as mp
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from vlfm_tpu_torch.runner import fake_env as FE
from vlfm_tpu_torch.runner.obsring import ObservationRing

STALL_S = 120.0  # no progress for this long raises


def _avg2x2_u8(img: np.ndarray) -> np.ndarray:
    """2x2 box average of (H, W, 3) uint8, rounded half up (cv2.INTER_AREA's
    result, bit for bit)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    return ((img.astype(np.uint16).reshape(h2, 2, w2, 2, 3).sum(axis=(1, 3)) + 2) >> 2).astype(np.uint8)


def _avg2x2_f32(d: np.ndarray) -> np.ndarray:
    """Exact 2x2 mean of (H, W) float32 (cv2.INTER_AREA's result)."""
    h2, w2 = d.shape[0] // 2, d.shape[1] // 2
    return d.reshape(h2, 2, w2, 2).mean(axis=(1, 3), dtype=np.float32)


# record kinds (worker -> driver ring)
KIND_OBS = 0
KIND_RESULT = 1

# lane kind seed step flags heading x y dist cosine agent_z
_OBS_HEAD = struct.Struct("<IIIIIffffff")
_ACT_REC = struct.Struct("<IIIi")  # lane seed step action
# lane kind seed called_stop collisions steps seen dist shortest path_len
# target_x target_y target_radius feasible
_RES_REC = struct.Struct("<IIIIIIIffffffI")

FLAG_DONE = 1
FLAG_TARGET_VISIBLE = 2


def obs_slot_bytes(height: int, width: int, rgb: bool = False, depth_u16: bool = False,
                   rgb_half: bool = False, depth_half: bool = False) -> int:
    dpx = (height // 2) * (width // 2) if depth_half else height * width
    base = _OBS_HEAD.size + (2 if depth_u16 else 4) * dpx
    base += (height * width + 7) // 8
    px = (height // 2) * (width // 2) if rgb_half else height * width
    return base + (3 * px if rgb else 0)


def pack_obs(lane: int, seed: int, step: int, o: dict, rgb: bool = False, depth_u16: bool = False,
             rgb_half: bool = False, depth_half: bool = False) -> bytes:
    """One observation record: the header, depth (f32 or u16, full or half
    size), the target mask as packed bits, and with ``rgb`` the frame (full
    or half size)."""
    flags = (FLAG_DONE if o["done"] else 0) | (FLAG_TARGET_VISIBLE if o["target_visible"] else 0)
    head = _OBS_HEAD.pack(
        lane, KIND_OBS, seed, step, flags,
        float(o["heading"]), float(o["robot_xy"][0]), float(o["robot_xy"][1]),
        float(o["distance_to_goal"]), float(o["cosine"]), float(o.get("agent_z", 0.0)),
    )
    d = np.asarray(o["depth"], np.float32)
    if depth_half:
        d = _avg2x2_f32(d)
    if depth_u16:  # normalised [0, 1] depth, 1.5e-5 steps
        depth = (np.clip(d, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16).tobytes()
    else:
        depth = np.ascontiguousarray(d, np.float32).tobytes()
    mask = np.packbits(np.asarray(o["target_mask"], bool)).tobytes()
    if rgb:
        img = np.asarray(o["rgb"], np.uint8)
        if rgb_half:
            img = _avg2x2_u8(img)
        return head + depth + mask + np.ascontiguousarray(img).tobytes()
    return head + depth + mask


def unpack_obs(payload: bytes, height: int, width: int, rgb: bool = False, mask: bool = True,
               depth_u16: bool = False, rgb_half: bool = False, depth_half: bool = False) -> dict:
    """A record back into an observation dict; u16 or half-size depth comes
    back as it crossed. ``mask=False`` skips unpacking the target mask,
    which the model-perception farm never reads."""
    (lane, kind, seed, step, flags, heading, x, y, dist, cosine, agent_z) = _OBS_HEAD.unpack_from(payload, 0)
    if kind != KIND_OBS:
        raise ValueError(f"not an observation record (kind {kind})")
    off = _OBS_HEAD.size
    dh, dw = (height // 2, width // 2) if depth_half else (height, width)
    if depth_u16:
        depth = np.frombuffer(payload, np.uint16, dh * dw, off).reshape(dh, dw)
        off += 2 * dh * dw
    else:
        depth = np.frombuffer(payload, np.float32, dh * dw, off).reshape(dh, dw)
        off += 4 * dh * dw
    nbits = (height * width + 7) // 8
    target_mask = None
    if mask:
        bits = np.unpackbits(np.frombuffer(payload, np.uint8, nbits, off))
        target_mask = bits[: height * width].reshape(height, width).astype(bool)
    rgb_img = None
    if rgb:
        rh, rw = (height // 2, width // 2) if rgb_half else (height, width)
        rgb_img = np.frombuffer(payload, np.uint8, 3 * rh * rw, off + nbits).reshape(rh, rw, 3)
    return {
        "rgb": rgb_img,
        "lane": lane,
        "seed": seed,
        "step": step,
        "done": bool(flags & FLAG_DONE),
        "target_visible": bool(flags & FLAG_TARGET_VISIBLE),
        "heading": heading,
        "robot_xy": np.array([x, y], np.float32),
        "distance_to_goal": dist,
        "cosine": cosine,
        "agent_z": agent_z,
        "depth": depth,
        "target_mask": target_mask,
    }


def pack_result(lane: int, seed: int, env, seen: bool, dist: float, shortest: float) -> bytes:
    tx, ty = getattr(env.plan, "target", (0.0, 0.0))
    return _RES_REC.pack(
        lane, KIND_RESULT, seed, int(env.called_stop), int(env.collisions),
        int(env.steps), int(seen), float(dist), float(shortest), float(env.path_length),
        float(tx), float(ty), float(getattr(env.plan, "target_radius", 0.0)),
        int(getattr(env, "path_feasible", True)),
    )


def record_kind(payload: bytes) -> int:
    return struct.unpack_from("<I", payload, 4)[0]


def worker_main(obs_name: str, act_name: str, lane_ids: Sequence[int], seed_queue: Sequence[int],
                plan_name: str, env_cfg: "FE.EnvConfig", max_steps: int, want_rgb: bool = False,
                depth_u16: bool = False, rgb_half: bool = False, depth_half: bool = False) -> None:
    """A sim worker process: owns ``lane_ids`` and drains its own seed queue.

    numpy only: it never imports torch. The plan factory is named, so the
    arguments pickle under the ``spawn`` start method."""
    plan_fn = getattr(FE, plan_name)
    obs_ring = ObservationRing.open(obs_name)
    act_ring = ObservationRing.open(act_name)
    pack_kw = dict(rgb=want_rgb, depth_u16=depth_u16, rgb_half=rgb_half, depth_half=depth_half)

    queue = list(seed_queue)
    envs: Dict[int, FE.FakeObjectNavEnv] = {}
    seeds: Dict[int, int] = {}
    steps: Dict[int, int] = {}
    seen: Dict[int, bool] = {}
    shortest: Dict[int, float] = {}
    active = set()

    def start_episode(lane: int) -> None:
        s = queue.pop(0)
        envs[lane] = FE.FakeObjectNavEnv(plan_fn(seed=s), env_cfg)
        seeds[lane], steps[lane] = s, 0
        shortest[lane] = envs[lane].shortest_path_length()
        o = envs[lane].reset()
        seen[lane] = bool(o["target_visible"])
        obs_ring.push(pack_obs(lane, s, 0, o, **pack_kw))
        active.add(lane)

    for lane in lane_ids:
        if queue:
            start_episode(lane)

    while active:
        got = act_ring.poll_batch(max_records=64)
        if not got:
            time.sleep(0.002)  # leave the CPU to the driver
            continue
        for _, payload in got:
            lane, seed, step, action = _ACT_REC.unpack(payload)
            if lane not in active or seed != seeds[lane] or step != steps[lane]:
                continue  # another worker's lane, or a stale (pre-recycle) record
            env = envs[lane]
            o = env.step(int(action))
            steps[lane] += 1
            if o["done"] or steps[lane] >= max_steps:
                obs_ring.push(pack_result(lane, seed, env, seen[lane], o["distance_to_goal"], shortest[lane]))
                active.discard(lane)
                if queue:
                    start_episode(lane)
            else:
                seen[lane] = seen[lane] or bool(o["target_visible"])
                obs_ring.push(pack_obs(lane, seed, steps[lane], o, **pack_kw))


@dataclass
class FarmStats:
    env_steps: int = 0
    wall_time: float = 0.0
    dispatches: int = 0
    # the driver's wall time by phase (seconds)
    t_drain: float = 0.0  # ring polling and record unpacking
    t_dispatch: float = 0.0  # filling the buffer, the copy, perception and the step
    t_sync: float = 0.0  # reading the outputs back and pushing actions
    t_idle: float = 0.0  # waiting for the workers' observations
    # bytes copied host-to-device and the host time those copies took
    bytes_put: int = 0
    t_put: float = 0.0

    @property
    def steps_per_sec(self) -> float:
        return self.env_steps / self.wall_time if self.wall_time else 0.0


@dataclass
class _Lane:
    seed: int = -1
    step: int = -1
    pending: Optional[dict] = None
    detected: bool = False
    needs_reset: bool = False
    active: bool = True
    last: Optional[dict] = None  # the last observation sent (an idle lane's filler)
    hist: dict = field(default_factory=dict)
    stairs: object = None  # TraveledStairs, one per episode
    last_goal: Optional[np.ndarray] = None
    # a finished episode's taxonomy state, by seed: its result record may
    # be drained together with the lane's next episode's first observation
    closed: dict = field(default_factory=dict)


_farm_ids = itertools.count()


def run_episodes_farm(
    episode_seeds: Sequence[int],
    lanes: int,
    pointnav,
    spec,
    cfg,
    *,
    plan_name: str = "two_room_plan",
    env_cfg: Optional["FE.EnvConfig"] = None,
    workers: int = 2,
    version: str = "v2",
    max_steps: Optional[int] = None,
    ring_prefix: Optional[str] = None,
    perception=None,
    target: str = "toilet",
    depth_u16: bool = False,
    rgb_half: bool = False,
    depth_half: bool = False,
    sharding=None,
    device=None,
):
    """Drive ``lanes`` episode lanes fed by ``workers`` sim processes.

    Without ``perception`` each lane is scored by the environment's oracle
    (its cosine, and its target mask as detection 0, crossing as packed bits
    and unpacked on the device, big-endian as ``np.packbits``). With
    ``perception`` (a ``FullStackPerception``) RGB frames cross the ring and
    each dispatch runs ``perception.make_fused_step``: BLIP2-ITM, OWL-ViT
    with the COCO route and gated MobileSAM on the lanes' frames, then the
    step. A dispatch's inputs cross in one copy of one uint8 buffer and its
    outputs come back in one (B, 4) read. ``device`` defaults to
    ``perception``'s, else the card. The rings are named
    ``{ring_prefix}_obs`` and ``{ring_prefix}_act`` in ``/dev/shm``; the
    default prefix is unique to this process and call.

    With ``sharding`` (``parallel.mesh.episode_sharding(mesh)``) the lanes
    split into one contiguous block per data row of the mesh, each with its
    own state on the row's lead device, at any model axis (JAX's farm
    splits its lanes over the data axis alone), and a dispatch runs block
    by block: each block's inputs cross to its device on their own (the
    packed transport is off, as in JAX) and its (B / n, 4) outputs come
    back in one read. A ``PointNavPolicy`` is copied whole to each lead
    device, as JAX's farm places it whole; ``perception`` must live on
    every lead device of the mesh (one card, or the CPU). Lanes split as
    episodes do, so the results equal the unsharded farm's. ``device`` is
    then the mesh's.

    Returns ({seed: EpisodeResult}, FarmStats)."""
    import torch

    from vlfm_tpu_torch.device import default_device
    from vlfm_tpu_torch.models.pointnav import PointNavPolicy
    from vlfm_tpu_torch.ops.resize import resize_bilinear_hw
    from vlfm_tpu_torch.parallel import mesh as mesh_lib
    from vlfm_tpu_torch.policy import itm
    from vlfm_tpu_torch.runner import packing
    from vlfm_tpu_torch.runner.episode_driver import episode_result, observation, pack_outputs, step_keys
    from vlfm_tpu_torch.utils.measurements import TraveledStairs

    if lanes > len(episode_seeds):
        raise ValueError("need at least one episode per lane")
    env_cfg = env_cfg or FE.EnvConfig()
    limit = max_steps or env_cfg.max_steps
    h, w = env_cfg.height, env_cfg.width
    if (rgb_half or depth_half) and (h % 2 or w % 2):
        raise ValueError("half-size transport needs even frame sizes")
    if sharding is not None:
        if not isinstance(sharding, mesh_lib.Sharding) or sharding.spec != ("data",):
            raise TypeError("sharding= takes parallel.mesh.episode_sharding(mesh)")
        devices = sharding.data_devices()
        if lanes % len(devices):
            raise ValueError(f"{lanes} lanes do not split over {len(devices)} data devices")
        if perception is not None and any(d != perception.device for d in devices):
            raise ValueError(f"perception on {perception.device} cannot serve a mesh over {devices}")
    else:
        if device is None:
            device = perception.device if perception is not None else default_device()
        devices = [torch.device(device)]
    device = devices[0]
    per = lanes // len(devices)
    blocks = [(d, i * per, (i + 1) * per) for i, d in enumerate(devices)]  # (device, first lane, end)
    if isinstance(pointnav, PointNavPolicy) and sharding is not None:
        block_pointnav = [PointNavPolicy(copy.deepcopy(pointnav.module).to(d)) for d in devices]
    else:
        block_pointnav = [pointnav] * len(devices)
    ring_prefix = ring_prefix or f"vlfm_farm{os.getpid()}_{next(_farm_ids)}"
    k = cfg.max_detections_per_frame
    want_rgb = perception is not None
    dh, dw = (h // 2, w // 2) if depth_half else (h, w)
    rh, rw = (h // 2, w // 2) if rgb_half else (h, w)

    specs = [("depth", "uint16" if depth_u16 else "float32", (lanes, dh, dw))]
    if want_rgb:
        specs += [("rgb", "uint8", (lanes, rh, rw, 3))]
    else:
        specs += [("cos", "float32", (lanes, cfg.value_channels)),
                  ("bits", "uint8", (lanes, (h * w + 7) // 8)),
                  ("valid0", "uint8", (lanes,))]
    specs += [("heading", "float32", (lanes,)), ("xy", "float32", (lanes, 2)), ("seeds", "int32", (lanes,)),
              ("steps", "int32", (lanes,)), ("reset", "uint8", (lanes,))]
    layout = packing.build_layout(specs)
    # One pinned buffer, rewritten only after the previous dispatch was read
    # back, so the asynchronous copy never races the refill.
    hbuf = torch.empty(layout.total, dtype=torch.uint8, pin_memory=device.type == "cuda")
    views = packing.pack_views(hbuf.numpy(), layout)

    if perception is not None:
        fused = perception.make_fused_step(pointnav, spec, cfg, target, version=version,
                                           layout=None if sharding is not None else layout)

    def oracle_fused(state, f, pointnav):
        """The oracle dispatch of one block of lanes: the environments'
        cosines, and their target masks as detection 0."""
        depth = f["depth"]
        n, dev = depth.shape[0], depth.device
        if depth.dtype == torch.uint16:
            depth = depth.to(torch.float32) * (1.0 / 65535.0)
        if tuple(depth.shape[-2:]) != (h, w):
            depth = resize_bilinear_hw(depth, h, w)
        state = itm.reset_lanes(state, f["reset"].to(torch.bool))
        shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)  # np.packbits' big-endian order
        m0 = ((f["bits"][:, :, None] >> shifts) & 1).to(torch.bool).reshape(n, -1)[:, : h * w]
        masks = torch.zeros((n, k, h, w), dtype=torch.bool, device=dev)
        masks[:, 0] = m0.reshape(n, h, w)
        valid = torch.zeros((n, k), dtype=torch.bool, device=dev)
        valid[:, 0] = f["valid0"].to(torch.bool)
        action, info, state = itm.step(state, observation(depth, f["xy"], f["heading"], cfg), f["cos"], masks, valid,
                                       step_keys(f["seeds"], f["steps"]), pointnav=pointnav, spec=spec, cfg=cfg,
                                       version=version)
        return pack_outputs(action, info), state

    obs_ring = ObservationRing.create(
        f"{ring_prefix}_obs",
        slot_bytes=obs_slot_bytes(h, w, rgb=want_rgb, depth_u16=depth_u16, rgb_half=rgb_half,
                                  depth_half=depth_half),
        n_slots=4 * lanes + 16,
    )
    act_ring = ObservationRing.create(f"{ring_prefix}_act", slot_bytes=_ACT_REC.size, n_slots=64 * lanes + 64)

    # Each worker owns a contiguous span of lanes. The first ``lanes`` seeds
    # go lane by lane (so every worker fills its lanes), the rest round-robin
    # over the workers that own lanes.
    lane_spans = np.array_split(np.arange(lanes), workers)
    lane_owner = np.concatenate([np.full(len(span), wi) for wi, span in enumerate(lane_spans)])
    seed_splits: List[List[int]] = [[] for _ in range(workers)]
    seeds_list = list(episode_seeds)
    for lane in range(lanes):
        seed_splits[int(lane_owner[lane])].append(seeds_list[lane])
    owning = [wi for wi in range(workers) if len(lane_spans[wi]) > 0]
    for i, s in enumerate(seeds_list[lanes:]):
        seed_splits[owning[i % len(owning)]].append(s)

    # Workers are numpy-only and must never open the card: a spawned child
    # inherits os.environ at start(), so hide the cards for the spawn window.
    ctx = mp.get_context("spawn")
    procs = []
    prev_visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        for wi in owning:
            p = ctx.Process(
                target=worker_main,
                args=(f"{ring_prefix}_obs", f"{ring_prefix}_act", [int(x) for x in lane_spans[wi]],
                      seed_splits[wi], plan_name, env_cfg, limit, want_rgb, depth_u16, rgb_half, depth_half),
                daemon=True,
            )
            p.start()
            procs.append(p)
    finally:
        if prev_visible is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = prev_visible

    states = [itm.create_state(spec, cfg, batch=hi - lo, device=d) for d, lo, hi in blocks]
    lane_info = [_Lane(stairs=TraveledStairs()) for _ in range(lanes)]
    results = {}
    expected = len(episode_seeds)
    pending_results: List[dict] = []
    stats = FarmStats()
    t0 = time.time()

    def drain() -> None:
        for _, payload in obs_ring.poll_batch(max_records=2 * lanes):
            if record_kind(payload) == KIND_RESULT:
                (lane, _, seed, called_stop, collisions, steps, seen, dist, shortest, path_len, tx, ty,
                 t_radius, feasible) = _RES_REC.unpack(payload)
                pending_results.append(dict(
                    lane=lane, seed=seed, called_stop=bool(called_stop), collisions=collisions, steps=steps,
                    seen=bool(seen), dist=dist, shortest=shortest, path_len=path_len,
                    target=np.array([tx, ty], np.float32), target_radius=t_radius, feasible=bool(feasible),
                ))
            else:
                o = unpack_obs(payload, h, w, rgb=want_rgb, mask=perception is None, depth_u16=depth_u16,
                               rgb_half=rgb_half, depth_half=depth_half)
                li = lane_info[o["lane"]]
                if o["seed"] != li.seed:  # recycled: a new episode on this lane
                    li.closed[li.seed] = (li.stairs, li.last_goal)
                    li.seed, li.needs_reset, li.detected = o["seed"], True, False
                    li.stairs, li.last_goal = TraveledStairs(), None
                li.step = o["step"]
                li.pending = o
                li.active = True  # a late recycled observation revives the lane

    def finalize() -> None:
        # A worker sends its result only after the action of the episode's
        # last dispatch, which was read back before that action was pushed;
        # the state still holds the finished episode's maps, since a lane is
        # reset at its next dispatch and this runs before dispatching.
        while pending_results:
            r = pending_results.pop(0)
            li = lane_info[r["lane"]]
            stairs, last_goal = li.closed.pop(r["seed"], (li.stairs, li.last_goal))
            results[r["seed"]] = episode_result(
                called_stop=r["called_stop"], distance_to_goal=r["dist"], success_radius=env_cfg.success_radius,
                shortest_path=r["shortest"], path_length=r["path_len"], steps=r["steps"], max_steps=limit,
                collisions=r["collisions"], feasible=r["feasible"], target=r["target"],
                target_radius=r["target_radius"], detected=li.hist.get(r["seed"], False), seen=r["seen"],
                stairs=stairs, last_goal=last_goal, explored=states[r["lane"] // per].obstacle.explored[r["lane"] % per],
                spec=spec)

    def can_dispatch() -> bool:
        live = [li for li in lane_info if li.active]
        return bool(live) and all(li.pending is not None for li in live)

    def dispatch():
        """Fill the pinned buffer, copy it up in one piece and run the fused
        dispatch (under ``sharding``, each block's fields to its device and
        one dispatch per block); returns (the outputs of each block, meta)."""
        views["seeds"][:] = 0
        views["steps"][:] = 0
        if not want_rgb:
            views["cos"][:] = 0.0
            views["bits"][:] = 0
            views["valid0"][:] = 0
        meta = []
        for lane, li in enumerate(lane_info):
            o = li.pending if li.pending is not None else li.last
            if li.pending is not None:
                li.stairs.update(o.get("agent_z", 0.0))
                views["seeds"][lane], views["steps"][lane] = li.seed, li.step
            views["depth"][lane] = o["depth"]
            views["heading"][lane], views["xy"][lane] = o["heading"], o["robot_xy"]
            if want_rgb:
                views["rgb"][lane] = o["rgb"]
            else:
                views["cos"][lane] = o["cosine"]
                if o["target_visible"]:
                    views["bits"][lane] = np.packbits(o["target_mask"])
                    views["valid0"][lane] = 1
            views["reset"][lane] = li.needs_reset
            meta.append((lane, li.seed, li.step, li.pending is not None))
            li.last = o
            li.needs_reset = False
            li.pending = None
        outs = []
        if sharding is None:
            t = time.time()
            buf = hbuf.to(device, non_blocking=True)  # the dispatch's one host-to-device copy
            stats.t_put += time.time() - t
            stats.bytes_put += layout.total
            if want_rgb:
                out, states[0] = fused(states[0], None, buf)
            else:
                out, states[0] = oracle_fused(states[0], packing.unpack_device(layout, buf), pointnav)
            outs.append(out)
        for b, (dev, lo, hi) in enumerate(blocks if sharding is not None else ()):
            t = time.time()
            f = {name: torch.from_numpy(v[lo:hi]).to(dev) for name, v in views.items()}
            stats.t_put += time.time() - t
            stats.bytes_put += sum(v[lo:hi].nbytes for v in views.values())
            if want_rgb:
                action, detected, goal, states[b] = fused(states[b], None, f["reset"], f["depth"], f["heading"],
                                                          f["xy"], f["rgb"], f["seeds"], f["steps"])
                out = torch.cat([action[:, None].to(torch.float32), detected[:, None].to(torch.float32), goal], 1)
            else:
                out, states[b] = oracle_fused(states[b], f, block_pointnav[b])
            outs.append(out)
        stats.dispatches += 1
        return outs, meta

    def sync(outs, meta) -> None:
        out_np = np.concatenate([out.cpu().numpy() for out in outs])
        actions_np, detected_np, goals_np = out_np[:, 0].astype(np.int32), out_np[:, 1] > 0.5, out_np[:, 2:4]
        for lane, seed, step, live in meta:
            if not live:
                continue
            li = lane_info[lane]
            li.detected = li.detected or bool(detected_np[lane])
            li.hist[seed] = li.detected
            if seed == li.seed:  # not a stale pre-recycle read
                li.last_goal = goals_np[lane]
            act_ring.push(_ACT_REC.pack(lane, seed, step, int(actions_np[lane])))
            stats.env_steps += 1

    try:
        idle_since = time.time()
        while len(results) < expected:
            t_a = time.time()
            drain()
            finalize()
            stats.t_drain += time.time() - t_a
            if can_dispatch():
                t_a = time.time()
                out, meta = dispatch()
                t_b = time.time()
                sync(out, meta)
                stats.t_dispatch += t_b - t_a
                stats.t_sync += time.time() - t_b
                idle_since = time.time()
                continue
            stats.t_idle += 0.002
            # a lane whose worker has no episode left goes idle once its
            # result is in and no new observation follows
            for li in lane_info:
                if li.active and li.pending is None and li.seed in results:
                    li.active = False
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"a sim worker exited with code {dead[0]}")
            time.sleep(0.002)
            if time.time() - idle_since > STALL_S:
                raise RuntimeError(f"sim farm stalled: {len(results)}/{expected} episodes, lanes pending "
                                   f"{[li.pending is not None for li in lane_info]}, active "
                                   f"{[li.active for li in lane_info]}")
        stats.wall_time = time.time() - t0
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.terminate()
                p.join()
        obs_ring.close()
        act_ring.close()
    return results, stats
