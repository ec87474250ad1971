"""Time the one-robot spin's map half of an earlier tree beside this tree's, on one card.

    python3 scripts/ab_spin_maps.py PARENT_DIR

PARENT_DIR holds a checkout of the earlier commit (``git archive a7a3d3e``:
one-episode ``(S, S)`` maps whose window helpers read the centre on the
host). The script runs itself once per turn as ``--tree DIR``, in the
order earlier, this tree, this tree, earlier; each run imports
``vlfm_tpu_torch`` from its own tree alone (so it keeps its own timing
helpers: ``chip_smoke.py`` imports this tree's package). A run takes ``chip_smoke.py``
phase 8's inputs (the 12-view spin of ``two_room_plan(seed=0)`` at 640x480,
the default ``VLFMConfig`` maps) with fixed cosines in place of ITM's, and
times on the card, at one lane (B = 1 in this tree's batch-first API):

- the 12 obstacle-map updates and 12 fusions, then the decision;
- the 12 obstacle-map updates alone; the 12 fusions alone;
- at the last view, one obstacle-map update and one fusion: kernel
  launches (torch.profiler's device events other than copies and sets) and
  host synchronisations (``torch.cuda.set_sync_debug_mode("warn")``).

Wall times are medians of 5 calls, each ended by a device synchronise. It
prints one JSON line per turn, the card's name and power limit, and last a
JSON object: tree -> each measurement, times the mean of the tree's two
turns. Needs one card.
"""

from __future__ import annotations

import inspect
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
VIEWS = 12


def wall_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launches(fn) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sum(not e.name.startswith(("Memcpy", "Memset")) for e in dev)


def host_syncs(fn) -> int:
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def run_tree(tree: Path) -> dict:
    """The measurements of one turn, with ``tree``'s vlfm_tpu_torch."""
    sys.path.insert(0, str(tree))
    from vlfm_tpu_torch.config import VLFMConfig
    from vlfm_tpu_torch.mapping import obstacle_map as OM
    from vlfm_tpu_torch.mapping import value_map as VM
    from vlfm_tpu_torch.mapping.grid import GridSpec2D
    from vlfm_tpu_torch.policy import acyclic as AC
    from vlfm_tpu_torch.policy.itm import TURN_LEFT, decide, fuse_view, update_obstacles
    from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, two_room_plan
    from vlfm_tpu_torch.utils.geometry import xyz_yaw_to_tf_matrix

    dev = torch.device("cuda")
    batched = "batch" in inspect.signature(OM.create).parameters
    lane = (lambda t: t[None]) if batched else (lambda t: t)  # one lane of the batch-first API
    cfg = VLFMConfig()
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)
    env = FakeObjectNavEnv(two_room_plan(seed=0), EnvConfig(width=640, height=480))
    views = [env.reset()] + [env.step(TURN_LEFT) for _ in range(VIEWS - 1)]
    inputs = []
    for o in views:
        xyz = torch.tensor([*o["robot_xy"], cfg.camera.camera_height], dtype=torch.float32, device=dev)
        tf = xyz_yaw_to_tf_matrix(xyz, torch.tensor(o["heading"], dtype=torch.float32, device=dev))
        inputs.append((lane(tf), lane(torch.from_numpy(o["depth"].astype(np.float32)).to(dev))))
    cosines = torch.from_numpy(np.random.default_rng(0).uniform(0.05, 0.3, (VIEWS, cfg.value_channels))
                               .astype(np.float32)).to(dev)
    last = views[-1]

    def create_obstacle():
        return OM.create(spec, cfg.max_frontiers, device=dev, **({"batch": 1} if batched else {}))

    def create_value():
        return VM.create(spec, cfg.value_channels, device=dev, **({"batch": 1} if batched else {}))

    def obstacles():
        state = create_obstacle()
        for steps, (tf, depth) in enumerate(inputs):
            state = update_obstacles(state, spec, cfg, depth, tf, steps)
        return state

    final = obstacles()

    def fusions():
        state = create_value()
        for (tf, depth), cos in zip(inputs, cosines):
            fuse_view(state, spec, cfg, lane(cos), depth, tf, final.explored)
        return state

    def maps():
        obstacle, value = create_obstacle(), create_value()
        for steps, ((tf, depth), cos) in enumerate(zip(inputs, cosines)):
            obstacle = update_obstacles(obstacle, spec, cfg, depth, tf, steps)
            fuse_view(value, spec, cfg, lane(cos), depth, tf, obstacle.explored)
        return decide(
            value, spec, obstacle,
            lane(torch.tensor(last["robot_xy"], dtype=torch.float32, device=dev)),
            lane(torch.tensor(last["heading"], dtype=torch.float32, device=dev)),
            lane(torch.zeros(2, device=dev)), lane(torch.full((), -math.inf, device=dev)),
            AC.create(device=dev, **({"batch": 1} if batched else {})),
        )

    tf, depth = inputs[-1]
    before, value = obstacles(), fusions()

    def one_update():
        update_obstacles(before, spec, cfg, depth, tf, VIEWS - 1)

    def one_fusion():
        fuse_view(value, spec, cfg, lane(cosines[-1]), depth, tf, final.explored)

    dec = maps()
    assert int(dec.action.reshape(-1)[0]) in (0, 1, 2, 3)
    return {
        "tree": str(tree),
        "batch_first": batched,
        "maps_ms": wall_ms(maps),
        "obstacle_ms": wall_ms(obstacles),
        "fusion_ms": wall_ms(fusions),
        "update_launches": launches(one_update),
        "fusion_launches": launches(one_fusion),
        "update_syncs": host_syncs(one_update),
        "fusion_syncs": host_syncs(one_fusion),
    }


def main() -> None:
    if sys.argv[1] == "--tree":
        print(json.dumps(run_tree(Path(sys.argv[2]).resolve())), flush=True)
        return
    parent = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    turns = {str(parent): [], str(REPO): []}
    for tree in (parent, REPO, REPO, parent):
        out = subprocess.run([sys.executable, __file__, "--tree", str(tree)], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
        print(out, flush=True)
        turns[str(tree)].append(json.loads(out))
    print(smi, flush=True)
    keys = [k for k, v in turns[str(REPO)][0].items() if isinstance(v, (int, float)) and not isinstance(v, bool)]
    print(json.dumps({tree: {k: statistics.mean(t[k] for t in runs) for k in keys} for tree, runs in turns.items()}),
          flush=True)


if __name__ == "__main__":
    main()
