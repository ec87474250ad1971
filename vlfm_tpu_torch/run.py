"""Main entry point: ``python -m vlfm_tpu_torch.run [--config cfg.yaml] ...``.

Counterpart of ``vlfm_tpu/run.py`` (reference: vlfm/run.py, the hydra
entry), with its flags and its printed lines and JSON. Configuration is
plain dataclasses and YAML (``vlfm_tpu_torch.config.load_config``). It
runs on the card, or on the CPU with ``--cpu``. Backends:

- ``--backend synthetic`` (default): the built-in FakeObjectNavEnv, one
  episode at a time through ``runner/episode_driver.run_episode``, or
  ``--farm LANES`` lanes fed by sim worker processes
  (``runner/sim_farm.py``).
- ``--backend habitat``: needs habitat-lab; builds a habitat env and
  drives it through ``HabitatVLFMAgent`` over ``FullStackPerception``
  (the ``--weights-dir`` bundle's models, else tiny random ones) in
  ``runner/habitat_eval.evaluate``.
- ``--backend reality``: needs the Spot SDK, so it exits with a message, as
  JAX's does: the robot path is ``reality/envs.ObjectNavEnv`` over a
  ``BDSWRobot`` (``FakeRobot`` for dry runs) driven by
  ``policy/reality.RealityITMPolicyV2``.

``--pointnav-weights`` loads the reference's PointNav checkpoint (a
``.pth`` with the upstream parameter names) as it is. ``--weights-dir``
serves a bundle written by ``python -m vlfm_tpu_torch.convert_checkpoints``
(``runner/weights.py``) in the habitat backend and in the synthetic
backend's ``--farm``: the full stack over the streamed frames. The JAX
package's orbax bundles are refused with a message. ``--trace-dir DIR``
keeps the program's spans and counters for the whole run
(``utils/profiling.tracing``) and writes them to ``DIR/spans.json`` at its
end, a Chrome trace for Perfetto.
"""

from __future__ import annotations

import argparse
import json
import os


def load_pointnav_weights(path: str, depth_shape, device):
    """The reference's PointNav checkpoint as a discrete ``PointNavPolicy``.
    As the reference's loader does (pointnav_policy.py's non-habitat
    branch), a ``state_dict`` wrapper is unwrapped and keys the network
    does not have (its critic) are dropped; every key it has must be there."""
    import torch

    from vlfm_tpu_torch.models.pointnav import PointNavModule, PointNavPolicy

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    wanted = PointNavModule(depth_shape, discrete=True).state_dict().keys()
    return PointNavPolicy.from_reference_state_dict({k: v for k, v in sd.items() if k in wanted}, depth_shape,
                                                    device=device)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=None, help="YAML/JSON VLFMConfig file")
    p.add_argument("--backend", choices=["synthetic", "habitat", "reality"], default="synthetic")
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--max-steps", type=int, default=500)
    p.add_argument(
        "--version", choices=["v1", "v2", "v3", "fbe"], default="v2",
        help="policy variant; 'fbe' is the OracleFBE nearest-frontier baseline",
    )
    p.add_argument("--controller", choices=["neural", "greedy"], default="greedy")
    p.add_argument(
        "--farm", type=int, default=0, metavar="LANES",
        help="synthetic backend: run LANES episode lanes fed by sim worker "
        "processes over the native shm ring (runner/sim_farm.py)",
    )
    p.add_argument("--farm-workers", type=int, default=2)
    p.add_argument("--pointnav-weights", default=None, help="the reference's PointNav .pth, loaded as it is")
    p.add_argument(
        "--weights-dir", default=None,
        help="serving bundle from python -m vlfm_tpu_torch.convert_checkpoints "
        "(habitat backend, synthetic --farm)",
    )
    p.add_argument(
        "--habitat-config", default=None,
        help="habitat backend: habitat-lab config path (defaults to the "
        "benchmark ObjectNav HM3D config)",
    )
    p.add_argument("--video-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--trace-dir", default=None,
                   help="keep the program's spans and counters and write them to DIR/spans.json (Perfetto)")
    args = p.parse_args()
    if not args.trace_dir:
        return _run(args)
    from vlfm_tpu_torch.utils import profiling

    with profiling.tracing():
        try:
            _run(args)
        finally:
            profiling.write_spans(os.path.join(args.trace_dir, "spans.json"))


def _run(args) -> None:
    if args.weights_dir:
        from vlfm_tpu_torch.runner.weights import BundleError, read_manifest

        try:
            read_manifest(args.weights_dir)
        except BundleError as e:
            raise SystemExit(f"--weights-dir: {e}") from None
    if args.backend == "reality":
        raise SystemExit(
            "reality backend requires the Boston Dynamics SDK; construct "
            "vlfm_tpu_torch.reality.envs.ObjectNavEnv with a BDSWRobot and drive "
            "it with vlfm_tpu_torch.policy.reality.RealityITMPolicyV2 (see "
            "vlfm_tpu_torch/reality/) — FakeRobot works for dry runs"
        )

    from vlfm_tpu_torch.config import VLFMConfig, load_config
    from vlfm_tpu_torch.device import default_device
    from vlfm_tpu_torch.mapping.grid import GridSpec2D
    from vlfm_tpu_torch.runner import log_saver, metrics

    device = "cpu" if args.cpu else default_device()
    cfg = load_config(args.config) if args.config else VLFMConfig()
    spec = GridSpec2D(cfg.map_size, cfg.pixels_per_meter, cfg.map_pad)

    if args.controller == "neural":
        from vlfm_tpu_torch.models.pointnav import PointNavPolicy

        depth_shape = tuple(cfg.depth_image_shape)
        if args.pointnav_weights:
            pointnav = load_pointnav_weights(args.pointnav_weights, depth_shape, device)
        else:
            pointnav = PointNavPolicy.init_random(0, depth_shape=depth_shape, device=device)
    else:
        pointnav = "greedy"

    if args.backend == "habitat":
        # The eval loop itself is habitat-free (runner/habitat_eval.py, run
        # by the tests over FakeHabitatEnv); only the env construction needs
        # habitat-lab and fails at `import habitat`.
        from vlfm_tpu_torch.adapters.habitat import HabitatVLFMAgent
        from vlfm_tpu_torch.runner.full_stack import FullStackPerception
        from vlfm_tpu_torch.runner.habitat_eval import evaluate, make_habitat_env

        if args.weights_dir:
            from vlfm_tpu_torch.runner.weights import full_stack_from_bundle

            perception = full_stack_from_bundle(cfg, args.weights_dir, device=device)
        else:
            perception = FullStackPerception(cfg, device=device)
        agent = HabitatVLFMAgent(cfg, spec, pointnav, perception, version=args.version, device=device)
        # One habitat.Env for the whole run; advance() moves it to the next
        # episode so the loop can claim by episode id before reset.
        holder: list = [None]

        def factory(i):
            if holder[0] is None:
                holder[0] = make_habitat_env(args.habitat_config)
            return holder[0].advance()

        results = evaluate(factory, agent, args.episodes, log_dir=args.log_dir, video_dir=args.video_dir)
        print(json.dumps(metrics.aggregate(results), indent=2))
        return

    from vlfm_tpu_torch.runner.episode_driver import run_episode
    from vlfm_tpu_torch.runner.fake_env import EnvConfig, FakeObjectNavEnv, two_room_plan

    env_cfg = EnvConfig(width=cfg.camera.width, height=cfg.camera.height, max_steps=args.max_steps)
    if args.farm:
        from vlfm_tpu_torch.runner.sim_farm import run_episodes_farm

        perception = None
        if args.weights_dir:  # the bundle's model stack over the streamed synthetic RGBD
            from vlfm_tpu_torch.runner.weights import full_stack_from_bundle

            perception = full_stack_from_bundle(cfg, args.weights_dir, device=device)
        results_map, stats = run_episodes_farm(
            list(range(args.episodes)), lanes=args.farm, pointnav=pointnav,
            spec=spec, cfg=cfg, plan_name="two_room_plan", env_cfg=env_cfg,
            workers=args.farm_workers, version=args.version,
            max_steps=args.max_steps, perception=perception, device=device,
        )
        results = [results_map[s] for s in sorted(results_map)]
        print(
            f"farm: {stats.env_steps} env steps in {stats.wall_time:.1f}s "
            f"({stats.steps_per_sec:.2f} steps/s, {stats.dispatches} dispatches)"
        )
        print(json.dumps(metrics.aggregate(results), indent=2))
        return
    results = []
    for ep in range(args.episodes):
        if args.log_dir and not log_saver.claim_episode(ep, "two_room", args.log_dir):
            continue
        env = FakeObjectNavEnv(two_room_plan(seed=ep), env_cfg)
        result, stats = run_episode(env, pointnav, spec, cfg, seed=ep, version=args.version, device=device)
        results.append(result)
        if args.log_dir:
            log_saver.log_episode(
                ep, "two_room", {**result.to_dict(), "target_object": "cylinder"}, args.log_dir
            )
        print(
            f"episode {ep}: success={result.success} spl={result.spl:.3f} "
            f"steps={result.steps} ({stats.steps_per_sec:.2f} steps/s)"
        )
    print(json.dumps(metrics.aggregate(results), indent=2))


if __name__ == "__main__":
    main()
