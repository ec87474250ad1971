"""vlfm_tpu_torch — the PyTorch/CUDA port of vlfm_tpu for NVIDIA Hopper.

The package mirrors ``vlfm_tpu``'s module paths, so each function's JAX
counterpart sits at the same path there. Plain tensor code is PyTorch; the
TPU's Pallas kernels become CUDA kernels in ``csrc/``, built with ``nvcc``
at first use (``kernels/build.py``). Each kernel's wrapper runs the kernel
on CUDA tensors and a plain PyTorch version on CPU tensors.

Ported so far, in the order of the slices: BLIP2-ITM scoring (ViT-g +
Q-Former, LayerNorm and attention kernels), the value map, frontier
scoring and selection and the greedy controller; detection with OWL-ViT
and the COCO route, segmented by gated MobileSAM (TinyViT with the MBConv
chain kernel); the obstacle map and its frontiers, and ViT-g attention on
a CUDA kernel; GroundingDINO (Swin-T and BERT, with the deformable gather
kernel) as the pipeline's other open-vocabulary detector; the kernels
redesigned for Hopper; the maps batch-first, jax's threefry and the object
map; the whole policy step with PointNav, the V1 frontier cache and the
episode drivers; and the full stack, real perception feeding the batched
step in one packed dispatch (``runner/full_stack.py``), with the streamed
farm of sim worker processes over the shared-memory ring
(``runner/sim_farm.py``, ``runner/obsring.py``, ``runner/packing.py``);
the VQA veto and ZoeDepth; and the evaluation entry points
(``python -m vlfm_tpu_torch.run``, ``runner/demo.py``, the
Habitat-protocol loop of ``adapters/habitat.py`` and
``runner/habitat_eval.py``) with PointNav's behaviour cloning
(``runner/imitation.py``); the robot path (``reality/robots.py``,
``reality/envs.py``, ``policy/reality.py``) with mid-episode checkpoints
(``runner/checkpoint.py``), value-map record and replay
(``mapping/value_map_io.py``) and step timers (``utils/profiling.py``).
Entry points put their tensors on the card
unless the caller passes ``device="cpu"`` (``device.py``; ``--cpu`` on the
command lines). The package imports neither jax nor ``vlfm_tpu``: the host
modules it needs (``config``, ``models.tokenizer``,
``models.coco_classes``, ``runner.fake_env``, ``runner.metrics``,
``utils.measurements``, ``runner.log_saver``, ``runner.analyze_logs``,
``utils.visualization``, ``utils.video``, ``policy.action_replay``,
``policy.oracle_fbe``, ``reality.robots``, ``reality.envs``) are its own copies, and the ring's C++ source,
``native/obsring.cpp``, is built by the port's own compile step.
"""

__version__ = "0.1.0"
