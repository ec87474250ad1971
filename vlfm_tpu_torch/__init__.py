"""vlfm_tpu_torch — the PyTorch/CUDA port of vlfm_tpu for NVIDIA Hopper.

The package mirrors ``vlfm_tpu``'s module paths, so each function's JAX
counterpart sits at the same path there. Plain tensor code is PyTorch; the
TPU's Pallas kernels become CUDA kernels in ``csrc/``, built with ``nvcc``
at first use (``kernels/build.py``). Each kernel's wrapper runs the kernel
on CUDA tensors and a plain PyTorch version on CPU tensors.

Ported so far: BLIP2-ITM scoring (ViT-g + Q-Former, LayerNorm and
attention kernels), the obstacle map with its frontiers, the value map,
frontier scoring and selection, and the greedy controller; detection with
OWL-ViT and the COCO route, segmented by gated MobileSAM (TinyViT with the
MBConv chain kernel). Entry points put their tensors on the card unless the
caller passes ``device="cpu"`` (``device.py``). The package imports neither jax nor
``vlfm_tpu``: the host modules it needs (``config``, ``models.tokenizer``,
``models.coco_classes``, ``runner.fake_env``) are its own copies.
"""

__version__ = "0.1.0"
