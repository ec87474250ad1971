"""A frozen copy of ``vlfm_tpu_torch`` as of commit 7359553, the benchmark's yardstick.

The benchmark's plain reference and its traffic generator (the fake
HM3D-like scenes of ``runner/fake_env.py``) come from here, never from the
port, so no later change to the port moves them. Only the modules and the
functions that the benchmark's cells run were copied, with their imports
pointed here. The kernel wrappers (``ops/norms.py``, ``ops/attention.py``,
``ops/conv_fused.py``) take their plain PyTorch versions on every device; nothing here loads a
CUDA kernel. Do not edit: a fix to the port is not a fix to the yardstick.
"""
