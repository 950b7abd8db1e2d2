"""pmv_tpu_torch: the PyTorch and CUDA port of pmv_tpu for NVIDIA Hopper.

A package beside ``pmv_tpu`` that mirrors its module paths. It imports
torch, numpy and yaml, and nothing of JAX or of ``pmv_tpu``. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``. The
kernels that ``pmv_tpu`` wrote in Pallas for the TPU are hand-written CUDA
kernels here (``ops/csrc``), built with nvcc at first use.
"""

__version__ = "0.1.0"
