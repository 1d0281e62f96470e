"""repro_torch -- DELTA on PyTorch and CUDA (NVIDIA Hopper).

The second package of this repository, beside the JAX reference `repro`,
which it imports nothing from.  Module names mirror `repro`'s, so each
counterpart is found under the same path.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"`` (as the tests do); with
no CUDA device and no device given they raise.

Every parity tolerance of the port assumes true float32 arithmetic, so
TF32 is switched off for matrix products and cuDNN on import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
