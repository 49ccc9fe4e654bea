"""xpic_tpu_torch — the PyTorch port of xpic_tpu: the ECSIM, ecsimcorr and
eccapfim schemes behind ``python -m xpic_tpu_torch cfg.json``.

Module names mirror the JAX package ``xpic_tpu`` so each function's
counterpart is found by path.  The port takes device and dtype from its
input tensors: there is no global dtype switch.  A CUDA float32 tensor
reaches the hand-written Hopper kernels (``xpic_tpu_torch/csrc``, built by
``xpic_tpu_torch.kernels``); a CPU tensor takes each kernel's plain
PyTorch twin; anything else raises.

Float32 contractions on the card stay in full IEEE float32: TF32 keeps
about three decimal digits, far coarser than the f32 solve tolerance of
1e-5, so the pins below are set once, at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
