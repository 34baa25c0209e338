"""rac2d_torch — the disk thermo-chemistry framework in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package that sits beside it in this repository; module
names match one to one (``rac2d_torch/ops/bdf.py`` is the counterpart of the
JAX package's ``ops/bdf.py``).  This package imports torch and numpy only.

Precision policy (the same as the JAX package's):

- the chemistry and thermal solve path is float64 — the problem spans ~30
  decades of abundance and is ill-conditioned; the H100 runs f64 natively;
- the Newton LU is float32 with full f32 accumulation.  TF32 would keep
  about three decimal digits inside a factorization, so it is switched off
  here for both matmuls and cuDNN, and the hand kernels use plain f32 FMA.

The package picks no device: every entry point takes an explicit
``device`` (or follows the device of the tensors it is given).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
