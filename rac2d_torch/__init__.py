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

Every public entry point (``DiskModel``, ``ChemicalODE``,
``ThermalBalance``, ``odesys.tolerance_ladder``, the weight-carrying
functions of ``convert``) runs on the card, ``device="cuda"``, unless the
caller passes another device, as the CPU tests pass ``device="cpu"``.
Nothing falls back to the CPU: without CUDA a default call raises
torch's own error.  Internal helpers have no default; they take the
caller's device or follow the device of the tensors they are given.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
