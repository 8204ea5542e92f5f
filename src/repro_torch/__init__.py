"""PyTorch/CUDA port of `repro` (exact sparse RTRL with combined activity
and parameter sparsity), written for one NVIDIA H100.

The package mirrors `repro`'s module paths (`repro_torch/core/sparse_rtrl.py`
is the counterpart of `repro/core/sparse_rtrl.py`, and so on) and keeps the
JAX package's parameter-tree structure and layouts, so the parity tests
compare like with like.  It imports neither `jax` nor `repro`.

The exactness claim is float32: TF32 is switched off for matrix products
and convolutions here, once, for every user of the port.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
