"""PyTorch/CUDA port of the SEM Poisson solver with polynomial-reduction
domain-decomposition preconditioning.

A second package beside the JAX reference (the package of the same name
ending in ``_tpu``), mirroring its module paths and public names. It imports torch, numpy and
scipy only — never jax, and nothing of the JAX package.

Entry points take ``device=None``, which means the CUDA card; without
CUDA they raise instead of running on the CPU. Tests pass
``device="cpu"``, where every hand-written kernel's wrapper runs its
plain PyTorch twin (ops/kernels.py).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]

# The JAX package contracts everything at Precision.HIGHEST: no TF32, and
# no bf16 partial sums inside cuBLAS's bf16 products (the bf16 inner
# solve's dots round once, from an f32 sum).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, raising when there is none; anything else
    is taken as given (``"cpu"`` for the tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
