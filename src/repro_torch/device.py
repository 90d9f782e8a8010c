"""Device selection and the determinism settings of the card.

The port's entry points run on the card unless the caller asks for the
CPU: they take ``device="cuda"`` by default and resolve it here.  Without a
card they raise rather than run on the CPU unasked.
"""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "set_cuda_determinism"]


def set_cuda_determinism() -> None:
    """Full-float32 matrix products and deterministic algorithms on the card.

    TF32 would round the operands of every float32 product; deterministic
    algorithms pin the order of the remaining library reductions.  cuBLAS
    reads ``CUBLAS_WORKSPACE_CONFIG`` when its handle is created, so it is
    set here before the first product if the caller has not set it.
    """
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``cuda`` requires a card and sets
    :func:`set_cuda_determinism`."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        set_cuda_determinism()
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    return dev
