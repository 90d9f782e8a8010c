"""What every ``ctypes`` kernel wrapper shares: the C entry point, input
checks, pointers and the launch-error check.

A wrapper checks device, dtype, shape and contiguity of every tensor it
passes (the kernel takes raw pointers and trusts them), allocates its
outputs with ``torch.empty``, launches on ``torch.cuda.current_stream()``
and raises if the C entry reports a CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["P", "I", "F", "check", "entry", "ptr", "raise_on_error",
           "stream", "require_cuda"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def entry(source: str, symbol: str, argtypes):
    """The C function ``symbol`` of ``csrc/<source>.cu`` (built at first
    use), with its argument types set; every pointer and the stream are
    ``c_void_p``."""
    fn = getattr(build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = I
    return fn


def require_cuda(op: str, t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{op}: the CUDA kernel needs CUDA tensors, got "
                         f"{t.device}")
    return t.device


def require_meta(op: str, t: torch.Tensor) -> torch.device:
    """The device of a kernel's meta branch (shapes only, nothing run)."""
    if t.device.type != "meta":
        raise ValueError(f"{op}: the meta branch takes meta tensors, got "
                         f"{t.device}")
    return t.device


def nbytes(*ts) -> int:
    """Bytes of the tensors (None skipped), each counted whole."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check(op: str, name: str, t: torch.Tensor, dtype, shape, device, *,
          contiguous: bool = True) -> None:
    """Raise unless ``t`` lies on ``device`` with ``dtype`` (one dtype or a
    tuple of them) and ``shape``, contiguous unless ``contiguous=False``
    (for a kernel that reads through the strides)."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{op}: {name} has dtype {t.dtype}, expected "
                        f"{' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{op}: {name} is not contiguous")


def ptr(t):
    return None if t is None else t.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(op: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {err}")
