"""The depthwise causal conv1d kernel for Hopper: build, bind, launch.

Replaces the Pallas TPU kernel ``conv1d_causal``
(``src/repro/kernels/conv1d/kernel.py:36``, body ``_conv_kernel``). The
kernel is CUDA C++ in ``csrc/conv1d_causal.cu`` (its header gives the design
and what bounds it). It is compiled with ``nvcc`` for ``sm_90a`` on first
use into the ``build/`` directory beside this file (ignored by git) by
:mod:`repro_torch.kernels.build`, and bound with ``ctypes``. Nothing is
built or loaded when this module is imported.

:func:`conv1d_cuda` is the launching wrapper: it checks device, dtype,
shape and strides, allocates the output with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch fails, and counts its
launches in the module-level integer :data:`launches`. Unlike the Pallas
wrapper it takes any ``S >= 1`` and ``D >= 1`` and reads x and w through
their strides (an input expanded over D with stride 0 is not copied).
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "conv1d_causal.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
MAX_WIDTH = 8                 # the widest tap count the kernel is built for

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernel (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "conv1d_causal", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.conv1d_causal.argtypes = ([ptr] * 3 + [i32] * 6 + [i64] * 5
                                          + [ptr])
            lib.conv1d_causal.restype = i32
            lib.conv1d_causal_error_string.argtypes = [i32]
            lib.conv1d_causal_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_TYPES = (torch.float32, torch.bfloat16)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x (B, S, D) and w (W, D); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    b, s, d = x.shape
    if not (1 <= b <= 65535 and s >= 1 and d >= 1):
        raise ValueError(f"want 1 <= B <= 65535, S >= 1, D >= 1; got "
                         f"{tuple(x.shape)}")
    if not 1 <= w.shape[0] <= MAX_WIDTH:
        raise ValueError(f"width {w.shape[0]} outside [1, {MAX_WIDTH}]")
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device} "
                             f"(got {t.device})")
        if t.dtype not in _TYPES:
            raise ValueError(f"{name} must be float32 or bfloat16 (got "
                             f"{t.dtype})")
        if any(st < 0 for st in t.stride()):
            raise ValueError(f"{name} has a negative stride")


def conv1d_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``y (B, S, D)`` in x's dtype, contiguous, with
    ``y[b, t, d] = sum_i w[i, d] * x[b, t - W + 1 + i, d]`` (x = 0 before t
    = 0), accumulated in float32.

    x ``(B, S, D)`` and w ``(W, D)``, ``W <= MAX_WIDTH``: float32 or
    bfloat16, any non-negative strides (x may be expanded over D with
    stride 0), on one CUDA device. Raises on anything the kernel does not
    take and when the launch fails.
    """
    global launches
    _check(x, w)
    lib = _load()
    b, s, d = x.shape
    y = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1d_causal(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            b, s, d, w.shape[0], *x.stride(), *w.stride(), stream)
    if err != 0:
        msg = lib.conv1d_causal_error_string(err).decode()
        raise RuntimeError(f"conv1d kernel launch failed: {msg}")
    launches += 1
    return y
