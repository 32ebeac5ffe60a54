"""The grouped (per-expert) matmul kernel for Hopper: build, bind, launch.

Replaces the Pallas TPU kernel ``grouped_matmul``
(``src/repro/kernels/moe/kernel.py:38``, body ``_gmm_kernel``). The kernel
is CUDA C++ in ``csrc/grouped_matmul.cu``: bf16 through the tensor cores
(``mma.sync`` m16n8k16, float32 accumulators), float32 through float32 FMAs
on the CUDA cores, one block per (C tile, F tile, expert) walking the whole
D axis (its header gives the design). On grok-1's main path the prefill's
calls are bound by the tensor cores (8.34 ms a call at 989 TFLOP/s) and the
decode step's by the weights' bytes (0.96 ms at 3.35 TB/s). It is compiled
with ``nvcc`` for ``sm_90a`` on first use into the ``build/`` directory
beside this file (ignored by git) by :mod:`repro_torch.kernels.build`, and
bound with ``ctypes``. Nothing is built or loaded when this module is
imported.

:func:`grouped_matmul_cuda` is the launching wrapper: it checks device,
dtype, shape and contiguity, allocates the output with ``torch.empty``,
launches on PyTorch's current stream, raises if the launch fails, and
counts its launches in the module-level integer :data:`launches`. Unlike
the Pallas wrapper it takes any ``C, D, F >= 1``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernel (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "grouped_matmul", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.grouped_matmul.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
            lib.grouped_matmul.restype = i32
            lib.grouped_matmul_error_string.argtypes = [i32]
            lib.grouped_matmul_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_TYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x (E, C, D) and w (E, D, F); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    if not (1 <= e <= 65535 and 1 <= c <= _I32_MAX and 1 <= d <= _I32_MAX
            and 1 <= f <= 128 * 65535):
        raise ValueError(f"want 1 <= E <= 65535, C, D >= 1 and 1 <= F <= "
                         f"{128 * 65535}; got x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device} "
                             f"(got {t.device})")
        if t.dtype not in _TYPES:
            raise ValueError(f"{name} must be float32 or bfloat16 (got "
                             f"{t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (row-major)")
    if w.dtype != x.dtype:
        raise ValueError(f"x and w must have one dtype (got {x.dtype} and "
                         f"{w.dtype})")


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``y (E, C, F)`` in x's dtype, contiguous, with
    ``y[e] = x[e] @ w[e]``, every product exact and summed in float32, one
    rounding at the end.

    x ``(E, C, D)`` and w ``(E, D, F)``: contiguous, one dtype (float32 or
    bfloat16), on one CUDA device. Raises on anything the kernel does not
    take and when the launch fails.
    """
    global launches
    _check(x, w)
    lib = _load()
    e, c, d = x.shape
    f = w.shape[2]
    y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                 int(x.dtype == torch.bfloat16), e, c, d, f,
                                 stream)
    if err != 0:
        msg = lib.grouped_matmul_error_string(err).decode()
        raise RuntimeError(f"grouped matmul kernel launch failed: {msg}")
    launches += 1
    return y
