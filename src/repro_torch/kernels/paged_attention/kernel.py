"""The paged decode attention kernel for Hopper: build, bind, launch.

Replaces the Pallas TPU kernel ``paged_attention_kernel``
(``src/repro/kernels/paged_attention/kernel.py:105``, body ``_paged_kernel``).
The kernel is CUDA C++ in ``csrc/paged_attention.cu`` (its header comment
gives the design and what bounds it). It is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C entry on first use, into
the ``build/`` directory beside this file (ignored by git; the shared
recipe is :mod:`repro_torch.kernels.build`), and bound with ``ctypes``.
Nothing is built or loaded when this module is imported.

:func:`paged_attention_cuda` is the launching wrapper: it checks device,
dtype, shape and contiguity, allocates the output, launches on PyTorch's
current stream, raises if the launch fails, and counts its launches in
the module-level integer :data:`launches`.
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import threading

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernel (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "paged_attention", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.paged_attention_launch
            fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.paged_attention_error_string.argtypes = [ctypes.c_int]
            lib.paged_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(q, k_pool, v_pool, tables, lengths) -> None:
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool, "tables": tables,
               "lengths": lengths}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device} "
                             f"(got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES:
        raise ValueError(f"q and pool must be float32 or bfloat16 (got "
                         f"{q.dtype}, {k_pool.dtype})")
    if v_pool.dtype != k_pool.dtype or v_pool.shape != k_pool.shape:
        raise ValueError("k_pool and v_pool must match in shape and dtype")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("tables and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or tables.dim() != 2:
        raise ValueError(f"want q (B,H,D), pools (P,ps,K,D), tables (B,NP); "
                         f"got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(tables.shape)}")
    b, h, d = q.shape
    _, _, kh, dk = k_pool.shape
    if dk != d or h % kh or not 1 <= d <= 128:
        raise ValueError(f"head dims: q {tuple(q.shape)} vs pool "
                         f"{tuple(k_pool.shape)} (H % K == 0, D <= 128)")
    if tables.shape[0] != b or tuple(lengths.shape) != (b,) or b > 65535:
        raise ValueError(f"tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={b}")


def paged_attention_cuda(q, k_pool, v_pool, tables, lengths, *,
                         window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: o (B, H, D) in ``q.dtype``.

    q (B, H, D) and pools (P, ps, K, D) in float32 or bfloat16; tables
    (B, NP) and lengths (B,) int32; all contiguous, on one CUDA device.
    ``window`` reads the tables as rings and attends over the last
    ``window`` positions; ``scale`` defaults to ``1/sqrt(D)``. Raises on
    anything the kernel does not take and when the launch fails.
    """
    global launches
    _check(q, k_pool, v_pool, tables, lengths)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window})")
    lib = _load()
    b, h, d = q.shape
    n_pages, ps, kh, _ = k_pool.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            b, h, kh, d, n_pages, ps, tables.shape[1],
            window or 0, float(scale),
            _DTYPES[q.dtype], _DTYPES[k_pool.dtype], stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged attention kernel launch failed: {msg}")
    launches += 1
    return out
