"""The Mamba-2 SSD chunk-scan kernel for Hopper: build, bind, launch.

Replaces the Pallas TPU kernel ``ssd_hm``
(``src/repro/kernels/ssd/kernel.py:67``, body ``_ssd_kernel``). The kernel
is CUDA C++ in ``csrc/ssd_chunk_scan.cu`` (its header gives the design and
what bounds it). It is compiled with ``nvcc`` for ``sm_90a`` on first use
into the ``build/`` directory beside this file (ignored by git) by
:mod:`repro_torch.kernels.build`, and bound with ``ctypes``. Nothing is
built or loaded when this module is imported.

:func:`ssd_cuda` is the launching wrapper: it checks device, dtype, shape
and strides, allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream, raises if the launch fails, and counts its
launches in the module-level integer :data:`launches`. Unlike the Pallas
wrapper it takes the model's layout through strides (no head-major copy;
B and C may be broadcast over heads with stride 0) and any ``S >= 1``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_chunk_scan.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024      # the kernel's tile limits

# launches of the CUDA kernel since the count was last set to 0
launches = 0

_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernel (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "ssd_chunk_scan", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ssd_chunk_scan.argtypes = ([ptr] * 6 + [i32] * 8 + [i64] * 12
                                           + [ptr])
            lib.ssd_chunk_scan.restype = i32
            lib.ssd_chunk_scan_error_string.argtypes = [i32]
            lib.ssd_chunk_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_TYPES = (torch.float32, torch.bfloat16)


def _check(x, dA, B, C, chunk) -> None:
    if x.dim() != 4 or dA.dim() != 3 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"want x (b, s, h, p), dA (b, s, h), B and C "
                         f"(b, s, h, n); got {tuple(x.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, h, p = x.shape
    if tuple(dA.shape) != (b, s, h) or tuple(B.shape[:3]) != (b, s, h):
        raise ValueError(f"dA {tuple(dA.shape)} and B/C {tuple(B.shape)} do "
                         f"not match x {tuple(x.shape)}")
    n = B.shape[3]
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N and s >= 1 and b * h >= 1):
        raise ValueError(f"want p <= {MAX_P}, n <= {MAX_N}, s >= 1; got "
                         f"p {p}, n {n}, s {s}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if b * h >= 2 ** 31:
        raise ValueError(f"b * h = {b * h} exceeds the kernel's grid")
    for name, t in (("x", x), ("dA", dA), ("B", B), ("C", C)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device} "
                             f"(got {t.device})")
        if any(st < 0 for st in t.stride()):
            raise ValueError(f"{name} has a negative stride")
    if x.dtype not in _TYPES or B.dtype not in _TYPES or C.dtype != B.dtype:
        raise ValueError(f"want x, B and C float32 or bfloat16 (B and C "
                         f"alike); got {x.dtype}, {B.dtype}, {C.dtype}")
    if dA.dtype != torch.float32:
        raise ValueError(f"dA must be float32 (got {dA.dtype})")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")


def ssd_cuda(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(y (b, s, h, p) in x's dtype, state (b, h, p,
    n) float32)``, the state starting at 0, chunks of ``min(chunk, s)``.

    x ``(b, s, h, p)``, B and C ``(b, s, h, n)``: float32 or bfloat16, any
    non-negative strides with the last dimension contiguous (B and C may be
    expanded over h); dA ``(b, s, h)`` float32, any strides; all on one
    CUDA device. Raises on anything the kernel does not take and when the
    launch fails.
    """
    global launches
    _check(x, dA, B, C, chunk)
    lib = _load()
    b, s, h, p = x.shape
    n = B.shape[3]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = [*x.stride()[:3], *dA.stride(), *B.stride()[:3], *C.stride()[:3]]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_chunk_scan(
            x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr(), int(x.dtype == torch.bfloat16),
            int(B.dtype == torch.bfloat16), b, s, h, p, n, min(chunk, s),
            *strides, stream)
    if err != 0:
        msg = lib.ssd_chunk_scan_error_string(err).decode()
        raise RuntimeError(f"SSD chunk-scan kernel launch failed: {msg}")
    launches += 1
    return y, state
