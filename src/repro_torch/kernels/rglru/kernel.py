"""The RG-LRU linear-scan kernel for Hopper: build, bind, launch.

Replaces the Pallas TPU kernel ``rglru_scan``
(``src/repro/kernels/rglru/kernel.py:46``, body ``_rglru_kernel``). The
kernel is CUDA C++ in ``csrc/rglru_scan.cu`` (its header gives the design
and what bounds it). It is compiled with ``nvcc`` for ``sm_90a`` on first
use into the ``build/`` directory beside this file (ignored by git) by
:mod:`repro_torch.kernels.build`, and bound with ``ctypes``. Nothing is
built or loaded when this module is imported.

:func:`rglru_scan_cuda` is the launching wrapper: it checks device, dtype,
shape and contiguity, allocates the outputs with ``torch.empty``, launches
on PyTorch's current stream, raises if the launch fails, and counts its
launches in the module-level integer :data:`launches`. Unlike the Pallas
wrapper it takes any ``S >= 1`` and any ``W`` (no block divisibility).
:func:`vec_bytes` gives the width of the kernels' copies into shared
memory for a call (16 bytes, or 4 where ``W`` or an input's address does
not allow 16), which the wrapper passes to the C entry.
:func:`rglru_scan_bwd_cuda` launches the same source's backward kernel (the
gradient of the scan, which no TPU kernel computes) and counts its launches
in :data:`launches_bwd`.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

# launches of the CUDA forward / backward kernel since the count was last
# set to 0
launches = 0
launches_bwd = 0

_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernel (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "rglru_scan", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.rglru_scan.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            lib.rglru_scan.restype = i32
            lib.rglru_scan_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
            lib.rglru_scan_bwd.restype = i32
            lib.rglru_scan_error_string.argtypes = [i32]
            lib.rglru_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def vec_bytes(w: int, *tensors) -> int:
    """Bytes of one ``cp.async`` copy for inputs of width ``w``: 16 where a
    row's ``w`` floats fill whole 16-byte pieces (``w % 4 == 0``) and every
    input starts on 16 bytes, else 4. The C entry refuses 16 otherwise."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 16 if w % 4 == 0 and aligned else 4


def _check(a, b, **more) -> None:
    for name, t in (("a", a), ("b", b), *more.items()):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name} must be a CUDA tensor on {a.device} "
                             f"(got {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (got {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 3 or any(t.shape != a.shape for t in (b, *more.values())):
        raise ValueError(f"want {', '.join(['a', 'b', *more])} (B, S, W) of "
                         f"one shape; got {tuple(a.shape)}, "
                         f"{[tuple(t.shape) for t in (b, *more.values())]}")
    bsz, s, w = a.shape
    if not (1 <= bsz <= 65535 and s >= 1 and w >= 1):
        raise ValueError(f"shape {tuple(a.shape)}: want 1 <= B <= 65535, "
                         f"S >= 1, W >= 1")
    if s * w >= 2 ** 31:
        raise ValueError(f"S * W = {s * w} exceeds the kernel's int range")


def rglru_scan_cuda(a: torch.Tensor,
                    b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(y (B, S, W), h_final (B, W))``, float32.

    a, b ``(B, S, W)`` float32, contiguous, on one CUDA device; h starts at
    0. Raises on anything the kernel does not take and when the launch
    fails.
    """
    global launches
    _check(a, b)
    lib = _load()
    bsz, s, w = a.shape
    y = torch.empty_like(a)
    h_final = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan(a.data_ptr(), b.data_ptr(), y.data_ptr(),
                             h_final.data_ptr(), bsz, s, w,
                             vec_bytes(w, a, b), stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"RG-LRU scan kernel launch failed: {msg}")
    launches += 1
    return y, h_final


def rglru_scan_bwd_cuda(a: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                        dh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: ``(da, db)`` (B, S, W) float32, the
    gradients of :func:`rglru_scan_cuda` (h starting at 0) for the output
    gradients ``dy`` of ``y`` and ``dh`` (B, W) of ``h_final``; ``y`` is
    the forward's output (``h_{t-1}`` for ``da``). All float32, contiguous,
    on one CUDA device. Raises on anything the kernel does not take and when
    the launch fails."""
    global launches_bwd
    _check(a, y, dy=dy)
    bsz, s, w = a.shape
    if dh.device != a.device or dh.dtype != torch.float32 or \
            tuple(dh.shape) != (bsz, w) or not dh.is_contiguous():
        raise ValueError(f"dh must be ({bsz}, {w}) float32, contiguous, on "
                         f"{a.device} (got {tuple(dh.shape)} {dh.dtype} on "
                         f"{dh.device})")
    lib = _load()
    da, db = torch.empty_like(a), torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.rglru_scan_bwd(a.data_ptr(), y.data_ptr(), dy.data_ptr(),
                                 dh.data_ptr(), da.data_ptr(), db.data_ptr(),
                                 bsz, s, w, vec_bytes(w, a, y, dy), stream)
    if err != 0:
        msg = lib.rglru_scan_error_string(err).decode()
        raise RuntimeError(f"RG-LRU scan backward kernel launch failed: {msg}")
    launches_bwd += 1
    return da, db
