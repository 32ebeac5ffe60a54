"""The flash-attention kernels for Hopper: build, bind, launch.

Replaces the Pallas TPU kernel ``flash_attention_hm``
(``src/repro/kernels/attention/kernel.py:69``) with a CUDA forward that also
writes the log-sum-exp, and the reference's pure-JAX backward ``_flash_bwd``
(``src/repro/models/layers.py:170``) with a CUDA pre-pass for ``delta =
rowsum(do * o)`` (``flash_bwd_delta_kernel``), then a dK/dV kernel and a dQ
kernel. The route is by dtype and head dim D, nothing else:

- bfloat16 runs on the tensor cores (bf16 ``mma.sync`` with float32
  accumulators): the forward ``flash_fwd_mma_kernel`` at any D (a 64-key
  step at D <= 128, a 32-key step at D 256), the backward
  ``flash_bwd_dkdv_mma_kernel`` at D <= 128, at D 256
  ``flash_bwd_dkdv_d256_kernel`` (one block per query head and 64-key
  tile, dK and dV in one launch; with H > K each head's float32 share
  goes to a workspace that ``flash_bwd_d256_sum_kernel`` sums over the
  group in head order), and ``flash_bwd_dq_mma_kernel`` (16-key steps at
  D 256);
- float32 runs on the CUDA cores: ``flash_fwd_kernel``,
  ``flash_bwd_dkdv_kernel`` and ``flash_bwd_dq_kernel``, at D 256
  ``flash_bwd_dkdv_seq_kernel`` and ``flash_bwd_dq_seq_kernel``.

The source is ``csrc/flash_attention.cu`` (its header gives the design and
what bounds it). It is built with ``nvcc`` for ``sm_90a`` on first use into
the ``build/`` directory beside this file (ignored by git) by
:mod:`repro_torch.kernels.build`, and bound with ``ctypes``. Nothing is
built or loaded when this module is imported.

:func:`flash_attention_fwd_cuda` and :func:`flash_attention_bwd_cuda` are the
launching wrappers: they check device, dtype, shape and contiguity, copy a
view that is not 16-byte aligned, allocate outputs with ``torch.empty``,
launch on PyTorch's current stream, raise if a launch fails, and count their
calls in the module-level integers :data:`launches_fwd` and
:data:`launches_bwd` (one backward call launches the delta pre-pass, the
dK/dV kernel, at D 256 with H > K the sum of its shares, and the dQ
kernel); :data:`launches_fwd_mma` counts the forward calls that the C entry
reports it ran on the tensor-core kernel, :data:`launches_bwd_d256` the
backward calls it reports it ran on the bf16 D 256 kernels.
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import threading

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

# calls of the CUDA forward / backward since the count was last set to 0;
# of those forward calls the ones the C entry reports it ran on the
# tensor-core kernel, of the backward calls those on the bf16 D 256 route
launches_fwd = 0
launches_bwd = 0
launches_fwd_mma = 0
launches_bwd_d256 = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernels (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "flash_attention", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.flash_attention_fwd.argtypes = (
                [ptr] * 5 + [i32] * 8 + [ctypes.c_float, i32, ptr,
                                         ctypes.POINTER(i32)])
            lib.flash_attention_bwd.argtypes = (
                [ptr] * 11 + [i32] * 8 + [ctypes.c_float, i32, ptr,
                                          ctypes.POINTER(i32)])
            lib.flash_attention_fwd.restype = i32
            lib.flash_attention_bwd.restype = i32
            lib.flash_attention_error_string.argtypes = [i32]
            lib.flash_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(tensors: dict, q, k) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"want q (B,S,H,D) and k/v (B,S,K,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match (same B and D, H % K == 0)")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head dim {d}: the kernel takes D <= 256, a "
                         f"multiple of 8")
    if b * h > 65535:
        raise ValueError(f"B * H = {b * h} exceeds the grid's 65535")
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device} "
                             f"(got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16 (got {q.dtype})")


def _check_like(name: str, t, like) -> None:
    if t.shape != like.shape or t.dtype != like.dtype:
        raise ValueError(f"{name} must match {tuple(like.shape)} "
                         f"{like.dtype} (got {tuple(t.shape)} {t.dtype})")


def _check_rows(name: str, t, q) -> None:
    b, s, h, _ = q.shape
    if tuple(t.shape) != (b, h, s) or t.dtype != torch.float32:
        raise ValueError(f"{name} must be ({b}, {h}, {s}) float32 (got "
                         f"{tuple(t.shape)} {t.dtype})")


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} launch failed: {msg}")


def _window(window: int | None) -> int:
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window})")
    return window or 0


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True,
                             window: int | None = None):
    """Launch the forward: ``(o, lse)``, o ``(B, Sq, H, D)`` in ``q.dtype``
    and lse ``(B, H, Sq)`` float32.

    q ``(B, Sq, H, D)``, k/v ``(B, Sk, K, D)``, one dtype (float32 or
    bfloat16), contiguous, on one CUDA device; ``D <= 256`` a multiple of 8;
    scale ``1/sqrt(D)``. bfloat16 runs on the tensor cores at every D,
    float32 on the CUDA cores. Raises on anything the kernel does not take
    and when the launch fails.
    """
    global launches_fwd, launches_fwd_mma
    _check({"q": q, "k": k, "v": v}, q, k)
    _check_like("v", v, k)
    if k.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype ({q.dtype}, {k.dtype})")
    w = _window(window)
    lib = _load()
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route = ctypes.c_int(-1)      # set by the C entry to the kernel it ran
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, sk, h, kh, d, int(causal), w,
            1.0 / math.sqrt(d), _DTYPES[q.dtype], stream, ctypes.byref(route))
    _raise_on(lib, err, "forward")
    launches_fwd += 1
    launches_fwd_mma += int(route.value == 1)
    return o, lse


def _aligned(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (a view
    at an odd offset): the tensor-core kernels load rows 16 bytes at a
    time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int | None = None):
    """Launch the backward: ``(dq, dk, dv)`` in the dtype of q.

    ``o`` and ``lse`` are the forward's outputs and ``do`` the gradient of
    ``o``; all as in :func:`flash_attention_fwd_cuda` (``D <= 256``; at D
    256 float32 runs its own two kernels with one staging tile).
    ``delta = rowsum(do * o)`` (float32, ``(B, H, Sq)``) is the kernels'
    scratch: a pre-pass kernel writes it before the dK/dV and dQ kernels
    read it (``_flash_bwd`` computes it outside its tile loops too). Each
    KV head's gradient is summed over its query heads in float32: inside
    the dK/dV kernel, or at bf16 D 256 with H > K from a float32 workspace
    of per-head shares (``(2, B, Sk, H, D)``, dK's then dV's), in head
    order, by a second kernel.
    """
    global launches_bwd, launches_bwd_d256
    _check({"q": q, "k": k, "v": v, "o": o, "lse": lse, "do": do}, q, k)
    _check_like("v", v, k)
    _check_like("o", o, q)
    _check_like("do", do, q)
    _check_rows("lse", lse, q)
    if k.dtype != q.dtype:
        raise ValueError(f"q, k and v must share a dtype ({q.dtype}, {k.dtype})")
    w = _window(window)
    lib = _load()
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = None
    if q.dtype == torch.bfloat16 and d > 128 and h > kh:
        ws = torch.empty((2, b, sk, h, d), dtype=torch.float32,
                         device=q.device)
    route = ctypes.c_int(-1)      # set by the C entry to the route it ran
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), None if ws is None else ws.data_ptr(),
            b, sq, sk, h, kh, d, int(causal), w, 1.0 / math.sqrt(d),
            _DTYPES[q.dtype], stream, ctypes.byref(route))
    _raise_on(lib, err, "backward")
    launches_bwd += 1
    launches_bwd_d256 += int(route.value == 2)
    return dq, dk, dv
