"""The paged decode attention kernel for Hopper: plan, build, bind, launch.

Replaces the Pallas TPU kernel ``paged_attention_kernel``
(``src/repro/kernels/paged_attention/kernel.py:105``, body ``_paged_kernel``).
The kernel is CUDA C++ in ``csrc/paged_attention.cu``, a split-KV kernel (its
header comment gives the design and what bounds it): each block covers
``split_len`` positions of one slot for one KV head, puts all of their K and
V rows in flight at once, and the last block of a slot merges the splits'
partial softmax states in split order, in the same launch. It is compiled
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C entry on
first use, into the ``build/`` directory beside this file (ignored by git;
the shared recipe is :mod:`repro_torch.kernels.build`), and bound with
``ctypes``. Nothing is built or loaded when this module is imported.

:func:`plan` picks the split length, the grid's split count, the width of
each load and the workspace from shapes alone, with no card.
:func:`paged_attention_cuda` is the launching wrapper: it checks device,
dtype, shape and contiguity, allocates the output and the float32 workspace,
launches on PyTorch's current stream, raises if the launch fails, and counts
its launches in the module-level integer :data:`launches`. The merge's
per-(slot, KV head) counters live in one int32 buffer per device, zeroed
once when it is made (:func:`counter_buffer`); every launch leaves it zeroed.
Calls that overlap on two streams of one device would share it, so the port
issues them on one stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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
_counters: dict[torch.device, torch.Tensor] = {}

SPLIT_TARGET = 64             # positions a split covers, rounded to pages
MAX_SPLITS = 64               # splits of one slot at most (kMaxSplits)
KV_SMEM_BYTES = 32 * 1024     # shared memory for a tile's K and V rows
MAX_GROUP = 8                 # query heads one block packs (kMaxGroup)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut: ``split_len`` positions a block (a multiple of
    the page size), ``n_split`` splits in the grid (the most a table
    holds), ``vec_bytes`` a load, ``tile`` positions in shared memory at
    once, and the float32 workspace and int32 counters the merge needs
    (none with one split)."""

    split_len: int
    n_split: int
    vec_bytes: int
    tile: int
    work_floats: int
    n_counters: int


@functools.lru_cache(maxsize=256)       # on every call's host path
def plan(b: int, h: int, k: int, d: int, np_: int, ps: int,
         window: int | None, q_dtype: torch.dtype, kv_dtype: torch.dtype,
         align: int = 16) -> Plan:
    """The cut of a call with q (b, h, d), pools (P, ps, k, d), tables
    (b, np_) and ``window``; ``align`` is the largest power of two up to 16
    that divides both pools' addresses.

    The load is 16 bytes where a row's D elements and ``align`` allow it,
    else the widest of 8, 4 or 2 that does. A split covers ``SPLIT_TARGET``
    positions rounded down to whole pages (at least one page), or more
    where the table holds more than ``MAX_SPLITS`` of them, and the grid
    holds as many splits as the longest attended range needs:
    ``ceil(min(np_ * ps, window) / split_len)``. A block holds ``tile``
    positions of its split in shared memory at once.
    """
    if q_dtype not in _DTYPES or kv_dtype not in _DTYPES:
        raise ValueError(f"q and pool must be float32 or bfloat16 (got "
                         f"{q_dtype}, {kv_dtype})")
    elt = kv_dtype.itemsize
    vec = 16
    while vec > elt and ((d * elt) % vec or align % vec):
        vec //= 2
    split_len = ps * max(1, SPLIT_TARGET // ps)
    span = np_ * ps if window is None else min(np_ * ps, window)
    if -(-span // split_len) > MAX_SPLITS:
        split_len = ps * -(-span // (MAX_SPLITS * ps))
    n_split = -(-span // split_len)
    row_bytes = d * elt + vec            # one word of padding a row
    tile = max(1, min(split_len, SPLIT_TARGET, KV_SMEM_BYTES // (2 * row_bytes)))
    if n_split == 1:
        return Plan(split_len, 1, vec, tile, 0, 0)
    g = h // k
    gc = min(g, MAX_GROUP)
    kc = k * -(-g // MAX_GROUP)
    record = -(-gc * (d + 2) // 4) * 4  # m, l and acc of a split, 16-byte aligned
    return Plan(split_len, n_split, vec, tile, b * kc * n_split * record, b * kc)


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
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_float] + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.paged_attention_error_string.argtypes = [ctypes.c_int]
            lib.paged_attention_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def counter_buffer(device: torch.device, n: int = 0) -> torch.Tensor | None:
    """The merge's int32 counters on ``device``, grown to at least ``n``
    (zeroed when made); ``None`` if none was ever asked for there."""
    with _lib_lock:
        buf = _counters.get(device)
        if n and (buf is None or buf.numel() < n):
            buf = torch.zeros(n, dtype=torch.int32, device=device)
            _counters[device] = buf
    return buf


def _alignment(*tensors) -> int:
    """The largest power of two up to 16 dividing every data pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


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
    p = plan(b, h, kh, d, tables.shape[1], ps, window, q.dtype, k_pool.dtype,
             _alignment(k_pool, v_pool))
    out = torch.empty_like(q)
    work = counters = None
    if p.n_split > 1:
        work = torch.empty(p.work_floats, dtype=torch.float32, device=q.device)
        counters = counter_buffer(q.device, p.n_counters)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(),
            None if counters is None else counters.data_ptr(),
            b, h, kh, d, n_pages, ps, tables.shape[1], window or 0,
            float(scale), _DTYPES[q.dtype], _DTYPES[k_pool.dtype],
            p.split_len, p.n_split, p.vec_bytes, p.tile, stream)
    if err != 0:
        msg = lib.paged_attention_error_string(err).decode()
        raise RuntimeError(f"paged attention kernel launch failed: {msg}")
    launches += 1
    return out
