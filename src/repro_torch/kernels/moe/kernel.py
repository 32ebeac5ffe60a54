"""The grouped (per-expert) matmul kernels for Hopper: plan, build, bind,
launch.

Replaces the Pallas TPU kernel ``grouped_matmul``
(``src/repro/kernels/moe/kernel.py:38``, body ``_gmm_kernel``). The kernels
are CUDA C++ in ``csrc/grouped_matmul.cu`` (its header gives the design).
:func:`plan` picks one of four routes by dtype, shape and alignment alone:

- ``"wgmma"``: bf16 at C > 16 (grok-1's prefill), ``gmm_wgmma_kernel``:
  Hopper's warpgroup MMA fed by TMA, one producer and two consumer
  warpgroups, one persistent block an SM walking 128 x 256 output tiles;
- ``"splitd"``: bf16 at C <= 16 (the decode step), ``gmm_splitd_kernel``:
  16 x 128 ``mma.sync`` tiles streaming w through a ``cp.async`` ring, D
  split into S chunks so that enough blocks stream the weights; with S > 1
  float32 partials go to a workspace and ``gmm_splitd_reduce_kernel`` adds
  them in split order and rounds once;
- ``"mma"``: bf16 that TMA cannot take (a base off 16 bytes, D or F not a
  multiple of 8), ``gmm_bf16_kernel``: 128 x 128 ``mma.sync`` tiles;
- ``"f32"``: float32, ``gmm_f32_kernel``: float32 FMAs on the CUDA cores.

On grok-1's main path the prefill's calls are bound by the tensor cores
(8.34 ms a call at 989 TFLOP/s) and the decode step's by the weights' bytes
(0.96 ms at 3.35 TB/s). The source is compiled with ``nvcc`` for ``sm_90a``
on first use into the ``build/`` directory beside this file (ignored by
git) by :mod:`repro_torch.kernels.build`, and bound with ``ctypes``.
Nothing is built or loaded when this module is imported.

:func:`grouped_matmul_cuda` is the launching wrapper: it checks device,
dtype, shape and contiguity, plans the route, allocates the output (and
the split-D workspace) with ``torch.empty``, launches on PyTorch's current
stream and raises if the launch fails; there is no fallback to another
route. It counts its calls in the module-level integer :data:`launches`,
and of those the ones the C entry reports it ran on the wgmma and the
split-D kernels in :data:`launches_wgmma` and :data:`launches_splitd`.
Unlike the Pallas wrapper it takes any ``C, D, F >= 1``.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "grouped_matmul.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

# calls of the CUDA kernels since the count was last set to 0, and of those
# the ones the C entry reports it ran on the wgmma and the split-D routes
launches = 0
launches_wgmma = 0
launches_splitd = 0

# the C entry's route codes
ROUTES = {"f32": 0, "mma": 1, "wgmma": 2, "splitd": 3}

_lib = None
_lib_lock = threading.Lock()


def build() -> pathlib.Path:
    """Compile the kernels (once per source content) and return the library
    path; see :func:`repro_torch.kernels.build.build`."""
    return _build.build(_SRC, "grouped_matmul", _BUILD_DIR)


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.grouped_matmul.argtypes = ([ptr] * 4 + [i32] * 6
                                           + [ptr, ctypes.POINTER(i32)])
            lib.grouped_matmul.restype = i32
            lib.grouped_matmul_error_string.argtypes = [i32]
            lib.grouped_matmul_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


_TYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2 ** 31 - 1
# the largest F each route takes: F tiles on a 65535-long grid axis (f32's
# 64 columns a block, mma's 128), or no grid limit (wgmma walks tiles,
# split D puts F tiles on the grid's x axis)
_F_MAX = {"f32": 64 * 65535, "mma": 128 * 65535, "wgmma": _I32_MAX,
          "splitd": _I32_MAX}

_SPLITD_MAX_C = 16       # the split-D tile's rows
_SPLITD_N = 128          # its columns
_SPLITD_STEP = 64        # its D step; a chunk is a multiple of it
# blocks the split-D route aims for: about 4 waves of 2 blocks on each of
# the H100's 132 SMs
_SPLITD_BLOCKS = 1024
_SPLITD_MIN_CHUNK = 512  # D rows a split sums at the least


class Plan(NamedTuple):
    """The route of one call: its name (a key of :data:`ROUTES`), the
    number of D chunks S (1 but on the split-D route) and the bytes of
    float32 workspace its partials need (0 when S is 1)."""
    route: str
    splits: int
    workspace_bytes: int


def _chunk(d: int, s: int) -> int:
    """D rows a split sums: ceil(d / s) rounded up to the split-D step (the
    C entry's ``split_chunk``)."""
    per = -(-d // s)
    return -(-per // _SPLITD_STEP) * _SPLITD_STEP


def plan(e: int, c: int, d: int, f: int, dtype, x_aligned: bool = True,
         w_aligned: bool = True) -> Plan:
    """The route for x ``(e, c, d)`` @ w ``(e, d, f)`` of ``dtype``, from
    the shape, the dtype and whether each base address is 16-byte aligned;
    needs no card.

    float32 takes the CUDA cores. bf16 takes TMA's routes only where TMA
    can read it (both bases 16-byte aligned, D and F multiples of 8), else
    the ``mma.sync`` route; of TMA's, C <= 16 splits D (the decode step),
    larger C takes wgmma. S doubles from 1 while E x F tiles x S is short
    of about 4 waves of blocks and each chunk stays at least 512 deep."""
    if dtype == torch.float32:
        return Plan("f32", 1, 0)
    if not (x_aligned and w_aligned and d % 8 == 0 and f % 8 == 0):
        return Plan("mma", 1, 0)
    if c > _SPLITD_MAX_C:
        return Plan("wgmma", 1, 0)
    tiles = e * -(-f // _SPLITD_N)
    s = 1
    while tiles * s < _SPLITD_BLOCKS and _chunk(d, 2 * s) >= _SPLITD_MIN_CHUNK:
        s *= 2
    s = -(-d // _chunk(d, s))          # no empty last chunk
    return Plan("splitd", s, s * e * c * f * 4 if s > 1 else 0)


def _check(x: torch.Tensor, w: torch.Tensor) -> Plan:
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x (E, C, D) and w (E, D, F); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    if not (1 <= e <= 65535 and 1 <= c <= _I32_MAX and 1 <= d <= _I32_MAX
            and 1 <= f <= _I32_MAX):
        raise ValueError(f"want 1 <= E <= 65535 and 1 <= C, D, F <= "
                         f"{_I32_MAX}; got x {tuple(x.shape)}, w "
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
    p = plan(e, c, d, f, x.dtype, x.data_ptr() % 16 == 0,
             w.data_ptr() % 16 == 0)
    if f > _F_MAX[p.route]:
        raise ValueError(f"want F <= {_F_MAX[p.route]} on the {p.route} "
                         f"route; got w {tuple(w.shape)}")
    return p


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the planned kernel: ``y (E, C, F)`` in x's dtype, contiguous,
    with ``y[e] = x[e] @ w[e]``, every product exact and summed in float32,
    one rounding at the end.

    x ``(E, C, D)`` and w ``(E, D, F)``: contiguous, one dtype (float32 or
    bfloat16), on one CUDA device. Raises on anything the kernels do not
    take and when the launch fails.
    """
    global launches, launches_wgmma, launches_splitd
    p = _check(x, w)
    lib = _load()
    e, c, d = x.shape
    f = w.shape[2]
    y = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    ws = (torch.empty(p.workspace_bytes // 4, dtype=torch.float32,
                      device=x.device) if p.workspace_bytes else None)
    ran = ctypes.c_int(-1)        # set by the C entry to the route it ran
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                 None if ws is None else ws.data_ptr(),
                                 ROUTES[p.route], e, c, d, f, p.splits,
                                 stream, ctypes.byref(ran))
    if err != 0:
        msg = lib.grouped_matmul_error_string(err).decode()
        raise RuntimeError(f"grouped matmul kernel launch failed on the "
                           f"{p.route} route: {msg}")
    launches += 1
    launches_wgmma += int(ran.value == ROUTES["wgmma"])
    launches_splitd += int(ran.value == ROUTES["splitd"])
    return y
