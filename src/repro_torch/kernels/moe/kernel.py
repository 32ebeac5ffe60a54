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
- ``"f32"``: float32, ``gmm_fma_kernel``: float32 FMAs on the CUDA cores.

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

The backward's two grouped products (no TPU kernel: the reference
differentiates einsums) are :func:`grouped_matmul_dx_cuda` (dx = dy w^T)
and :func:`grouped_matmul_dw_cuda` (dw = x^T dy, a sum over the C rows),
on the routes :func:`plan_bwd` picks: ``"wgmma"`` (bf16 at C > 16 that TMA
can read: the forward's persistent wgmma kernel with the operands' majors
swapped, ``gmm_wgmma_dx_kernel`` and ``gmm_wgmma_dw_kernel``), else the
CUDA cores (the float32 forward's ``gmm_fma_kernel`` with strided reads:
``"f32"`` for float32, ``"bf16"`` for bf16). They count their calls in :data:`launches_bwd`, and of those the
ones the C entry reports on wgmma in :data:`launches_bwd_wgmma`.
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
# calls of the backward's kernels (dx and dw each one), and of those the
# ones the C entry reports it ran on the wgmma route
launches_bwd = 0
launches_bwd_wgmma = 0

# the C entry's route codes, the forward's and the backward's
ROUTES = {"f32": 0, "mma": 1, "wgmma": 2, "splitd": 3}
ROUTES_BWD = {"f32": 0, "wgmma": 2, "bf16": 4}
# the backward's products: dx = dy w^T, dw = x^T dy (the C entry's modes)
MODES_BWD = {"dx": 1, "dw": 2}

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
            lib.grouped_matmul_bwd.argtypes = ([ptr] * 3 + [i32] * 6
                                               + [ptr, ctypes.POINTER(i32)])
            lib.grouped_matmul_bwd.restype = i32
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


def _check_operands(what: str, names, a: torch.Tensor, b: torch.Tensor,
                    e: int, c: int, d: int, f: int) -> None:
    """Raise ``ValueError``, its message led by ``what``, unless E, C, D and
    F lie in the kernels' ranges and operands ``a`` and ``b`` (named by
    ``names``) are contiguous CUDA tensors on a's device, of one dtype,
    float32 or bfloat16. Needs no card."""
    if not (1 <= e <= 65535 and 1 <= min(c, d, f)
            and max(c, d, f) <= _I32_MAX):
        raise ValueError(f"{what}want 1 <= E <= 65535 and 1 <= C, D, F <= "
                         f"{_I32_MAX}; got E {e}, C {c}, D {d}, F {f}")
    for name, t in zip(names, (a, b)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{what}{name} must be a CUDA tensor on "
                             f"{a.device} (got {t.device})")
        if t.dtype not in _TYPES:
            raise ValueError(f"{what}{name} must be float32 or bfloat16 (got "
                             f"{t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{what}{name} must be contiguous (row-major)")
    if b.dtype != a.dtype:
        raise ValueError(f"{what}{names[0]} and {names[1]} must have one "
                         f"dtype (got {a.dtype} and {b.dtype})")


def _check(x: torch.Tensor, w: torch.Tensor) -> Plan:
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"want x (E, C, D) and w (E, D, F); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, c, d = x.shape
    f = w.shape[2]
    _check_operands("", ("x", "w"), x, w, e, c, d, f)
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


# the CUDA-core backward's grid: N tiles of 64 columns on a 65535-long axis
_BWD_N_MAX = 64 * 65535


def plan_bwd(c: int, d: int, f: int, dtype, a_aligned: bool = True,
             b_aligned: bool = True) -> str:
    """The backward's route for x ``(E, c, d)``, w ``(E, d, f)`` and dy
    ``(E, c, f)`` of ``dtype``, from the shape, the dtype and whether the
    two operands' bases are 16-byte aligned; needs no card. ``"wgmma"``
    for bf16 at C > 16 that TMA can read (D and F multiples of 8), else
    the CUDA cores: ``"f32"`` or ``"bf16"`` by dtype."""
    if dtype == torch.float32:
        return "f32"
    if (c > _SPLITD_MAX_C and a_aligned and b_aligned and d % 8 == 0
            and f % 8 == 0):
        return "wgmma"
    return "bf16"


# the backward's operands a, b by product, as its wrappers name them
_BWD_OPERANDS = {"dx": ("dy (E, C, F)", "w (E, D, F)"),
                 "dw": ("x (E, C, D)", "dy (E, C, F)")}


def _launch_bwd(mode: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check, plan and launch one backward product: ``mode`` "dx" with a =
    dy, b = w, or "dw" with a = x, b = dy (:data:`_BWD_OPERANDS`)."""
    global launches_bwd, launches_bwd_wgmma
    dx = mode == "dx"
    if not (a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
            and a.shape[2 if dx else 1] == b.shape[2 if dx else 1]):
        want = " and ".join(_BWD_OPERANDS[mode])
        raise ValueError(f"grouped matmul {mode}: want {want}; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    e, c = a.shape[:2]
    d, f = (b.shape[1], a.shape[2]) if dx else (a.shape[2], b.shape[2])
    _check_operands(f"grouped matmul {mode}: ",
                    [n.split()[0] for n in _BWD_OPERANDS[mode]], a, b,
                    e, c, d, f)
    route = plan_bwd(c, d, f, a.dtype, a.data_ptr() % 16 == 0,
                     b.data_ptr() % 16 == 0)
    n = d if dx else f
    if route != "wgmma" and n > _BWD_N_MAX:
        raise ValueError(f"grouped matmul {mode}: want N <= {_BWD_N_MAX} on "
                         f"the {route} route; got {n}")
    lib = _load()
    out = torch.empty((e, c, d) if dx else (e, d, f), dtype=a.dtype,
                      device=a.device)
    ran = ctypes.c_int(-1)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.grouped_matmul_bwd(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), MODES_BWD[mode],
                                     ROUTES_BWD[route], e, c, d, f, stream,
                                     ctypes.byref(ran))
    if err != 0:
        msg = lib.grouped_matmul_error_string(err).decode()
        raise RuntimeError(f"grouped matmul {mode} kernel launch failed on "
                           f"the {route} route: {msg}")
    launches_bwd += 1
    launches_bwd_wgmma += int(ran.value == ROUTES_BWD["wgmma"])
    return out


def grouped_matmul_dx_cuda(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx ``(E, C, D)`` = dy ``(E, C, F)`` . w ``(E, D, F)``^T in dy's
    dtype, contiguous: every product exact, summed over F in float32, one
    rounding. dy and w contiguous, one dtype (float32 or bfloat16), on one
    CUDA device. Raises on anything the kernels do not take and when the
    launch fails."""
    return _launch_bwd("dx", dy, w)


def grouped_matmul_dw_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw ``(E, D, F)`` = x ``(E, C, D)``^T . dy ``(E, C, F)`` in x's
    dtype, contiguous: every product exact, summed over the C rows in
    float32, one rounding. x and dy contiguous, one dtype, on one CUDA
    device. Raises on anything the kernels do not take and when the launch
    fails."""
    return _launch_bwd("dw", x, dy)
