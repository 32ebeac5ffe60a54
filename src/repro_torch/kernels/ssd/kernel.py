"""The Mamba-2 SSD chunk-scan kernels for Hopper: plan, build, bind, launch.

Replaces the Pallas TPU kernel ``ssd_hm``
(``src/repro/kernels/ssd/kernel.py:67``, body ``_ssd_kernel``). The kernels
are CUDA C++ in ``csrc/ssd_chunk_scan.cu`` (its header gives the design and
what bounds it). :func:`plan` picks one of two routes by dtype and shape
alone:

- ``"tc"``: bf16 B and C (the model's types; x float32 or bf16), the tensor
  cores in three launches, the chunks in parallel: each chunk's own state,
  the last chunk of each (b, h) row passing the states along it
  (``ssd_tc_state_kernel``), the chunks' scores C.B^T once for the heads
  that share B and C (``ssd_tc_scores_kernel``), and each chunk's outputs
  (``ssd_tc_out_kernel``). Products with a float32 operand run as TF32
  ``mma.sync`` with that operand split in hi + lo; C.B^T as bf16
  ``mma.sync``. It needs a workspace of float32 chunk states, float64
  cumsums and float32 scores and a zeroed int32 counter a (b, h) row, all
  allocated by the wrapper;
- ``"fma"``: float32 B and C, the first port's kernel: one block per
  (b, h) row, float32 FMAs on the CUDA cores.

The source is compiled with ``nvcc`` for ``sm_90a`` on first use into the
``build/`` directory beside this file (ignored by git) by
:mod:`repro_torch.kernels.build`, and bound with ``ctypes``. Nothing is
built or loaded when this module is imported.

:func:`ssd_cuda` is the launching wrapper: it checks device, dtype, shape
and strides, plans the route, allocates the outputs (and the tc route's
workspace) with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch fails; there is no fallback from one route to the
other. It counts its calls in the module-level integer :data:`launches`,
and of those the ones the C entry reports it ran on the tc route in
:data:`launches_tc`. Unlike the Pallas wrapper it takes the model's layout
through strides (no head-major copy; B and C may be broadcast over heads
with stride 0) and any ``S >= 1``.

:func:`ssd_bwd_cuda` launches the backward of the scan (no TPU kernel
computes it: the reference differentiates ``ssd_chunked`` with
``jax.grad``), in chunks of its own (:data:`BWD_CHUNK`), on a route of its
own picked by :func:`plan_bwd` from B's dtype alone: ``"tc"`` (bf16 B and
C) two launches on the tensor cores, each chunk's state and state
gradient with the pass along each (b, h) row fused in
(``ssd_bwd_tc_state_kernel``), then each chunk's gradients
(``ssd_bwd_tc_grad_kernel``); ``"fma"`` (float32 B and C) the first
backward's three kernels on the CUDA cores. It counts its calls in
:data:`launches_bwd`, and of those the ones the C entry reports on the tc
route in :data:`launches_bwd_tc`.
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_chunk_scan.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024      # the kernel's tile limits

# calls of the CUDA kernels since the count was last set to 0, and of those
# the ones the C entry reports it ran on the tc route; calls of the
# backward, and of those the ones on its tc route
launches = 0
launches_tc = 0
launches_bwd = 0
launches_bwd_tc = 0
BWD_CHUNK = 64               # the backward kernels' own chunk

# the C entry's route codes
ROUTES = {"fma": 0, "tc": 1}

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
            lib.ssd_chunk_scan.argtypes = ([ptr] * 10 + [i32] * 13
                                           + [i64] * 12
                                           + [ptr, ctypes.POINTER(i32)])
            lib.ssd_chunk_scan.restype = i32
            lib.ssd_chunk_scan_bwd.argtypes = ([ptr] * 14 + [i32] * 12
                                               + [i64] * 12
                                               + [ptr, ctypes.POINTER(i32)])
            lib.ssd_chunk_scan_bwd.restype = i32
            lib.ssd_chunk_scan_bwd_smem.argtypes = [i32]
            lib.ssd_chunk_scan_bwd_smem.restype = i32
            lib.ssd_chunk_scan_smem.argtypes = [i32] * 3
            lib.ssd_chunk_scan_smem.restype = i32
            lib.ssd_chunk_scan_error_string.argtypes = [i32]
            lib.ssd_chunk_scan_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class Plan(NamedTuple):
    """The route of one call: its name (a key of :data:`ROUTES`), the chunk
    length Q = min(chunk, s), the number of chunks ceil(s / Q), the B/C
    heads whose scores the tc route computes (1 where the heads share B and
    C) and the bytes of workspace it needs (float32 chunk states b h nc P N,
    float64 cumsums b h nc Q and float32 scores b heads nc q q, q = Q
    rounded up to 64; 0 on the fma route)."""
    route: str
    chunk: int
    n_chunks: int
    bc_heads: int
    workspace_bytes: int


def plan(b: int, s: int, h: int, p: int, n: int, chunk: int, x_dtype,
         bc_dtype, bc_heads: int | None = None) -> Plan:
    """The route for x ``(b, s, h, p)`` of ``x_dtype`` and B, C ``(b, s, h,
    n)`` of ``bc_dtype`` in chunks of ``min(chunk, s)``, B and C holding
    ``bc_heads`` distinct heads (1 where they are expanded over h with
    stride 0, else ``h``, the default); needs no card. bf16 B and C take
    the tensor cores, float32 B and C the CUDA cores."""
    q = min(chunk, s)
    nc = -(-s // q)
    heads = h if bc_heads is None else bc_heads
    if heads not in (1, h):
        raise ValueError(f"bc_heads {bc_heads} is neither 1 nor h = {h}")
    if bc_dtype == torch.bfloat16:
        q_pad = -(-q // 64) * 64
        return Plan("tc", q, nc, heads, b * h * nc * (p * n * 4 + q * 8)
                    + b * heads * nc * q_pad * q_pad * 4)
    return Plan("fma", q, nc, heads, 0)


def plan_bwd(b: int, s: int, h: int, p: int, n: int, bc_dtype) -> Plan:
    """The backward's route for the same shapes, by B's and C's dtype alone
    (bf16: ``"tc"``, float32: ``"fma"``), in chunks of :data:`BWD_CHUNK`;
    needs no card. The workspace: float32 chunk states and state gradients
    (b h nc p n each), each chunk's decay exp(a_end) (b h nc float32), and
    on the tc route the rows' int32 counters (b h)."""
    nc = -(-s // BWD_CHUNK)
    route = "tc" if bc_dtype == torch.bfloat16 else "fma"
    ws = 2 * b * h * nc * p * n * 4 + b * h * nc * 4
    return Plan(route, BWD_CHUNK, nc, h, ws + (b * h * 4 if route == "tc" else 0))


def smem_bytes(kernel: str, x_dtype, chunk: int) -> int:
    """Dynamic shared memory a block of the tc route's ``"state"`` or
    ``"out"`` kernel takes at chunk length ``chunk``, or of the backward's
    ``"bwd_state"`` or ``"bwd_grad"`` kernel (which take any x dtype and
    chunk alike) (builds the library)."""
    if kernel.startswith("bwd_"):
        return _load().ssd_chunk_scan_bwd_smem(("bwd_state", "bwd_grad")
                                               .index(kernel))
    return _load().ssd_chunk_scan_smem(("state", "out").index(kernel),
                                       int(x_dtype == torch.bfloat16), chunk)


_TYPES = (torch.float32, torch.bfloat16)


def _check(x, dA, B, C, chunk) -> Plan:
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
    shared = h == 1 or (B.stride(2) == 0 and C.stride(2) == 0)
    pl = plan(b, s, h, p, n, chunk, x.dtype, B.dtype, 1 if shared else h)
    # the tc route's largest grid: a block per 64 rows of every chunk, or
    # per 256 state entries of every (b, h)
    blocks = b * h * max(pl.n_chunks * -(-pl.chunk // 64), -(-p * n // 256))
    if blocks >= 2 ** 31:
        raise ValueError(f"b * h = {b * h} at {pl.n_chunks} chunks of "
                         f"{pl.chunk} and p * n = {p * n} exceeds the "
                         f"kernels' grid")
    return pl


def _copy_width(t: torch.Tensor) -> int:
    """The widest copy (16, 8, 4 or 2 bytes) that divides t's base address,
    its strides over (b, s, h) and its rows' bytes: every row of a tile is
    then whole copies."""
    elt = t.element_size()
    g = t.data_ptr()
    for st in (*t.stride()[:3], t.shape[3]):
        g = math.gcd(g, st * elt)
    return next(v for v in (16, 8, 4, 2) if g % v == 0)


def ssd_cuda(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the planned kernels: ``(y (b, s, h, p) in x's dtype, state
    (b, h, p, n) float32)``, the state starting at 0, chunks of
    ``min(chunk, s)``.

    x ``(b, s, h, p)``, B and C ``(b, s, h, n)``: float32 or bfloat16, any
    non-negative strides with the last dimension contiguous (B and C may be
    expanded over h); dA ``(b, s, h)`` float32, any strides; all on one
    CUDA device. Raises on anything the kernels do not take and when the
    launch fails.
    """
    global launches, launches_tc
    pl = _check(x, dA, B, C, chunk)
    lib = _load()
    b, s, h, p = x.shape
    n = B.shape[3]
    dev = x.device
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    ws_state = ws_acs = ws_g = counters = None
    if pl.route == "tc":
        q_pad = -(-pl.chunk // 64) * 64
        ws_state = torch.empty(b * h * pl.n_chunks * p * n, dtype=torch.float32,
                               device=dev)
        ws_acs = torch.empty(b * h * pl.n_chunks * pl.chunk,
                             dtype=torch.float64, device=dev)
        ws_g = torch.empty(b * pl.bc_heads * pl.n_chunks * q_pad * q_pad,
                           dtype=torch.float32, device=dev)
        # the chunks done of each (b, h) row; the kernel leaves them at 0
        counters = torch.zeros(b * h, dtype=torch.int32, device=dev)
    strides = [*x.stride()[:3], *dA.stride(), *B.stride()[:3], *C.stride()[:3]]
    ran = ctypes.c_int(-1)        # set by the C entry to the route it ran
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_scan(
            x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), state.data_ptr(),
            None if ws_state is None else ws_state.data_ptr(),
            None if ws_acs is None else ws_acs.data_ptr(),
            None if ws_g is None else ws_g.data_ptr(),
            None if counters is None else counters.data_ptr(), ROUTES[pl.route],
            int(x.dtype == torch.bfloat16), int(B.dtype == torch.bfloat16),
            b, s, h, pl.bc_heads, p, n, pl.chunk, _copy_width(x), _copy_width(B),
            _copy_width(C), *strides, stream, ctypes.byref(ran))
    if err != 0:
        msg = lib.ssd_chunk_scan_error_string(err).decode()
        raise RuntimeError(f"SSD chunk-scan kernel launch failed on the "
                           f"{pl.route} route: {msg}")
    launches += 1
    launches_tc += int(ran.value == ROUTES["tc"])
    return y, state


def ssd_bwd_cuda(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, dy: torch.Tensor, dstate: torch.Tensor, *,
                 counters: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """Launch the backward: ``(dx, ddA, dB, dC)``, the gradients of
    :func:`ssd_cuda`'s ``(y, state)`` (the state starting at 0) for the
    output gradients ``dy`` (b, s, h, p) of y and ``dstate`` (b, h, p, n)
    float32 of the final state. The function does not depend on the
    forward's chunk: the kernels take chunks of :data:`BWD_CHUNK`, on the
    route :func:`plan_bwd` names (no fallback from one to the other).

    x, dA, B and C as :func:`ssd_cuda` takes them (B and C may be expanded
    over h with stride 0); dy in x's dtype. dx comes back in x's dtype,
    ddA float32 (b, s, h), dB and dC float32 per head (b, s, h, n): a caller
    whose B and C are shared by the heads sums them over h (autograd's
    expand does). ``counters``: the tc route's int32 row counters (b h,
    all zero; the kernel leaves them at zero), allocated zeroed for the
    call when None. Raises on anything the kernels do not take and when a
    launch fails.
    """
    global launches_bwd, launches_bwd_tc
    _check(x, dA, B, C, BWD_CHUNK)
    b, s, h, p = x.shape
    n = B.shape[3]
    dev = x.device
    if b * h > 65535:
        raise ValueError(f"b * h = {b * h} exceeds the backward's grid")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != dev:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype} (got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device})")
    if tuple(dstate.shape) != (b, h, p, n) or dstate.dtype != torch.float32 \
            or dstate.device != dev:
        raise ValueError(f"dstate must be ({b}, {h}, {p}, {n}) float32 on "
                         f"{dev} (got {tuple(dstate.shape)} {dstate.dtype})")
    pl = plan_bwd(b, s, h, p, n, B.dtype)
    lib = _load()
    dy, dstate = dy.contiguous(), dstate.contiguous()
    nc = pl.n_chunks
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddA = torch.empty((b, s, h), dtype=torch.float32, device=dev)
    dB = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    dC = torch.empty_like(dB)
    ws_u = torch.empty(b * h * nc * p * n, dtype=torch.float32, device=dev)
    ws_d = torch.empty_like(ws_u)
    ws_a = torch.empty(b * h * nc, dtype=torch.float32, device=dev)
    if pl.route != "tc":
        counters = None
    elif counters is None:     # the chunks done of each (b, h) row
        counters = torch.zeros(b * h, dtype=torch.int32, device=dev)
    elif (counters.dtype != torch.int32 or counters.device != dev
          or counters.numel() != b * h or not counters.is_contiguous()):
        raise ValueError(f"counters must be {b * h} contiguous int32 on "
                         f"{dev}")
    strides = [*x.stride()[:3], *dA.stride(), *B.stride()[:3], *C.stride()[:3]]
    ran = ctypes.c_int(-1)        # set by the C entry to the route it ran
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ssd_chunk_scan_bwd(
            x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            dy.data_ptr(), dstate.data_ptr(), dx.data_ptr(), ddA.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), ws_u.data_ptr(), ws_d.data_ptr(),
            ws_a.data_ptr(), None if counters is None else counters.data_ptr(),
            ROUTES[pl.route], int(x.dtype == torch.bfloat16),
            int(B.dtype == torch.bfloat16), b, s, h, p, n, _copy_width(x),
            _copy_width(B), _copy_width(C), _copy_width(dy), *strides, stream,
            ctypes.byref(ran))
    if err != 0:
        msg = lib.ssd_chunk_scan_error_string(err).decode()
        raise RuntimeError(f"SSD chunk-scan backward launch failed on the "
                           f"{pl.route} route: {msg}")
    launches_bwd += 1
    launches_bwd_tc += int(ran.value == ROUTES["tc"])
    return dx, ddA, dB, dC
