#!/usr/bin/env python3
"""Time the RG-LRU kernels' block shapes on the card, beside two floors.

    python3 tools/rglru_variants.py

Builds, under ``build/rglru_variants/``, a library that includes this
checkout's ``rglru_scan.cu`` and instantiates its forward and backward
kernels at each (lanes a block L, steps a tile T, ring stages NS) of
:data:`VARIANTS` (the first is the one that ships), 16-byte copies, and a
kernel that runs the chain alone (a multiply, then an add, 4096 times from
registers, one warp on each of 80 SMs). Then, at recurrentgemma-2b's
training microbatch (B 1, S 4096, W 2560), the recipe's microbatch (B 2)
and the prefill shape (B 8), times with CUDA events ``torch.add(a, b,
out=y)`` (the forward's bytes with no scan: the practical floor of the
memory) and every variant forward and backward, each checked bit for bit
against the plain versions, with GB/s of the bytes the function must move
(``chip_smoke.rglru_bound``). Needs one CUDA card and ``nvcc``; exits 1
without a card.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
# (L, T, NS): the C entries' (rglru_scan.cu: kLanes, kTile, kStages), then
# shorter tiles and 256-byte rows
VARIANTS = [(32, 128, 3), (32, 64, 4), (64, 64, 4), (64, 64, 3)]


def source(kernel_src: pathlib.Path) -> str:
    """The variants' C entries around an include of the kernels' source."""
    fwd = "\n".join(f"    case {i}: return scan<16, {l}, {t}, {ns}>(a, b, y, "
                    f"h, B, S, W, s);" for i, (l, t, ns) in enumerate(VARIANTS))
    bwd = "\n".join(f"    case {i}: return scan_bwd<16, {l}, {t}, {ns}>(a, y, "
                    f"dy, dh, da, db, B, S, W, s);"
                    for i, (l, t, ns) in enumerate(VARIANTS))
    return f'''#include "{kernel_src}"

__global__ void chain_only(float* out, int S, float a0, float b0) {{
  float h = 0.f, a = a0 + threadIdx.x * 1e-7f;
  for (int t = 0; t < S; t += 16) {{
#pragma unroll
    for (int k = 0; k < 16; ++k) h = __fadd_rn(__fmul_rn(a, h), b0 + k);
  }}
  out[blockIdx.x * blockDim.x + threadIdx.x] = h;
}}

extern "C" int chain_run(float* out, int S, void* st) {{
  chain_only<<<80, 32, 0, (cudaStream_t)st>>>(out, S, 0.5f, 0.25f);
  return (int)cudaGetLastError();
}}

extern "C" int variant_fwd(int v, const float* a, const float* b, float* y,
                           float* h, int B, int S, int W, void* st) {{
  const auto s = (cudaStream_t)st;
  switch (v) {{
{fwd}
  }}
  return -1;
}}

extern "C" int variant_bwd(int v, const float* a, const float* y,
                           const float* dy, const float* dh, float* da,
                           float* db, int B, int S, int W, void* st) {{
  const auto s = (cudaStream_t)st;
  switch (v) {{
{bwd}
  }}
  return -1;
}}
'''


def main() -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    import torch

    if not torch.cuda.is_available():
        print("rglru_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as _build
    from repro_torch.kernels.rglru import kernel, ref

    print(cs.card_line(), flush=True)
    root = HERE / "build" / "rglru_variants"
    root.mkdir(parents=True, exist_ok=True)
    src = root / "variants.cu"
    src.write_text(source(kernel._SRC))
    lib_path = root / "librglru_variants.so"
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), str(src)],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.chain_run.argtypes = [ptr, i32, ptr]
    lib.variant_fwd.argtypes = [i32] + [ptr] * 4 + [i32] * 3 + [ptr]
    lib.variant_bwd.argtypes = [i32] + [ptr] * 6 + [i32] * 3 + [ptr]
    stream = torch.cuda.current_stream().cuda_stream

    s, w = cs.RG_TRAIN_SCAN[1:]
    sink = torch.empty(80 * 32, device="cuda")
    ms = cs.time_ms(torch, lambda i: lib.chain_run(sink.data_ptr(), s, stream),
                    1, inner=20, reps=7)
    print(f"the chain alone, {s} steps from registers: {ms:.4f} ms, "
          f"{ms * 1e6 / s:.2f} ns a step", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for b in (1, 2, 8):
        a, bb = cs.rglru_inputs(torch, gen, b, s, w)
        want_y, want_h = ref.rglru(a, bb)
        dy = torch.randn(a.shape, generator=gen, device="cuda")
        dh = torch.randn((b, w), generator=gen, device="cuda")
        want_a, want_b = ref.rglru_bwd(a, want_y, dy, dh)
        y, h = torch.empty_like(a), torch.empty((b, w), device="cuda")
        da, db = torch.empty_like(a), torch.empty_like(a)
        moved = cs.rglru_bound(b, s, w)[0]
        ms = cs.time_ms(torch, lambda i: torch.add(a, bb, out=y), 1,
                        inner=20, reps=7)
        print(f"B {b}: torch.add(a, b, out=y), the forward's {moved} bytes: "
              f"{ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s)", flush=True)
        for kind in ("forward", "backward"):
            moved = cs.rglru_bound(b, s, w, kind == "backward")[0]
            rows = []
            for v, (l, t, ns) in enumerate(VARIANTS):
                if kind == "forward":
                    call = lambda: lib.variant_fwd(
                        v, a.data_ptr(), bb.data_ptr(), y.data_ptr(),
                        h.data_ptr(), b, s, w, stream)
                    got, want = (y, h), (want_y, want_h)
                else:
                    call = lambda: lib.variant_bwd(
                        v, a.data_ptr(), want_y.data_ptr(), dy.data_ptr(),
                        dh.data_ptr(), da.data_ptr(), db.data_ptr(), b, s, w,
                        stream)
                    got, want = (da, db), (want_a, want_b)
                if call() != 0:
                    raise RuntimeError(f"variant {(l, t, ns)} did not launch")
                torch.cuda.synchronize()
                exact = all(torch.equal(g, x) for g, x in zip(got, want))
                ms = cs.time_ms(torch, lambda i: call(), 1, inner=20, reps=7)
                rows.append((ms, l, t, ns, exact))
            for ms, l, t, ns, exact in sorted(rows):
                mark = " (ships)" if (l, t, ns) == VARIANTS[0] else ""
                print(f"  {kind} L {l} T {t} NS {ns}{mark}: {ms:.4f} ms "
                      f"({moved / ms / 1e6:.0f} GB/s, "
                      f"{-(-w // l) * b} blocks), bit for bit {exact}",
                      flush=True)
        del a, bb, y, h, dy, dh, da, db, want_y, want_h, want_a, want_b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
