#!/usr/bin/env python3
"""Time variants of the SSD backward's row pass on the card.

    python3 tools/ssd_bwd_variants.py

Builds this checkout's ``ssd_chunk_scan.cu`` four ways, by editing a copy
of the source under ``build/`` (the library of each keyed by its content):
as it is; with the backward's state kernel returning before its pass
along the rows (its outputs are then wrong: the variant only times the
rest); and with ``kTbPassGroup`` 4 and 16 (the chunk states each chain of
the pass loads at once). Prints each variant's ``-Xptxas -v`` registers
and spills of the state kernel, then times one backward call at
mamba2-370m's training microbatch (``chip_smoke.M2_TRAIN_SSD``, the inputs
of ``tools/ssd_timing.py --backward``) with CUDA events and its kernels'
device times from the profiler, the variants in turns (each twice,
forwards then backwards), and whether each gives the bits of the source
as it is. Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = pathlib.Path(__file__).resolve().parents[1]
GROUP = "constexpr int kTbPassGroup = 8;"
# the end of the backward's state kernel, where its last block starts the pass
PASS = "  if (!last) return;\n  __threadfence();\n  const int PN = P * N;"


def variants(src: str) -> dict[str, str]:
    """The four sources, by name."""
    assert src.count(GROUP) == 1 and src.count(PASS) == 2, "source changed"
    at = src.rindex(PASS)          # the backward's, after the forward's
    return {
        "as_is": src,
        "no_pass": src[:at] + "  return;\n  const int PN = P * N;"
                   + src[at + len(PASS):],
        "pass_group_4": src.replace(GROUP, GROUP.replace("8", "4")),
        "pass_group_16": src.replace(GROUP, GROUP.replace("8", "16")),
    }


def main() -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    import torch

    if not torch.cuda.is_available():
        print("ssd_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build as _build
    from repro_torch.kernels.ssd import kernel

    print(cs.card_line(), flush=True)
    root = HERE / "build" / "ssd_bwd_variants"
    paths = {}
    for name, text in variants(kernel._SRC.read_text()).items():
        path = root / name / "ssd_chunk_scan.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        libs = dict(zip(paths, pool.map(
            lambda p: _build.build(p, "ssd_chunk_scan", p.parent / "build"),
            paths.values())))
    for name, lib in libs.items():
        print(name, cs.ptxas_report(lib, r"ssd_bwd_tc_state_kernel"))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    b, s, h, p, n, _ = cs.M2_TRAIN_SSD
    x, _, B, C = cs.ssd_inputs(torch, gen, b, s, h, p, n,
                               bc_dtype=torch.bfloat16, heads_share_bc=True)
    dA = cs.model_decay(torch, gen, b, s, h)
    dy = torch.randn(x.shape, generator=gen, device="cuda") * 0.5
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda") * 0.1
    first = None
    order = list(paths) + list(paths)[::-1]
    for name in order:
        kernel._SRC, kernel._BUILD_DIR = paths[name], paths[name].parent / "build"
        kernel._lib = None
        got = kernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
        if first is None:
            first = got
        same = all(torch.equal(u, v) for u, v in zip(got, first))
        ms = cs.time_ms(torch, lambda i: kernel.ssd_bwd_cuda(x, dA, B, C, dy,
                                                             dst),
                        1, inner=5, reps=7)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
            torch.cuda.synchronize()
        parts = {cs.kernel_name(ev.key): cs.dev_us(ev) / ev.count / 1e3
                 for ev in prof.key_averages() if "ssd_bwd" in ev.key}
        print(f"{name}: {ms:.4f} ms a call; the bits of as_is {same}; device "
              f"ms a call " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in parts.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
