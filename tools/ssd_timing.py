#!/usr/bin/env python3
"""Time the port's SSD chunk scan and mamba2-370m's prefill from any checkout.

    python3 tools/ssd_timing.py [--root DIR] [--prefills N]

Builds the SSD kernel of ``DIR/src/repro_torch`` (default: this checkout)
and times one call at mamba2-370m's prefill shape (``chip_smoke.M2_PREFILL``:
b 8, s 4096, 32 heads, p 64, n 128, chunk 256; x float32, bf16 B and C
shared by the heads, the model's decay; seed 0) with CUDA events, with its
kernels' device times from the profiler; then serves full-width
mamba2-370m through DIR's serve driver (``launch.serve.main``: batch 8, a
4096-token prompt, 2 greedy steps) N times (default 3) and prints each
prefill's time and the peak device memory. The shape, inputs and kernel
timing code are always this checkout's ``chip_smoke.py``, so running it
against two checkouts in one call, in turns, compares two versions on one
card. Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernel is timed (default: this one)")
    ap.add_argument("--prefills", type=int, default=3,
                    help="mamba2-370m prefills to time (default 3)")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path

    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("ssd_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd import kernel
    from repro_torch.launch import serve as launch_serve

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    print(f"{cs.card_line()}; kernel of {pathlib.Path(kernel.__file__).parent}")
    cs.build_all(kernel)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    b, s, h, p, n, chunk = cs.M2_PREFILL
    x, _, B, C = cs.ssd_inputs(torch, gen, b, s, h, p, n,
                               bc_dtype=torch.bfloat16, heads_share_bc=True)
    dA = cs.model_decay(torch, gen, b, s, h)
    ms = cs.time_ms(torch, lambda i: kernel.ssd_cuda(x, dA, B, C, chunk=chunk),
                    1, inner=5, reps=7)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel.ssd_cuda(x, dA, B, C, chunk=chunk)
        torch.cuda.synchronize()
    parts = {cs.kernel_name(ev.key): cs.dev_us(ev) / ev.count / 1e3
             for ev in prof.key_averages() if "ssd" in ev.key}
    print(f"ssd at mamba2-370m's prefill shape: {ms:.4f} ms a call; device "
          f"ms a call " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()),
          flush=True)
    del x, dA, B, C
    torch.cuda.empty_cache()
    argv = ["--arch", "mamba2-370m", "--batch", "8", "--prompt-len", "4096",
            "--steps", "2", "--seed", str(cs.SEED)]
    for i in range(args.prefills):
        run = launch_serve.main(argv)
        print(f"mamba2-370m prefill {i}: {run.prefill_s:.4f} s, peak memory "
              f"{run.peak_bytes} B", flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
