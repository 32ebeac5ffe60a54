#!/usr/bin/env python3
"""Time the port's SSD chunk scan and mamba2-370m's prefill from any checkout.

    python3 tools/ssd_timing.py [--root DIR] [--prefills N]
    python3 tools/ssd_timing.py --backward [--root DIR] [--steps N]

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

With ``--backward`` it times the SSD backward instead, at mamba2-370m's
training microbatch (``chip_smoke.M2_TRAIN_SSD``: b 2, s 4096, 32 heads, p
64, n 128; the same dtypes and decay, dy N(0, 0.5^2), the final state's
gradient N(0, 0.1^2)) with CUDA events and its kernels' device times from
the profiler, then trains full-width mamba2-370m through DIR's training
entry point (``launch.train.main``, ``chip_smoke.M2_TRAIN`` with
``chip_smoke.TRAIN_RECIPE``: 2 microbatches of 2 x 4096 tokens, AdamW) for
N steps (default 4) and prints each step's time, the median of steps 2-N,
its mfu, and one more step under the profiler: device-busy time and the
SSD backward's share of it.
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
    ap.add_argument("--backward", action="store_true",
                    help="time the backward and mamba2-370m's train step")
    ap.add_argument("--steps", type=int, default=4,
                    help="mamba2-370m train steps with --backward (default 4)")
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
    if args.backward:
        return backward(torch, cs, kernel, gen, args.steps)
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


def backward(torch, cs, kernel, gen, steps: int) -> int:
    """The SSD backward at ``M2_TRAIN_SSD`` and ``steps`` mamba2-370m train
    steps (see the module's docstring)."""
    import statistics

    from repro_torch import configs
    from repro_torch.launch import train as launch_train

    b, s, h, p, n, _ = cs.M2_TRAIN_SSD
    x, _, B, C = cs.ssd_inputs(torch, gen, b, s, h, p, n,
                               bc_dtype=torch.bfloat16, heads_share_bc=True)
    dA = cs.model_decay(torch, gen, b, s, h)
    dy = torch.randn(x.shape, generator=gen, device="cuda") * 0.5
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda") * 0.1
    ms = cs.time_ms(torch, lambda i: kernel.ssd_bwd_cuda(x, dA, B, C, dy, dst),
                    1, inner=5, reps=7)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
        torch.cuda.synchronize()
    parts = {cs.kernel_name(ev.key): cs.dev_us(ev) / ev.count / 1e3
             for ev in prof.key_averages() if "ssd_bwd" in ev.key}
    plan = getattr(kernel, "plan_bwd", None)       # absent before the tc route
    route = plan(b, s, h, p, n, B.dtype).route if plan else "fma"
    print(f"ssd backward at mamba2-370m's training microbatch ({route} route): "
          f"{ms:.4f} ms a call; device ms a call "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()), flush=True)
    del x, dA, B, C, dy, dst
    torch.cuda.empty_cache()

    spec, r = cs.M2_TRAIN, cs.TRAIN_RECIPE
    argv = ["--arch", spec["arch"], "--init", spec["init"], "--steps",
            str(steps), "--global-batch", str(r["global_batch"]), "--accum",
            str(spec["accum"]), "--seq", str(r["seq"]), "--lr", str(r["lr"]),
            "--optimizer", "adamw", "--seed", str(cs.SEED)]
    run = launch_train.main(argv)
    cfg = configs.get(spec["arch"])
    tokens = r["global_batch"] * r["seq"]
    steady = statistics.median(run.seconds[1:])
    mfu = 6 * cfg.param_count() * tokens / (steady * cs.BF16_OPS_PER_S)
    batch = run.data.batch_at(steps)
    wall_ms, busy_ms, _, kern = cs.device_profile(
        torch, lambda: run.train_step(run.params, run.opt_state, batch))
    bwd_ms = sum(cs.dev_us(e) for e in kern if "ssd_bwd" in e.key) / 1e3
    print(f"mamba2-370m train: steps "
          + " ".join(f"{t:.4f}" for t in run.seconds)
          + f" s; median of steps 2-{steps} {steady:.4f} s, mfu {mfu:.4f}; a "
          f"profiled step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} "
          f"ms, the SSD backward {bwd_ms:.1f} ms "
          f"({100 * bwd_ms / busy_ms:.1f}% of device time)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
