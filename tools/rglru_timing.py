#!/usr/bin/env python3
"""Time the port's RG-LRU scan and its backward from any checkout.

    python3 tools/rglru_timing.py [--root DIR] [--steps N] [--serve]

Builds the RG-LRU kernels of ``DIR/src/repro_torch`` (default: this
checkout) and times the forward (``rglru_scan_cuda``) at recurrentgemma-2b's
training microbatch (``chip_smoke.RG_TRAIN_SCAN``, B 1), the recipe's
microbatch of 2 (``chip_smoke.RG_RECIPE_SCAN``) and the prefill shape
(``chip_smoke.RG_PREFILL``, B 8), and the backward (``rglru_scan_bwd_cuda``)
at the first two: CUDA events over back-to-back calls and one call's device
time from the profiler, each with its rate in GB/s of the bytes the
function must move (each input read once, each output written once) and
its bound at 3.35 TB/s (``chip_smoke.rglru_bound``). Inputs come from
``chip_smoke.rglru_inputs`` with seed 0.

Then it trains full-width recurrentgemma-2b through DIR's training entry
point (``launch.train.main``, ``chip_smoke.RG_TRAIN`` with
``chip_smoke.TRAIN_RECIPE``: 4 microbatches of 1 x 4096 tokens, AdamW) for
N steps (default 4; none below 2) and prints each step's time, the median
of steps 2-N, its mfu, and one more step under the profiler: wall and
device-busy time and the share of the ``rglru_scan*`` kernels.

With ``--serve`` it first serves full-width recurrentgemma-2b through DIR's
serve driver (``launch.serve.main``, ``chip_smoke.RG_SERVE``: batch 8, a
4096-token prompt, 64 greedy steps) and prints the driver's prefill time
(its first call), its median decode step, and three more prefills of the
same prompt, each timed on the host clock from a synchronised start to a
synchronised end.

The shapes, inputs and timing code are always this checkout's
``chip_smoke.py``, so running it against two checkouts in one call, in
turns (parent, change, change, parent), compares two versions on one card.
Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernels are timed (default: this one)")
    ap.add_argument("--steps", type=int, default=4,
                    help="recurrentgemma-2b train steps (default 4; below 2 "
                         "none)")
    ap.add_argument("--serve", action="store_true",
                    help="also time recurrentgemma-2b's serve driver")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path

    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("rglru_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.rglru import kernel

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    print(f"{cs.card_line()}; kernel of {pathlib.Path(kernel.__file__).parent}")
    cs.build_all(kernel, fkernel)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for backward, shapes in (
            (False, ((cs.RG_TRAIN_SCAN, "the training microbatch"),
                     (cs.RG_RECIPE_SCAN, "the recipe's microbatch"),
                     (cs.RG_PREFILL, "the prefill shape"))),
            (True, ((cs.RG_TRAIN_SCAN, "the training microbatch"),
                    (cs.RG_RECIPE_SCAN, "the recipe's microbatch")))):
        for (b, s, w), label in shapes:
            time_scan(torch, cs, kernel, gen, b, s, w, label, backward)
    if args.serve:
        serve(torch, cs)
    if args.steps >= 2:
        train(torch, cs, args.steps)
    return 0


def time_scan(torch, cs, kernel, gen, b, s, w, label, backward) -> None:
    """One shape's forward or backward: events, the profiler's device time
    a call, GB/s against the bound."""
    a, bb = cs.rglru_inputs(torch, gen, b, s, w)
    if backward:
        y, _ = kernel.rglru_scan_cuda(a, bb)
        dy = torch.randn(a.shape, generator=gen, device="cuda")
        dh = torch.randn((b, w), generator=gen, device="cuda")
        call = lambda: kernel.rglru_scan_bwd_cuda(a, y, dy, dh)
    else:
        call = lambda: kernel.rglru_scan_cuda(a, bb)
    ms = cs.time_ms(torch, lambda i: call(), 1, inner=20, reps=11)
    _, _, _, kern = cs.device_profile(torch, call, n=5)
    dev = "; ".join(f"{cs.kernel_name(e.key)} {cs.dev_us(e) / e.count / 1e3:.4f}"
                    f" ms x{e.count // 5}" for e in kern)
    moved, t_bytes, t_ops = cs.rglru_bound(b, s, w, backward)
    bound = max(t_bytes, t_ops)
    print(f"rglru {'backward' if backward else 'forward'} at {label} B={b} "
          f"S={s} W={w}: {ms:.4f} ms a call ({moved / ms / 1e6:.1f} GB/s), "
          f"device {dev}; bound {bound:.4f} ms "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}, {moved} "
          f"bytes), {100 * bound / ms:.1f}% of it", flush=True)
    torch.cuda.empty_cache()


def serve(torch, cs) -> None:
    """recurrentgemma-2b through the serve driver, then three more timed
    prefills (see the module's docstring)."""
    import time

    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "recurrentgemma-2b", "--batch",
            str(cs.RG_SERVE["batch"]), "--prompt-len",
            str(cs.RG_SERVE["prompt_len"]), "--steps",
            str(cs.RG_SERVE["steps"]), "--seed", str(cs.SEED)]
    run = launch_serve.main(argv)
    again = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.serve.prefill_fn(run.params, run.prompt)
        torch.cuda.synchronize()
        again.append(time.perf_counter() - t0)
    print(f"recurrentgemma-2b serve: prefill {cs.RG_SERVE['batch']} x "
          f"{cs.RG_SERVE['prompt_len']} tokens {run.prefill_s:.4f} s (the "
          f"driver's first), then " + " ".join(f"{t:.4f}" for t in again)
          + f" s; decode step {statistics.median(run.decode_s) * 1e3:.3f} ms"
          f" (median of {len(run.decode_s)})", flush=True)
    del run
    torch.cuda.empty_cache()


def train(torch, cs, steps: int) -> None:
    """``steps`` full-width recurrentgemma-2b train steps and one profiled
    step (see the module's docstring)."""
    from repro_torch import configs
    from repro_torch.launch import train as launch_train

    spec, r = cs.RG_TRAIN, cs.TRAIN_RECIPE
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
    scan = {}
    for e in kern:
        name = cs.kernel_name(e.key)
        if name.startswith("rglru_scan"):
            scan[name] = (scan.get(name, (0.0, 0))[0] + cs.dev_us(e) / 1e3,
                          scan.get(name, (0.0, 0))[1] + e.count)
    scan_ms = sum(t for t, _ in scan.values())
    print(f"recurrentgemma-2b train: steps "
          + " ".join(f"{t:.4f}" for t in run.seconds)
          + f" s; median of steps 2-{steps} {steady:.4f} s, mfu {mfu:.4f}; a "
          f"profiled step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} "
          f"ms ({100 * busy_ms / wall_ms:.1f}%), the RG-LRU kernels "
          f"{scan_ms:.1f} ms ({100 * scan_ms / busy_ms:.1f}% of device time: "
          + "; ".join(f"{k} {t:.1f} ms x{n}" for k, (t, n) in
                      sorted(scan.items())) + ")", flush=True)


if __name__ == "__main__":
    sys.exit(main())
