#!/usr/bin/env python3
"""Time the port's flash attention at head dim 256 from any checkout.

    python3 tools/flash_timing.py [--root DIR]
    python3 tools/flash_timing.py --backward [--root DIR] [--steps N]

Builds the flash kernels of ``DIR/src/repro_torch`` (default: this
checkout) and times one bf16 forward at recurrentgemma-2b's prefill shape
(B 8, S 4096, H 10, K 1, D 256, window 2048; seed 0) with CUDA events.

With ``--backward`` it times the bf16 backward instead, at recurrentgemma-2b's
training microbatch (``chip_smoke.RG_TRAIN_ATTN``: B 1) and at the recipe's
microbatch of 2 (``chip_smoke.RG_RECIPE_ATTN``), each with its kernels'
device times from the profiler and their rates in TFLOP/s of the products
each kernel runs (2 D FLOPs a visible pair a product), beside the bound
and SDPA's flash backend on the causal mask alone (a second yardstick: it
does more pairs than the window, which no fused SDPA backend takes); then
trains full-width recurrentgemma-2b through DIR's training entry point
(``launch.train.main``, ``chip_smoke.RG_TRAIN`` with
``chip_smoke.TRAIN_RECIPE``: 4 microbatches of 1 x 4096 tokens, AdamW) for
N steps (default 4; none below 2) and prints each step's time, the median
of steps 2-N, its mfu, and one more step under the profiler: device-busy
time and the flash backward's share of it.

The shapes, inputs and timing code are always this checkout's
``chip_smoke.py``, so running it against two checkouts in one call, in
turns (parent, change, change, parent), compares two versions on one card.
Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]

# products (of 2 D FLOPs a visible pair) each backward kernel runs: the
# D 256 dK/dV kernel S^T, dP^T, P^T dO and dS^T Q as hi + lo; the parent's
# dV pass S^T and P^T dO, its dK pass S^T, dP^T and dS^T Q; the dQ kernel
# S, dP and dS K
PRODUCTS = {"flash_bwd_dkdv_d256_kernel": 6,
            "flash_bwd_dkdv_mma_kernel<256, 16, 1>": 3,
            "flash_bwd_dkdv_mma_kernel<256, 16, 2>": 4,
            "flash_bwd_dq_mma_kernel": 4}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose kernels are timed (default: this one)")
    ap.add_argument("--backward", action="store_true",
                    help="time the backward and recurrentgemma-2b's train step")
    ap.add_argument("--steps", type=int, default=4,
                    help="recurrentgemma-2b train steps with --backward "
                         "(default 4)")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path

    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("flash_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import kernel
    from repro_torch.kernels.rglru import kernel as rkernel

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    print(f"{cs.card_line()}; kernel of {pathlib.Path(kernel.__file__).parent}")
    cs.build_all(kernel, rkernel)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    if args.backward:
        return backward(torch, cs, kernel, gen, args.steps)
    b, s, h, kh, d, win = 8, 4096, 10, 1, 256, 2048
    q, k, v, _ = cs.flash_inputs(torch, gen, b, s, h, kh, d, torch.bfloat16)
    ms = cs.time_ms(torch, lambda i: kernel.flash_attention_fwd_cuda(
        q, k, v, causal=True, window=win), 1, inner=5, reps=7)
    print(f"flash D 256 forward at recurrentgemma-2b's prefill shape: "
          f"{ms:.4f} ms a call", flush=True)
    return 0


def sdpa_causal_bwd(torch, q, k, v, do):
    """SDPA's flash backend on the causal mask alone (the yardstick, never
    called by the port): ``fn`` running the backward of one forward kept
    alive, or None where the backend refuses the call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    h = q.shape[2]
    qs, ks, vs = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dos = do.transpose(1, 2).contiguous()
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            kr, vr = (x.repeat_interleave(h // x.shape[1], dim=1)
                      for x in (ks, vs))
            out = torch.nn.functional.scaled_dot_product_attention(
                qs, kr, vr, is_causal=True)
            torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
        torch.cuda.synchronize()
    except RuntimeError as e:
        print(f"sdpa flash backend refused the call: {e}".splitlines()[0])
        return None
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                       retain_graph=True)


def backward(torch, cs, kernel, gen, steps: int) -> int:
    """The backward at both microbatches and ``steps`` recurrentgemma-2b
    train steps (see the module's docstring)."""
    import statistics

    from repro_torch import configs
    from repro_torch.launch import train as launch_train

    for (b, s, h, kh, d, win), label in (
            (cs.RG_TRAIN_ATTN, "the training microbatch"),
            (cs.RG_RECIPE_ATTN, "the recipe's microbatch")):
        q, k, v, do = cs.flash_inputs(torch, gen, b, s, h, kh, d,
                                      torch.bfloat16)
        o, lse = kernel.flash_attention_fwd_cuda(q, k, v, causal=True,
                                                 window=win)
        call = lambda: kernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                       causal=True, window=win)
        ms = cs.time_ms(torch, lambda i: call(), 1, inner=3, reps=7)
        _, busy_ms, _, kern = cs.device_profile(torch, call, n=3)
        pairs = cs.window_pairs(s, win)
        parts = []
        for e in kern:
            name = cs.kernel_name(e.key)
            n = PRODUCTS.get(name, PRODUCTS.get(name.split("<")[0]))
            t = cs.dev_us(e) / e.count / 1e3
            rate = (f", {n * 2 * d * b * h * pairs / t / 1e9:.1f} TFLOP/s of "
                    f"its {n} products" if n else "")
            parts.append(f"{name} {t:.4f} ms x{e.count // 3}{rate}")
        bound, by = cs.flash_bound_ms(b, s, h, kh, d, 2, pairs, True)
        lib = sdpa_causal_bwd(torch, q, k, v, do)
        lib_ms = (cs.time_ms(torch, lambda i: lib(), 1, inner=3, reps=5)
                  if lib else float("nan"))
        c_pairs = s * (s + 1) // 2
        c_bound, _ = cs.flash_bound_ms(b, s, h, kh, d, 2, c_pairs, True)
        print(f"flash D 256 backward at {label} B={b} S={s} H={h} K={kh} "
              f"window {win} bf16: {ms:.4f} ms a call "
              f"({10 * b * h * d * pairs / ms / 1e9:.1f} TFLOP/s of the "
              f"function's 5 products), device {busy_ms:.4f} ms a call: "
              + "; ".join(parts)
              + f"; bound {bound:.4f} ms ({by}); sdpa flash backend, causal "
              f"mask alone ({c_pairs} pairs a head, not the window's "
              f"{pairs}): {lib_ms:.4f} ms (bound {c_bound:.4f})", flush=True)
        del q, k, v, do, o, lse, lib
        torch.cuda.empty_cache()
    if steps < 2:
        return 0

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
    bwd_ms = sum(cs.dev_us(e) for e in kern if "flash_bwd" in e.key) / 1e3
    print(f"recurrentgemma-2b train: steps "
          + " ".join(f"{t:.4f}" for t in run.seconds)
          + f" s; median of steps 2-{steps} {steady:.4f} s, mfu {mfu:.4f}; a "
          f"profiled step: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} "
          f"ms ({100 * busy_ms / wall_ms:.1f}%), the flash backward "
          f"{bwd_ms:.1f} ms ({100 * bwd_ms / busy_ms:.1f}% of device time)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
