"""Training entry point of the port, on one device.

  python -m repro_torch.launch.train --arch granite-3-2b --init true-fan-in \\
      --steps 4 --global-batch 4 --accum 2 --seq 4096
  python -m repro_torch.launch.train --arch granite-3-2b --smoke --device cpu \\
      --steps 20 --global-batch 8 --seq 64 --ckpt ckpt/run --ckpt-every 10
  python -m repro_torch.launch.train --arch musicgen-large --init true-fan-in \\
      --steps 4 --global-batch 8 --accum 2 --seq 2048
  python -m repro_torch.launch.train --arch grok-1-314b --smoke --device cpu \\
      --steps 20 --global-batch 8 --seq 32 --optimizer adafactor

Port of ``src/repro/launch/train.py`` (``:43-101``) without the mesh (the
tensor-parallel slice of the port). Runs on the card unless ``--device
cpu`` is given; without a card and without ``--device`` it raises. Random
weights from ``--seed``, batches from :class:`repro_torch.data.lm.
LMPipeline` (embeddings of ``d_model`` in place of tokens for the audio and
VLM stubs, musicgen-large and internvl2-76b, whose inputs are
embeddings); prints one line per step with the loss, the gradient norm
and the step time, and raises when either is not finite. Each step
reports a heartbeat and its time to an ``FTController`` of one worker and
ticks it. Every family trains; the MoE family's loss adds its layers'
load-balance loss (``TrainConfig.aux_weight`` x aux, as the reference's),
and its expert products run through the grouped-matmul kernels, forward
and backward. ``--ckpt DIR`` saves the params
under ``DIR`` (on a thread, after a copy to the host) and the optimizer
state under ``DIR/opt`` every ``--ckpt-every`` steps
(:mod:`repro_torch.ckpt.checkpoint`); ``--resume`` restores both from the
latest step there and continues from it on the step-indexed batches, so a
resumed run's losses and params equal an uninterrupted run's. ``--init
reference`` (the default) is the reference's init, whose gradients overflow
at full depth (granite-3-2b's 40 layers: a gradient norm of inf on the
first step); ``--init true-fan-in`` rescales the attention projections to
their true fan-in (:func:`repro_torch.models.registry.true_fan_in`: every
attention layer of the transformer or of griffin's pattern; mamba2 has no
attention projections, so for it the flag changes nothing).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.ckpt import checkpoint
from repro_torch.data.lm import LMDataConfig, LMPipeline
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.ft import FTController
from repro_torch.sharding.params import init_tree, tree_map
from repro_torch.train.trainer import TrainConfig, make_train_step


@dataclasses.dataclass
class TrainRun:
    """What a run leaves: the trained params and optimizer state, the step
    function and the data, the step it started from (0, or the restored
    checkpoint's), the fault-tolerance controller, and per step run its
    loss, grad norm and seconds."""
    cfg: ModelConfig
    params: Any
    opt_state: Any
    train_step: Callable
    data: LMPipeline
    losses: list[float]
    grad_norms: list[float]
    seconds: list[float]
    start_step: int = 0
    ft: FTController | None = None


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "lion"])
    ap.add_argument("--init", default="reference",
                    choices=["reference", "true-fan-in"],
                    help="true-fan-in rescales the attention projections "
                         "(needed at granite-3-2b's full depth; mamba2 has "
                         "none, so it changes nothing there)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="directory for checkpoints (params; opt/ the "
                         "optimizer state)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint under --ckpt")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    tc = TrainConfig(optimizer=args.optimizer, lr=args.lr, accum=args.accum)
    train_step, optimizer = make_train_step(cfg, tc)
    data = LMPipeline(LMDataConfig(
        vocab=cfg.vocab, seq=args.seq, global_batch=args.global_batch,
        accum=args.accum, seed=args.seed,
        embed_dim=None if registry.uses_token_inputs(cfg) else cfg.d_model))
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    start_step = 0
    if (args.resume and args.ckpt
            and checkpoint.latest_step(args.ckpt) is not None):
        # restore into trees of meta tensors: nothing is drawn twice
        params_like = tree_map(
            lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
            registry.decls(cfg))
        params, start_step, _ = checkpoint.restore(args.ckpt, params_like,
                                                   device=dev)
        opt_state, _, _ = checkpoint.restore(
            f"{args.ckpt}/opt", optimizer.init(params_like), step=start_step,
            device=dev)
        print(f"resumed from step {start_step}", flush=True)
    else:
        params = init_tree(registry.decls(cfg), args.seed, dev, dtype=dtype)
        if args.init == "true-fan-in":
            params = registry.true_fan_in(params, cfg)
        opt_state = optimizer.init(params)

    ft = FTController(n_workers=1)
    run = TrainRun(cfg, params, opt_state, train_step, data, [], [], [],
                   start_step, ft)
    pending_save = None
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = data.batch_at(step)
        run.params, run.opt_state, metrics = train_step(run.params,
                                                        run.opt_state, batch)
        loss = float(metrics["loss"])          # waits for the step to end
        dt = time.perf_counter() - t0
        ft.report_heartbeat(0)
        ft.report_step_time(0, dt)
        ft.tick()
        norm = float(metrics["grad_norm"])
        run.losses.append(loss)
        run.grad_norms.append(norm)
        run.seconds.append(dt)
        print(f"step {step:5d} loss {loss:.4f} grad_norm {norm:.4f} "
              f"({dt:.2f}s)", flush=True)
        if not (math.isfinite(loss) and math.isfinite(norm)):
            hint = (" (at full depth the reference's init overflows: try "
                    "--init true-fan-in)" if args.init == "reference" else "")
            raise FloatingPointError(f"step {step}: loss {loss}, grad norm "
                                     f"{norm}: the update is not training"
                                     f"{hint}")
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = checkpoint.save(
                args.ckpt, run.params, step=step + 1, async_=True,
                metadata={"arch": cfg.name})
            checkpoint.save(f"{args.ckpt}/opt", run.opt_state, step=step + 1)
    if pending_save is not None:
        pending_save.join()
    print("done; final loss", run.losses[-1] if run.losses else math.nan)
    return run


if __name__ == "__main__":
    main()
