#!/usr/bin/env python3
"""Peak device memory of one training recipe, or the allocation that fails.

    python3 tools/train_memory.py [--arch A] [--accum N] [--layers L]
        [--optimizer adamw|adafactor|lion] [--global-batch B] [--seq S]

Trains full-width ``--arch`` (default recurrentgemma-2b, ``--init
true-fan-in`` as ``chip_smoke.py`` trains it; the reference's init for
the others) through the training entry point
(``repro_torch.launch.train``) for one step, remat full, and prints the
peak allocated and reserved device memory. The defaults are
``chip_smoke.TRAIN_RECIPE``'s recipe (AdamW, global batch 4 at seq 4096)
in ``--accum`` microbatches (default 2: the recipe's 2 of 2) at the
config's full depth; ``--layers`` cuts the depth (as ``chip_smoke.py``
cuts grok-1 to 1 of its 64 layers), and ``--optimizer``,
``--global-batch`` and ``--seq`` change the recipe. grok-1's training
recipe in ``chip_smoke.py``:

    python3 tools/train_memory.py --arch grok-1-314b --layers 1 \\
        --optimizer adafactor --global-batch 2 --accum 1 --seq 4096

If the card runs out of memory it prints the error, the peak reached and
the card's capacity instead; either way it exits 0, so that the answer is
the output. Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
from unittest import mock

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth to cut the config to (default: its own)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "lion"])
    ap.add_argument("--global-batch", type=int, default=None,
                    help="default: chip_smoke.TRAIN_RECIPE's")
    ap.add_argument("--seq", type=int, default=None,
                    help="default: chip_smoke.TRAIN_RECIPE's")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    import torch

    if not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.launch import train as launch_train

    r = cs.TRAIN_RECIPE
    batch = args.global_batch or r["global_batch"]
    seq = args.seq or r["seq"]
    cfg = configs.get(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    init = "true-fan-in" if args.arch == "recurrentgemma-2b" else "reference"
    argv = ["--arch", args.arch, "--init", init, "--steps", "1",
            "--global-batch", str(batch), "--accum", str(args.accum),
            "--seq", str(seq), "--lr", str(r["lr"]), "--optimizer",
            args.optimizer, "--seed", str(cs.SEED)]
    print(f"{cs.card_line()}; python -m repro_torch.launch.train "
          f"{' '.join(argv)} ({cfg.n_layers} layers, {cfg.param_count()} "
          f"parameters)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        with mock.patch.object(launch_train.configs, "get", lambda _: cfg):
            launch_train.main(argv)
        outcome = "fits"
    except torch.OutOfMemoryError as err:
        outcome = f"out of memory: {str(err).splitlines()[0]}"
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{args.arch} ({cfg.n_layers} layers, {args.optimizer}) in "
          f"{args.accum} microbatches of {batch // args.accum} at seq {seq}: "
          f"{outcome}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB, of the card's "
          f"{total / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
