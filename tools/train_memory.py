#!/usr/bin/env python3
"""Peak device memory of one training recipe, or the allocation that fails.

    python3 tools/train_memory.py [--arch A] [--accum N]

Trains full-width ``--arch`` (default recurrentgemma-2b, ``--init
true-fan-in`` as ``chip_smoke.py`` trains it) through the training entry
point (``repro_torch.launch.train``) on ``chip_smoke.TRAIN_RECIPE``'s
recipe (AdamW, global batch 4 at seq 4096, remat full) in ``--accum``
microbatches (default 2: the recipe's 2 of 2) for one step, and prints
the peak allocated and reserved device memory. If the card runs out of
memory it prints the error, the peak reached and the card's capacity
instead; either way it exits 0, so that the answer is the output. Needs one CUDA card and ``nvcc``; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--accum", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    import torch

    if not torch.cuda.is_available():
        print("train_memory: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch import train as launch_train

    r = cs.TRAIN_RECIPE
    init = "true-fan-in" if args.arch == "recurrentgemma-2b" else "reference"
    argv = ["--arch", args.arch, "--init", init, "--steps", "1",
            "--global-batch", str(r["global_batch"]), "--accum",
            str(args.accum), "--seq", str(r["seq"]), "--lr", str(r["lr"]),
            "--optimizer", "adamw", "--seed", str(cs.SEED)]
    print(f"{cs.card_line()}; python -m repro_torch.launch.train "
          f"{' '.join(argv)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        launch_train.main(argv)
        outcome = "fits"
    except torch.OutOfMemoryError as err:
        outcome = f"out of memory: {str(err).splitlines()[0]}"
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{args.arch} in {args.accum} microbatches of "
          f"{r['global_batch'] // args.accum}: {outcome}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB, of the card's "
          f"{total / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
