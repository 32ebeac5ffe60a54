#!/usr/bin/env python3
"""Time the port's paged decode attention kernel from any checkout.

    python3 tools/paged_timing.py [--root DIR]

Builds the CUDA kernel of ``DIR/src/repro_torch`` (default: this checkout)
and times it at the three shapes of ``chip_smoke.py``'s kernel phase: the
serve phase's (8 slots, lengths up to 160), one slot at granite-3-2b's
4096-token context, and granite's decode shape (8 slots, lengths up to
1024), bf16, seed 0. The shapes, inputs and timing code are always this
checkout's ``chip_smoke.py``, so running it against two checkouts in one
call, in turns, compares two versions of the kernel on one card. Needs one
CUDA card and ``nvcc``; exits 1 without a card.
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
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path

    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("paged_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.paged_attention import kernel, ref

    print(f"{cs.card_line()}; kernel of {pathlib.Path(kernel.__file__).parent}")
    cs.build_all(kernel)
    cs.paged_timings(torch, kernel, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
