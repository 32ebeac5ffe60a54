#!/usr/bin/env python3
"""Time the engine's sync and async dispatch in turns on one card.

    python3 tools/engine_timing.py [--root DIR] [--rounds N]

Serves ``chip_smoke.py``'s paged trace (full-width granite-3-2b with random
bf16 weights from seed 0; 8 slots, 16-token pages, prefill chunk 16; 16
requests of a shared 64-token prompt, 32 tokens each) through the
``ContinuousBatchingEngine`` of ``DIR/src/repro_torch`` (default: this
checkout), mixed (every second request sampled) and all greedy, with sync
and async dispatch in the order sync, async, async, sync, ``N`` times
(default 1). Host-bound steps vary by tens of percent from run to run, so
only turns within one call compare the two. Prints each run's median
decode-step ms (steps where every lane feeds one token) and tokens/s, and
the medians over the runs of each mode. Needs one CUDA card and ``nvcc``;
exits 1 without a card.
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose engine is timed (default: this one)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of sync, async, async, sync")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path

    sys.path.insert(0, str(pathlib.Path(args.root).resolve() / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("engine_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import init_tree

    print(cs.card_line(), flush=True)
    cs.build_all(kernel)
    cfg = configs.get("granite_3_2b")
    params = init_tree(registry.decls(cfg), cs.SEED, "cuda",
                       dtype=torch.bfloat16)
    reqs = cs.serve_trace(np)

    def run(async_dispatch: bool, mixed: bool):
        eng = ContinuousBatchingEngine(cfg, params, slots=8, max_len=160,
                                       device="cuda", page_size=16,
                                       prefill_chunk=16,
                                       async_dispatch=async_dispatch)
        for i, (rid, prompt, n_new) in enumerate(reqs):
            assert eng.submit(Request(
                rid, prompt, n_new,
                sampling=cs.mixed_sampling(i) if mixed else None))
        decode_ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while True:
            before = eng.token_steps
            ts = time.perf_counter()
            if not eng.step():
                break
            if eng.token_steps - before == 1:
                decode_ms.append((time.perf_counter() - ts) * 1e3)
        wall = time.perf_counter() - t0
        return (statistics.median(decode_ms), eng.tokens_generated / wall,
                {r.id: r.tokens for r in eng.completed})

    for mixed in (True, False):
        label = "mixed" if mixed else "greedy"
        ms = {False: [], True: []}
        tokens = None
        for _ in range(args.rounds):
            for async_dispatch in (False, True, True, False):
                step_ms, rate, toks = run(async_dispatch, mixed)
                assert tokens is None or toks == tokens, "tokens moved"
                tokens = toks
                ms[async_dispatch].append(step_ms)
                print(f"{label}, {'async' if async_dispatch else 'sync'}: "
                      f"decode step {step_ms:.3f} ms, {rate:.1f} tokens/s",
                      flush=True)
        print(f"{label}: median decode step sync "
              f"{statistics.median(ms[False]):.3f} ms, async "
              f"{statistics.median(ms[True]):.3f} ms over "
              f"{2 * args.rounds} runs each; every run's tokens equal",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
