#!/usr/bin/env python3
"""The engine phases' schedules of ``chip_smoke.py``, counted on the CPU.

    python3 tools/engine_dry_run.py

The engine's schedule (engine steps, one-token steps, dedup stalls,
re-matches, reused prompt tokens, replays) depends on the trace's lengths
and the engine's settings, never on the token values or the model's width.
So this script serves ``chip_smoke.py``'s traces with its engine settings
on the smoke config of the same family, on the CPU (prompt tokens taken
modulo the smoke vocabulary), and prints the counts the card's runs must
give: the granite paged trace greedy, mixed sync, mixed async and mixed
async preempted at engine steps 12 and 40; grok-1's lane trace greedy and
mixed; the window phase's trace (h2o-danube3's smoke config with the full
config's 4096-token window, ring tables of 257 entries); and the cluster
phase's open-loop trace (granite twice and h2o-danube3, the window set to
the full config's) plain and under its fault plan with the danube engine
crashed and rebuilt. ``chip_smoke.py``'s window and cluster phases compute
the same counts the same way before they run the card and hold the card
to them. Takes a few minutes; ``--only window`` or ``--only cluster``
prints one phase.
"""

from __future__ import annotations

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]

KEYS = ("steps", "token_steps", "stalls", "rematches", "rematched_tokens",
        "prompt_tokens_reused", "sampled_requests", "replays")


def serve(cfg, params, reqs, mixed, cuts=(), **kw):
    import chip_smoke as cs
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    eng = ContinuousBatchingEngine(cfg, params, device="cpu", **kw)
    for i, (rid, prompt, n_new) in enumerate(reqs):
        assert eng.submit(Request(
            rid, [t % cfg.vocab for t in prompt], n_new,
            sampling=cs.mixed_sampling(i) if mixed else None))
    n, requeued = 0, []
    while eng.step():
        n += 1
        if n in cuts:
            requeued.append(len(eng.preempt()))
    st = eng.stats()
    return {k: st[k] for k in KEYS} | ({"requeued": requeued} if cuts else {})


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("engine", "window", "cluster"))
    only = ap.parse_args(argv).only
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree

    torch.set_num_threads(2)
    if only in (None, "window"):
        reqs = cs.window_trace(np, configs.get("h2o_danube3_4b").vocab)
        eng = cs.window_serve(*cs.smoke_twin("h2o_danube3_4b", "cpu"), "cpu",
                              reqs)
        print("window trace (h2o-danube3, window 4096):",
              cs.window_counts(eng), flush=True)
    if only in (None, "cluster"):
        smoke = {a: cs.smoke_twin(a, "cpu")
                 for a in ("granite_3_2b", "h2o_danube3_4b")}
        for label, faults in (("plain", False), ("under faults", True)):
            print(f"cluster trace, {label}:", cs.cluster_counts(
                *cs.cluster_serve(smoke, "cpu", faults=faults)), flush=True)
    if only not in (None, "engine"):
        return 0
    cfg = configs.smoke("granite_3_2b")
    params = init_tree(registry.decls(cfg), cs.SEED, "cpu")
    paged = {"slots": 8, "max_len": 160, "page_size": 16, "prefill_chunk": 16}
    reqs = cs.serve_trace(np)
    runs = [("greedy, sync", False, {}), ("mixed, sync", True, {}),
            ("mixed, async", True, {"async_dispatch": True}),
            ("mixed, async, preempted at steps 12 and 40", True,
             {"async_dispatch": True, "cuts": (12, 40)})]
    for label, mixed, kw in runs:
        print(f"granite paged trace, {label}:",
              serve(cfg, params, reqs, mixed, **paged, **kw), flush=True)

    cfg = configs.smoke("grok_1_314b")
    params = init_tree(registry.decls(cfg), cs.SEED, "cpu")
    s = cs.LANE_SERVE
    lanes = {"slots": s["slots"], "page_size": s["page_size"],
             "prefill_chunk": s["prefill_chunk"],
             "max_len": s["system"] + s["own"] + s["new"]}
    reqs = cs.lane_trace(np, configs.get("grok_1_314b").vocab)
    for label, mixed, kw in runs[:3]:
        print(f"grok lane trace, {label}:",
              serve(cfg, params, reqs, mixed, **lanes, **kw), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
