#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA;
imports nothing of JAX or of the JAX package ``src/repro``. In order:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the paged-attention, flash-attention, RG-LRU scan, SSD
   chunk-scan, depthwise causal conv1d and grouped-matmul kernels from
   ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` each, started together;
   reused when already built) and prints the compiler's resource reports;
3. kernel phase: holds the paged CUDA kernel (split-KV, splits merged in
   the same launch) against its plain PyTorch version on the card, on the
   reference's test cases in float32 and bfloat16, at granite-3-2b's decode
   shape (8 slots, 32 query / 8 KV heads, head dim 64, 16-token pages,
   ragged lengths up to 1024, bf16 pool, with and without a ring-table
   window), and on the split design's edges (``PAGED_EDGES``: single-split
   and merged slots in one call, one slot at 4096 positions and one past 64
   splits, a slot of length 0, G 1 to 16, every load width, rings whose
   window is not a multiple of the page size, page ids outside the pool in
   unused entries, h2o-danube3-4b's decode shape: D 120, GQA 32/8, a
   4096-token window over a 257-entry ring; internvl2-76b's: D 128, GQA
   64/8) in all four dtype pairs, each
   call repeated bit for bit with the merge's counters left zeroed; then
   times kernel, plain version and ``scaled_dot_product_attention`` (the
   yardstick, never called by the port; on KV gathered in advance and with
   the gather) at h2o-danube3-4b's windowed decode shape, the serve phase's
   shape, one slot at 4096 positions and the decode shape, from a CUDA
   graph and eagerly (``tools/paged_timing.py`` times any checkout's
   kernel the same way);
4. serve phase: full-width, full-depth granite-3-2b with random weights
   made on the card from a seed, served by ``ContinuousBatchingEngine``
   (8 slots, 16-token pages, prefill chunk 16): 16 requests sharing a
   64-token system prompt, 32 greedy tokens each, with the engine's
   default energy meter and its own platform. Checks completions, prefix
   reuse, that every attention call went through the kernel (launches ==
   n_layers x one-token steps), 16 ``serve.admit`` and 16
   ``serve.complete`` interrupts and the meter's conservation; serves the
   trace again unmetered and metered (equal completions, decode steps in
   turns); then teacher-forces one request
   through the kernel path, holding every attention call to the plain
   version on that call's own inputs. (Full-width logits of the kernel path
   and the plain path are printed, not compared: this random-weight model
   at depth 40 turns a one-ulp difference into O(1) logit differences
   within a few steps, and a printed control shows the same for the plain
   path against itself perturbed by one bf16 ulp.) Keeps the greedy
   completions for phase 31;
5. small reference: the granite smoke config (3 layers, float32) served on
   the card and on the CPU's plain path gives equal completions, after a
   check that its greedy margins are clear (and on the card metered and
   unmetered alike), and its teacher-forced logits
   agree between the kernel path and the plain path on the card;
6. checks that ``torch.argmax`` on the card takes the first maximal index;
7. flash kernel phase: the CUDA flash forward (o and lse) and backward (dq,
   dk, dv) against their plain versions on the reference's attention cases
   in float32 and bfloat16, on the edges of the bf16 kernels' tiles (D 8
   and 120, ragged S over three tiles, G 4 over five key tiles, a window
   ending inside a tile, non-causal Sq != Sk) and at the audio and VLM
   families' groups (``FLASH_G_EDGES``: G 1 at D 64, G 8 at D 128),
   against float64 at one small
   shape, and at granite's training shape (B 2, S 4096, H 32, K 8, D 64,
   bf16, causal), each tensor at a bound scaled to its size
   (``close_scaled``); checks, by the route the C entry reports, that
   every bf16 forward took the tensor-core kernel and every float32 one
   the CUDA-core kernel, and that two forward calls and two backward
   calls at the training shape give the same bits; times kernels, plain
   versions and SDPA forward and backward there, profiles one forward call
   (its kernel's name, checked, and device time),
   and holds and times the forward at grok-1's prefill shape (B 8, S 1024,
   H 48, K 8, D 128, bf16, causal) against SDPA;
8. train phase: full-width, full-depth granite-3-2b, 4 AdamW steps (lr
   3e-4, global batch 4 in 2 microbatches, seq 4096, remat full) through
   the training entry point ``repro_torch.launch.train`` (``--init
   true-fan-in``) on ``LMPipeline`` batches. Checks finite and falling
   loss and grad norms, 160 forward and 80 backward flash launches per step
   (every attention call went through the kernels, every forward through
   the tensor-core kernel by the route count and, in the profiled step, by
   the device kernels' names), holds every attention call of one
   microbatch to the plain version on its own inputs, prints step time,
   tokens/s, mfu and peak memory, and profiles one step;
9. small train reference: the granite smoke config on tokens and the
   musicgen smoke config on embeddings, in float32, 2 steps on the card
   through the kernels and on the CPU through the plain path from the same
   params and batches: losses, grad norms and params (leaf by leaf) agree;
10. RG-LRU phase: the CUDA scan against its plain version on the
    reference's cases, a ragged S and W, against float64, and at
    recurrentgemma-2b's prefill shape (B 8, S 4096, W 2560), timed there;
11. flash D 256 phase: the flash forward at head dim 256 (MQA, a window)
    against its plain version on a small case and on the edges of the bf16
    kernel's D 256 tile (D 136 and 200, ragged S over three 32-key steps,
    a window ending inside a step, G 10, non-causal Sq != Sk), in float32
    and bfloat16, checking by the C entry's route that every bf16 call took
    the tensor-core kernel and every float32 call the CUDA-core one;
    float32 and a bf16 case against float64 on the same inputs; and at
    recurrentgemma-2b's prefill shape (B 8, S 4096, H 10, K 1, window 2048,
    bf16), where two calls give the same bits; timed there against the
    plain version and windowed SDPA;
12. hybrid serve phase: full-width recurrentgemma-2b through the serve
    driver ``repro_torch.launch.serve`` (batch 8, a 4096-token prompt, 64
    greedy steps). Checks 18 scan and 8 flash-forward launches in the
    prefill, all 8 on the tensor-core kernel, and none in a decode step,
    holds every scan and flash call of one prompt's prefill to the plain
    versions (the flash o and lse to the plain version in float64, beside
    the float32 plain version's own distance from it), prints prefill
    time, decode-step time, tokens/s and peak memory, and profiles a
    prefill (its flash forwards checked by kernel name) and a decode step;
13. small hybrid reference: the recurrentgemma smoke config served on the
    card (through the kernels) and on the CPU's plain path: logits, caches
    and clear-margin greedy tokens agree;
14. SSD phase: the CUDA SSD chunk scan against its plain version: float32
    B and C (the CUDA-core route) on the reference's cases and ragged S,
    bf16 B and C (the tensor-core route) on its edges (``SSD_EDGES``: S 1,
    ragged last chunks, chunks of 8 to 1024, P 8 to 64, N 4 to 128),
    contiguous and shared by the heads with stride 0, in float32 and bf16
    x, each call's route by the C entry's report and a second call's bits;
    both routes against a float64 oracle; and at mamba2-370m's prefill
    shape (b 8, s 4096, 32 heads, p 64, n 128, chunk 256) against the plain
    version in float64, two calls bit for bit; timed there with its
    kernels' device times, both bounds (the tensor cores' TF32 and the CUDA
    cores' float32), registers, spills, shared memory and workspace;
15. mamba2 serve phase: full-width mamba2-370m through the serve driver
    ``repro_torch.launch.serve`` (batch 8, a 4096-token prompt, 64 greedy
    steps). Checks 48 SSD launches in the prefill, every one on the
    tensor-core route, and none in a decode step, holds every SSD call of
    one prompt's prefill to the plain version in float64 and checks its
    route, prints prefill time, decode-step time, tokens/s and peak memory,
    profiles a prefill and a decode step, and counts the launches that the
    decode step's SiLU (rounded as XLA rounds it) takes;
16. small mamba2 reference: the mamba2 smoke config served on the card
    (through the kernel) and on the CPU's plain path: logits, caches and
    clear-margin greedy tokens agree;
17. backward phase: the backward kernels of the recurrent families'
    training against their plain versions: the RG-LRU scan's on the
    reference's cases, ragged S and W and one step, bit for bit, and
    against float64; the flash backward at head dim 256 on the edges of its
    tiles (``FLASH256_EDGES``) in float32 (the CUDA cores, one staging
    tile) and bfloat16 (the tensor cores: dK and dV in one launch over
    query heads and key tiles, the heads' float32 shares summed in head
    order, 16-key dQ steps; two calls bit for bit), against float64; the
    SSD chunk scan's
    on the forward's cases and edges, B and C per head and shared by the
    heads, against float64 at the test's and the model's decay. Then each
    at the shape the train phases give it (scan (1, 4096, 2560); attention
    (1, 4096, 10, 1, 256), window 2048, bf16; SSD (2, 4096, 32, 64, 128),
    float32 x, bf16 B and C shared), and the scan and attention also at
    the recipe's microbatch of 2, which the card cannot train at this
    width, held to its plain version, two calls bit for bit, timed beside
    its plain version, its bound (for the SSD the function's own work,
    whatever the chunk) and SDPA's backward with the window as a mask (the
    yardstick for the attention);
18. hybrid train phase: full-width, full-depth recurrentgemma-2b (26
    layers, 2.68e9 parameters) trained by ``repro_torch.launch.train``
    (``--init true-fan-in``): granite's recipe (4 AdamW steps, global batch
    4 at seq 4096, remat full) in 4 microbatches of 1, as 2 of 2 run out
    of memory (``tools/train_memory.py``). Prints the launches worked out
    from the layer pattern before the run and checks them exactly after it
    (the triples' forwards twice, the tail's once; every flash forward on
    the tensor-core kernel);
    finite, falling loss; then on one microbatch holds every scan and
    attention call, forward and backward, to its plain version (scans bit
    for bit, attention in float64), checks every parameter leaf's gradient
    finite and not all zero, and the microbatch's loss before and after;
    profiles one step (launches, busy share, each kernel's share of device
    time) and prints step time, tokens/s, mfu and peak memory;
19. SSM train phase: the same for full-width, full-depth mamba2-370m (48
    layers) in 2 microbatches of 2, its SSD calls forward and backward held
    to the plain version in float64, every SSD forward on the tensor-core
    route;
20. small recurrent train reference: the recurrentgemma and mamba2 smoke
    configs, float32 params, one AdamW step of 2 microbatches on the card
    through the kernels and on the CPU through the plain versions: the
    gradients handed to AdamW agree leaf by leaf (``RECURRENT_GRAD_TOL``),
    loss, grad norm and every parameter after the step
    (``RECURRENT_STEP_TOL``), the card's launches as worked out;
21. conv1d phase: the CUDA depthwise causal conv against its plain version
    on the reference's cases (float32 at 1e-5 and bit for bit, bfloat16 at
    5e-2), at width 1, ragged S and D, stride-0 and transposed inputs,
    against float64, and at the seizure CNN's three layer shapes; timed at
    layer 0's shape (1, 1024, 32) and at recurrentgemma's conv shape (8,
    4096, 2560, bf16, on no path) against the plain version and cuDNN's
    depthwise conv (the yardstick, never called by the port);
22. healthcare phase: the flow of ``examples/healthcare_pipeline.py``
    through the port on the card (the HEEPocrates platform with the CGRA
    attached, bank gating from each acquisition, ``run_heartbeat``, the
    seizure CNN on the host path and through the CGRA, the 4.9x energy
    story, post-processing leakage). Checks 87 conv1d launches per CGRA
    ``apply``, each of those calls against the plain version, host == CGRA
    within 1e-4, and the card's logits and clear-margin flags against the
    CPU's plain path; prints the wall times of one ``apply`` and one
    ``classify``;
23. gmm phase: the CUDA grouped matmul against its plain version on the
    reference's cases (float32 at 1e-4, bfloat16 at 5e-2), ragged C, D and
    F, the edges of the bf16 TMA routes' tiles (C 1 to 129, D 8 to 1008,
    F 8 to 264, one persistent block walking two experts' tiles), an input
    off 16-byte alignment (the mma.sync route, bit for bit the aligned
    wgmma result), against float64, and at the four shapes of grok-1's
    expert FFN (prefill gate/up and down on the wgmma route, decode gate/up
    and down on the split-D route, bf16); every call's route checked by
    the C entry's report, two calls giving the same bits; timed at the four
    shapes against the plain version and ``torch.bmm`` (the yardstick,
    never called by the port);
24. moe serve phase: full-width grok-1 cut to 4 of its 64 layers (42.58
    GB of bf16 weights) through the serve driver
    ``repro_torch.launch.serve.run`` (batch 8, a 1024-token prompt, 64
    greedy steps). Checks 12 grouped-matmul and 4 flash-forward launches in
    the prefill (the grouped matmuls on the wgmma route, the flash forwards
    on the tensor-core kernel) and 12 grouped matmuls on the split-D route
    in each decode step, holds every grouped-matmul call of
    a prefill and of one decode step, and every flash forward of that
    prefill, to the plain version (the flash lse to the plain version in
    float64), counts the prefill's dropped slots, prints prefill time,
    decode-step time, tokens/s and peak memory, profiles a prefill and a
    decode step (the grouped matmul's kernels checked by name), and keeps
    the weights for the next phase;
25. lane engine phase: the same grok-1 weights served by
    ``ContinuousBatchingEngine`` on its lane backend (8 slots, 16-token
    pages, prefill chunk 16, metered): 16 requests sharing a 32-token
    system prompt, 16 tokens of their own and 16 greedy tokens each.
    Checks completions, prefix reuse and copy-on-write, the lane backend,
    12 grouped-matmul launches a one-token step (the lanes packed into one
    call a weight), every one on the split-D route, 16 ``serve.admit`` and
    16 ``serve.complete`` interrupts and the meter's conservation; serves
    the trace again unmetered (equal completions) with every routing
    recorded (no lane drops a slot) and one decode step profiled; serves
    it with every second request sampled, sync and async (the same bits,
    the greedy requests equal to the greedy run's, 12 split-D grouped
    matmuls a one-token step); teacher-forces one request in an 8-lane
    cache, holding every grouped matmul call to the plain version; times
    the kernel at the packed shapes; prints decode-step time, tokens/s,
    busy share, peak memory and the snapshots resident; then frees the
    weights;
26. small MoE reference: the grok and llama4 smoke configs served on the
    card (through the kernel) and on the CPU's plain path: routing equal
    on every MoE call, logits and caches at the bf16 bound, clear-margin
    greedy tokens equal; prints the smallest top-k router margin;
27. recurrent lane phase: full-width, full-depth mamba2-370m and
    recurrentgemma-2b on the same engine and trace: completions, reuse,
    backend and the meter; decode-step time, peak memory and the bytes of
    one lane snapshot;
28. small lane reference: the granite, grok, mamba2 and recurrentgemma
    smoke configs through the lane engine on the card and on the CPU's
    plain path, completions equal where the margins are clear; granite's
    on lanes equal to the paged backend's on the card, greedy and with
    every second request sampled (equal to the CPU's plain path where the
    margins of the sampler's scores are clear);
29. window phase: h2o-danube3-4b at full width (d_model 3840, 32/8 heads
    of dim 120, window 4096), 4 of its 24 layers, on the paged backend
    with ring block tables (4 slots, 16-token pages, max_len 4352: 257
    entries a slot), 4 requests of one 4160-token prompt and 16 own
    tokens, 96 greedy tokens each, all submitted at once. Checks the
    schedule (stalls, re-matches, pages recycled, table entries, the
    pool's high water) equal to the smoke twin's (the same trace on the
    smoke config with the full window, first; ``tools/engine_dry_run.py``
    prints the same counts from the CPU), the high water within 4 x 257 +
    the table's capacity, launches == 4 x one-token steps; serves the trace
    again with every free page of the pool NaN before every step: the same
    tokens bit for bit, every live lane's logits finite, and every paged
    call of one prefill and one decode step past the window (D 120, a ring
    table) held to the plain version (``close_scaled``);
30. cluster phase: granite-3-2b (two same-namespace tenants of 8 and 4
    slots, one parameter tree) and h2o-danube3-4b (24 layers, 8 slots,
    max_len 512) on one ``ServeCluster`` (one pool and table, 16-token
    pages, a budget of 5 awake banks, deficit round-robin with TTFT shed
    and deadline preempt), 96 bursty open-loop arrivals (seed 0, every
    second danube request sampled) through ``ClusterSimulator`` on a fake
    clock. Checks the schedule, the report and the metrics (TTFT/TPOT
    percentiles, attainment, goodput) equal to the smoke twins', awake
    banks within the budget, after every step the merge's counters zero
    and the pool conserved, launches == layers x one-token steps, every
    paged call of one step of all three tenants (D 64 and D 120) held to
    the plain version, every served request's tokens equal to its engine
    alone on the card; then the trace under a seeded ``FaultPlan`` (step,
    alloc and token faults) with the danube engine crashed and rebuilt at
    step 40: counts equal the twins', tokens equal the plain run's,
    journals and pool reconciled, the rebuilt engine on the same arena and
    parameter tensors, device memory within 64 MiB of its value before the
    crash. Prints wall ms a cluster step, paged launches a step, and three
    profiled steps' launches and device busy share;
31. sampled engine phase, the last with profiled windows, because they
    make the profiler drop kernels of later windows: full-width
    granite-3-2b's weights made again, phase 4's trace with every second request sampled
    (temperature 0.8, top_k 50, top_p 0.9, seed 100 + i), all submitted at
    once so that siblings stall on dedup claims and re-match, served sync,
    async, and async preempted at engine steps 12 and 40. Checks sync ≡
    async ≡ replayed bit for bit (the journal cross-checks each replayed
    token), the greedy requests equal to phase 4's all-greedy run, every
    attention call through the kernel (launches == 40 x one-token steps in
    each run), stalls, re-matches and the meter; and in the preempted run,
    after every step, the merge's counters zero and each lane's key equal
    to its chain recomputed on the CPU from (seed, produced count), and
    every sampler call's tokens equal to the CPU's plain ``sample`` on the
    same logits and keys where the margin is clear. Prints decode-step
    time, tokens/s and a profiled window's busy share for sync and async
    (``tools/engine_timing.py`` times the two in turns), and profiles
    phase 4's one-token step with 4 of 8 lanes sampled and the sampler
    alone;
32. embeds train phase (this phase and the four after it come after every
    phase whose checks read the profiler: their launches would make it
    drop the device events of later windows): full-width, full-depth
    musicgen-large (48 layers, MHA, 2.42e9 parameters) trained on bf16
    embeddings through ``repro_torch.launch.train`` (AdamW, global batch 8
    in 2 microbatches of 4, seq 2048, remat full, 4 steps; ``--init
    true-fan-in``, a control printing the gradient's blow-up at the
    reference's init): finite, falling loss, 192 forward and 96 backward
    flash launches a step, all forwards on the tensor-core kernel; every
    attention call of one microbatch held to the plain version; step time,
    mfu, peak memory, a profiled step (in a child process, whose profiler
    starts afresh); the flash forward and backward at the microbatch's
    shape (G 1) timed against the plain version, SDPA and the bound;
33. resume phase: musicgen-large's width on 2 of its 48 layers, 6 steps
    straight against 3, a checkpoint (``--ckpt-every 3``), ``--resume``
    and 3 more: losses, params and AdamW's state bit for bit; a save and a
    restore timed; under a temporary directory the phase removes;
34. embeds serve phase: the serve driver prefilling from embeddings, batch
    8, 64 greedy steps: musicgen-large (512 frames) and internvl2-76b at
    full width on 8 of its 80 layers (2048 embeddings): the prefill's
    flash launches, none in a decode step, every flash call of one
    prompt's prefill held to the plain version in float64; prefill time,
    decode step, tokens/s, peak memory; the flash forward timed at both
    prefill shapes;
35. vlm engine phase: those internvl2-76b weights served by tokens through
    ``ContinuousBatchingEngine`` on its paged backend (8 slots, the serve
    phase's trace): completions, reuse, launches == layers x one-token
    steps, every paged call of one request held to the plain version; the
    paged kernel at this decode shape (D 128, G 8) timed from a CUDA graph
    against its bound and SDPA;
36. dispatch phase: a probe accelerator registered under a new impl key
    (``probe_accelerators``) reached by the smoke engine with
    ``attn_impl`` set to it, every paged call through it, tokens bit for
    bit the ``"cuda"`` run's.

Prints a ``{"kernels": [...]}`` JSON line (eleven entries; paged
attention's launches are those of the greedy serve run, the vlm engine
run, the window and cluster phases' main runs and the three sampled
engine runs, the D <= 128 flash forward's and backward's those of the two
train phases and (forward) the embeds serve runs, the grouped
matmul's those of the serve driver and the lane engine's greedy and mixed
runs, the RG-LRU scan's, the D 256 flash forward's and the SSD's those of
the serve driver and the train phase, each under ``launches_by_path``; the
three backward kernels' those of their train phase),
the card line again,
and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero and prints no result; so does a machine without a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
# the reference's kernel tolerances (tests/test_paged_attention.py:71),
# with its assert_allclose meaning: |got - want| <= tol + tol * |want|.
# float32 differs only in summation order; bfloat16 outputs round once
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
# B, H, K, D, max_len, ps, window (tests/test_paged_attention.py:54-60)
PAGED_CASES = [
    (3, 4, 2, 16, 32, 8, None),
    (2, 4, 4, 48, 24, 4, None),
    (1, 8, 1, 64, 64, 16, None),
    (4, 4, 2, 16, 40, 8, 12),
    (2, 6, 3, 32, 33, 16, None),
]
GRANITE_DECODE = (8, 32, 8, 64, 1024, 16)   # B, H, K, D, max_len, ps
RING_WINDOW = 256
LONG_CONTEXT = 4096        # granite-3-2b's context: one slot of it is timed
# the edges of the split-KV kernel (``kernel.plan``: 64-position splits at
# 16-token pages): B, H, K, D, ps, lengths, window, NP (None: a ring of
# ceil(window / ps) + 1 entries). Unused entries of a contiguous table hold
# page ids outside the pool.
PAGED_EDGES = (
    # single-split and merged slots in one call: 1, L - 1, L, L + 1, 2L
    [(5, 32, 8, 64, 16, (1, 63, 64, 65, 128), None, 10),
     # one slot at granite's context: 64 splits merged
     (1, 32, 8, 64, 16, (LONG_CONTEXT,), None, 256),
     # past 64 splits of 64: 64 splits of 128 positions, two tiles each
     (1, 8, 2, 64, 16, (2 * LONG_CONTEXT - 5,), None, 512),
     # a slot of length 0 (zeros) beside merged ones
     (3, 8, 2, 64, 16, (0, 70, 130), None, 12)]
    # G 1, 4, 8 and 16 (two chunks of 8 query heads a KV head)
    + [(3, 4 * g, 4, 64, 16, (1, 64, 200), None, 13) for g in (1, 4, 8, 16)]
    # every load width: bf16 rows of 32, 66, 68, 72, 128, 200 and 256 bytes
    # take 16-, 2-, 4-, 8-, 16-, 8- and 16-byte loads; float32 16, 4, 8, 16
    + [(3, 8, 2, d, 16, (17, 64, 150), None, 10)
       for d in (16, 33, 34, 36, 64, 100, 128)]
    # rings whose window is not a multiple of the page size, over 2 and 4
    # splits, lengths below and past the window
    + [(6, 8, 2, 64, 16, (1, 50, 100, 150, 300, 777), 100, None),
       (6, 8, 2, 64, 16, (1, 64, 199, 200, 333, 777), 200, None),
       (4, 8, 2, 64, 4, (3, 13, 40, 93), 13, None)]
    # h2o-danube3-4b's decode shape (the window phase's): D 120 (a bf16 row
    # of 240 bytes, 15 16-byte words), GQA 32/8, a 4096-token window over a
    # 257-entry ring, lengths below, at and past the window
    + [(4, 32, 8, 120, 16, (1000, 4096, 4097, 4352), 4096, None)]
    # internvl2-76b's decode shape (the VLM engine phase's): D 128 (the
    # kernel's limit) under GQA 64/8, 8 slots of one split, merged splits
    # and a long one
    + [(8, 64, 8, 128, 16, (1, 63, 64, 65, 97, 159, 160, 1000), None, 64)])
DANUBE_DECODE = (4, 32, 8, 120, 16, 4096)   # B, H, K, D, ps, window


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def close_at(got, want, atol: float, rtol: float) -> float:
    """Max abs error; raises unless |got - want| <= atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"max abs err {err.max().item():.3e} over "
                             f"tolerance {atol} + {rtol} * |want|")
    return err.max().item()


def close(got, want, tol: float) -> float:
    """:func:`close_at` with ``atol = rtol = tol``."""
    return close_at(got, want, tol, tol)


def close_scaled(got, want, atol: float, rtol: float) -> tuple[float, float]:
    """Max abs error and the tensor's scale ``s = min(1, rms|want|)``;
    raises unless |got - want| <= atol * s + rtol * |want|.

    The reference's tolerance in ``assert_allclose``'s meaning, with atol
    scaled down to the size of the tensor compared, so never looser than
    :func:`close_at`. Flash outputs at long sequences (|o| about 0.02-0.05
    at S 4096 on unit inputs) and the gradients of a mean loss (orders of
    magnitude below 1) are the size of a fixed atol or far smaller, so a
    fixed atol would pass a kernel that drops or doubles a KV tile, or
    returns zeros. The root mean square rather than the max: the first rows
    of a causal call attend to one or two keys, so their o is as large as
    v itself and would set the scale for every longer row."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    scale = min(1.0, want.square().mean().sqrt().item())
    if not bool((err <= atol * scale + rtol * want.abs()).all()):
        raise AssertionError(f"max abs err {err.max().item():.3e} over "
                             f"tolerance {atol} * {scale:.3e} + {rtol} * "
                             f"|want|")
    return err.max().item(), scale


# the ops the models dispatch through the XAIF registry (REGISTRY.dispatch)
XAIF_OPS = ("attention", "moe_ffn", "rglru", "ssd", "paged_attention")


def cuda_fn(op: str):
    """The function registered under ``op``'s ``"cuda"`` key."""
    from repro_torch.core.xaif import REGISTRY

    return REGISTRY.get(op, "cuda").fn


def set_cuda(op: str, fn):
    """Put ``fn`` under ``op``'s ``"cuda"`` key of the XAIF registry, where
    the models dispatch it, with the spec's ports; returns the function it
    replaced."""
    from repro_torch.core.xaif import REGISTRY

    spec = REGISTRY.get(op, "cuda")
    REGISTRY.register(dataclasses.replace(spec, fn=fn), allow_override=True)
    return spec.fn


@contextlib.contextmanager
def on_cuda(op: str, fn):
    """:func:`set_cuda` while the block runs."""
    real = set_cuda(op, fn)
    try:
        yield
    finally:
        set_cuda(op, real)


@contextlib.contextmanager
def probe_accelerators(key: str = "probe", ops=XAIF_OPS):
    """A plug-in under the new impl key ``key`` for each of ``ops``: it
    wraps the ``"cuda"`` accelerator and counts its calls (the dict it
    yields). No model code changes: a config whose ``attn_impl``,
    ``scan_impl`` and ``moe_impl`` name ``key`` reaches it. Unplugged when
    the block ends."""
    from repro_torch.core.xaif import REGISTRY

    counts = dict.fromkeys(ops, 0)

    def wrap(op, fn):
        def probe(*args, **kwargs):
            counts[op] += 1
            return fn(*args, **kwargs)
        return probe

    for op in ops:
        spec = REGISTRY.get(op, "cuda")
        REGISTRY.register(dataclasses.replace(
            spec, name=f"{op}_{key}", impl=key, fn=wrap(op, spec.fn)))
    try:
        yield counts
    finally:
        for op in ops:
            REGISTRY.unregister(op, key)


def attention_f64(torch, q, k_pool, v_pool, tables, lengths):
    """Paged attention over contiguous tables in float64, and the largest
    |score| it saw: the yardstick both float32 versions are measured
    against."""
    b, h, d = q.shape
    _, ps, kh, _ = k_pool.shape
    n = tables.shape[1] * ps
    kg = k_pool[tables.long()].reshape(b, n, kh, d).double()
    vg = v_pool[tables.long()].reshape(b, n, kh, d).double()
    s = torch.einsum("bkgd,bckd->bkgc",
                     q.double().reshape(b, kh, h // kh, d), kg) / d ** 0.5
    valid = torch.arange(n, device=q.device)[None] < lengths[:, None].long()
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    o = torch.einsum("bkgc,bckd->bkgd", s.softmax(-1), vg).reshape(b, h, d)
    return o, s.masked_fill(~valid[:, None, None], 0).abs().max().item()


def pool_case(torch, gen, b, h, kh, d, max_len, ps, window, q_dtype, kv_dtype,
              copies=1, ring=False, fixed=False):
    """Random pools (``copies`` layers of them), shuffled disjoint page
    chains, ragged lengths in [1, max_len] (all ``max_len`` when ``fixed``);
    ``ring`` builds ring tables of ceil(window/ps)+1 entries holding each
    slot's newest blocks."""
    dev = "cuda"
    lengths = (torch.full((b,), max_len, device=dev, dtype=torch.int32)
               if fixed else
               torch.randint(1, max_len + 1, (b,), generator=gen, device=dev,
                             dtype=torch.int32))
    np_slot = -(-window // ps) + 1 if ring else -(-max_len // ps)
    n_pages = b * np_slot + 1
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    tables = perm[:b * np_slot].reshape(b, np_slot).contiguous()
    shape = (copies, n_pages, ps, kh, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    return q, kp, vp, tables, lengths


def rotating(fn, copies: int):
    """``fn(i)`` as a call of no arguments over i = 0, 1, .., copies - 1, 0,
    .. (for :func:`graph_ms`, so that each captured call finds its inputs
    cold in L2 as :func:`time_ms` does)."""
    calls = itertools.count()
    return lambda: fn(next(calls) % copies)


def time_ms(torch, fn, copies: int, inner: int = 50, reps: int = 21) -> float:
    """Median ms per call over ``reps`` runs of ``inner`` calls, rotating
    over ``copies`` input copies so that each call finds its KV cold in L2
    (as a decode step does, after the other layers' weights)."""
    for i in range(copies):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(inner):
            fn(i % copies)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def paged_case(torch, gen, kernel, ref, b, h, kh, d, ps, lengths, window,
               np_slot, q_dt, kv_dt) -> tuple[float, object]:
    """One call of the CUDA kernel on the given lengths against the plain
    version (``TOL`` by q's dtype; a slot of length 0 gives zeros, where
    the plain version averages v), a second call's bits, and the merge's
    counters all zero after both. Unused entries of a contiguous table hold
    page ids outside the pool (the plain version, which gathers every
    entry, gets them clamped: they are masked). Returns the error and the
    call's ``kernel.plan``."""
    dev = "cuda"
    if window is not None:
        np_slot = -(-window // ps) + 1
    n_pages = b * np_slot + 1
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    tables = perm[:b * np_slot].reshape(b, np_slot).contiguous()
    ref_tables = tables
    if window is None:
        used = torch.tensor([-(-n // ps) for n in lengths], device=dev)
        unused = torch.arange(np_slot, device=dev)[None] >= used[:, None]
        tables = torch.where(unused, n_pages + 3, tables).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kp = torch.randn((n_pages, ps, kh, d), generator=gen, device=dev).to(kv_dt)
    vp = torch.randn((n_pages, ps, kh, d), generator=gen, device=dev).to(kv_dt)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dt)
    got = kernel.paged_attention_cuda(q, kp, vp, tables, lens, window=window)
    again = kernel.paged_attention_cuda(q, kp, vp, tables, lens, window=window)
    torch.cuda.synchronize()
    counters = kernel.counter_buffer(q.device)
    assert counters is None or not bool(counters.any()), "counters left set"
    assert torch.equal(got, again), "two calls differ"
    live = lens > 0
    assert not bool(got[~live].any()), "a slot of length 0 is not zero"
    want = ref.paged_attention(q, kp, vp, ref_tables, lens, window=window)
    err = close(got[live], want[live], TOL[str(q_dt).split(".")[1]])
    return err, kernel.plan(b, h, kh, d, np_slot, ps, window, q_dt, kv_dt)


DTYPE_PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
               ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def kernel_phase(torch, kernel, ref) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [(c, dt, dt) for c in PAGED_CASES
             for dt in (torch.float32, torch.bfloat16)]
    b, h, kh, d, max_len, ps = GRANITE_DECODE
    cases += [((b, h, kh, d, max_len, ps, None), torch.bfloat16, torch.bfloat16),
              ((b, h, kh, d, max_len, ps, RING_WINDOW), torch.bfloat16,
               torch.bfloat16),
              ((b, h, kh, d, max_len, ps, None), torch.float32, torch.bfloat16)]
    for i, (case, q_dt, kv_dt) in enumerate(cases):
        ring = i == len(cases) - 2
        q, kp, vp, tables, lengths = pool_case(torch, gen, *case, q_dt, kv_dt,
                                               ring=ring)
        win = case[-1]
        got = kernel.paged_attention_cuda(q, kp[0], vp[0], tables, lengths,
                                          window=win)
        want = ref.paged_attention(q, kp[0], vp[0], tables, lengths, window=win)
        torch.cuda.synchronize()
        tol = TOL[str(q_dt).split(".")[1]]
        err = close(got, want, tol)
        print(f"kernel case B,H,K,D,max_len,ps,window={case} "
              f"{'ring ' if ring else ''}q {q_dt} pool {kv_dt}: "
              f"max abs err {err:.3e} (tolerance {tol} + {tol} * |plain|)")

    # the split-KV design's edges, in all four dtype pairs, each call
    # repeated bit for bit with the counters left zeroed
    widths = set()
    for edge in PAGED_EDGES:
        for q_dt, kv_dt in DTYPE_PAIRS:
            err, p = paged_case(torch, gen, kernel, ref, *edge,
                                getattr(torch, q_dt), getattr(torch, kv_dt))
            widths.add((kv_dt, p.vec_bytes))
            print(f"kernel edge B,H,K,D,ps,lengths,window,NP={edge} q {q_dt} "
                  f"pool {kv_dt} (L {p.split_len}, {p.n_split} splits, "
                  f"{p.vec_bytes}-byte loads, tile {p.tile}): max abs err "
                  f"{err:.3e}, two calls bit for bit")
    want = {("bfloat16", w) for w in (2, 4, 8, 16)} | {
        ("float32", w) for w in (4, 8, 16)}
    assert widths == want, widths
    print(f"kernel edges: every load width ran ({sorted(widths)}); the "
          f"merge's counters zero after every call")

    # timed at h2o-danube3-4b's windowed decode shape, at the serve
    # phase's shape (10-entry tables, max_len 160), at one slot of
    # granite's 4096-token context, and at granite's decode shape with
    # lengths up to 1024, which the JSON line reports
    ring_timing(torch, kernel, ref)
    return paged_timings(torch, kernel, ref)[-1]


def paged_timings(torch, kernel, ref) -> list[dict]:
    """:func:`timing` at the serve phase's shape, one slot at 4096
    positions and granite's decode shape, on inputs drawn from ``SEED``
    (the same for any kernel module: ``tools/paged_timing.py``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, h, kh, d, max_len, ps = GRANITE_DECODE
    return [timing(torch, gen, kernel, ref, b, h, kh, d, 160, ps),
            timing(torch, gen, kernel, ref, 1, h, kh, d, LONG_CONTEXT, ps,
                   fixed=True),
            timing(torch, gen, kernel, ref, b, h, kh, d, max_len, ps)]


def timing(torch, gen, kernel, ref, b, h, kh, d, max_len, ps,
           fixed=False) -> dict:
    """Kernel, plain version and SDPA times on one bf16 case, its bound, and
    the kernel's error against the plain version; two kernel calls give the
    same bits. Kernel and SDPA are timed from a CUDA graph (the device's
    time, the JSON line's ``ms`` and ``library_ms``; each call's host time
    to issue it is tens of us, more than the kernel's) and eagerly; SDPA on
    KV gathered in advance and with the gather from the pool in each call.
    """
    copies = 8
    q, kp, vp, tables, lengths = pool_case(
        torch, gen, b, h, kh, d, max_len, ps, None, torch.bfloat16,
        torch.bfloat16, copies=copies, fixed=fixed)
    got = kernel.paged_attention_cuda(q, kp[0], vp[0], tables, lengths)
    again = kernel.paged_attention_cuda(q, kp[0], vp[0], tables, lengths)
    want = ref.paged_attention(q, kp[0], vp[0], tables, lengths)
    max_err = close(got, want, TOL["bfloat16"])
    assert torch.equal(got, again), "two calls differ"
    call = lambda i: kernel.paged_attention_cuda(  # noqa: E731
        q, kp[i], vp[i], tables, lengths)
    ms = graph_ms(torch, rotating(call, copies), inner=48)
    eager_ms = time_ms(torch, call, copies)
    plain_ms = time_ms(torch, lambda i: ref.paged_attention(
        q, kp[i], vp[i], tables, lengths), copies, inner=10, reps=11)
    # yardstick: SDPA on the same KV gathered contiguous (outside the timing)
    s = tables.shape[1] * ps
    tl = tables.long()
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None]
    qs = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) < (2, 5):
        # no enable_gqa before torch 2.5: give SDPA the KV heads repeated
        heads, gqa = (lambda x: x.repeat_interleave(h // kh, dim=-3)), {}
    else:
        heads, gqa = (lambda x: x), {"enable_gqa": True}

    def gather(pool):           # (..., P, ps, K, D) -> (..., B, K, S, D)
        return heads(pool[..., tl, :, :, :].reshape(
            *pool.shape[:-4], b, s, kh, d).transpose(-3, -2))

    kc, vc = gather(kp).contiguous(), gather(vp).contiguous()
    pre = lambda i: sdpa(qs, kc[i], vc[i], attn_mask=mask, **gqa)  # noqa: E731
    library_ms = graph_ms(torch, rotating(pre, copies), inner=48)
    library_eager_ms = time_ms(torch, pre, copies)
    gather_ms = graph_ms(torch, rotating(
        lambda i: sdpa(qs, gather(kp[i]), gather(vp[i]), attn_mask=mask,
                       **gqa), copies), inner=48)
    del kc, vc
    n_pos = int(lengths.sum())
    elt = 2                                     # bf16
    moved = (2 * n_pos * kh * d * elt           # k and v, each read once
             + 2 * b * h * d * elt              # q in, o out
             + tables.numel() * 4 + lengths.numel() * 4)
    ops = 4 * n_pos * h * d                     # q.k and p.v multiply-adds
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    # a kernel module without a plan (an earlier design) is timed alike
    plan = getattr(kernel, "plan", None)
    p = plan and plan(b, h, kh, d, tables.shape[1], ps, None, q.dtype, kp.dtype)
    cut = (f" (L {p.split_len}, {p.n_split} splits, {p.vec_bytes}-byte "
           f"loads)" if p else "")
    print(f"paged attention at B={b} H={h} K={kh} D={d} ps={ps} "
          f"NP={tables.shape[1]}, {n_pos} positions{cut}, from a CUDA graph "
          f"(issued eagerly): kernel {ms:.4f} ms ({eager_ms:.4f}; "
          f"{moved / ms / 1e6:.0f} GB/s), sdpa {library_ms:.4f} ms "
          f"({library_eager_ms:.4f}) on KV gathered in advance, {gather_ms:.4f} "
          f"ms with the gather; plain {plain_ms:.4f} ms; bound "
          f"{max(t_bytes, t_ops):.4f} ms ({moved} bytes); max abs err "
          f"{max_err:.3e}, two calls bit for bit", flush=True)
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:105",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def ring_timing(torch, kernel, ref) -> dict:
    """The kernel at h2o-danube3-4b's decode shape (``DANUBE_DECODE``: 4
    slots at 4352 positions, each attending the last 4096 through a
    257-entry ring table, bf16), timed from a CUDA graph as :func:`timing`
    times it, against the plain version, and SDPA (enable_gqa) on the
    window's KV gathered contiguous in advance; its bound is the bytes of
    the 4096 positions' K and V, q, o and the tables at 3.35 TB/s."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    b, h, kh, d, ps, window = DANUBE_DECODE
    copies, np_slot = 8, -(-window // ps) + 1
    n_pages = b * np_slot + 1
    tables = torch.randperm(n_pages, generator=gen, device="cuda")[
        :b * np_slot].to(torch.int32).reshape(b, np_slot).contiguous()
    lengths = torch.full((b,), window + 256, dtype=torch.int32, device="cuda")
    shape = (copies, n_pages, ps, kh, d)
    kp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    call = lambda i: kernel.paged_attention_cuda(  # noqa: E731
        q, kp[i], vp[i], tables, lengths, window=window)
    got, again = call(0), call(0)
    want = ref.paged_attention(q, kp[0], vp[0], tables, lengths,
                               window=window)
    err, _ = close_scaled(got, want, TOL["bfloat16"], TOL["bfloat16"])
    assert torch.equal(got, again), "two calls differ"
    ms = graph_ms(torch, rotating(call, copies), inner=48)
    plain_ms = time_ms(torch, lambda i: ref.paged_attention(
        q, kp[i], vp[i], tables, lengths, window=window), copies, inner=10,
        reps=11)
    # the window's positions, oldest first, gathered contiguous per copy
    pos = torch.arange(window, device="cuda") + (lengths[0].item() - window)
    page = tables.long()[:, (pos // ps) % np_slot]          # (B, W)
    off = (pos % ps)[None].expand(b, -1)

    def gathered(pool):                                      # (C, B, K, W, D)
        return pool[:, page, off].transpose(2, 3).contiguous()

    kc, vc = gathered(kp), gathered(vp)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs = q[:, :, None]
    pre = lambda i: sdpa(qs, kc[i], vc[i], enable_gqa=True)  # noqa: E731
    library_ms = graph_ms(torch, rotating(pre, copies), inner=48)
    sdpa_err = (pre(0)[:, :, 0].float() - want.float()).abs().max().item()
    del kc, vc
    moved = (2 * b * window * kh * d * 2 + 2 * b * h * d * 2
             + tables.numel() * 4 + lengths.numel() * 4)
    ops = 4 * b * window * h * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    p = kernel.plan(b, h, kh, d, np_slot, ps, window, q.dtype, kp.dtype)
    print(f"paged attention at h2o-danube3-4b's decode shape B={b} H={h} "
          f"K={kh} D={d} ps={ps}, window {window} over a {np_slot}-entry "
          f"ring, lengths {window + 256} (L {p.split_len}, {p.n_split} "
          f"splits, {p.vec_bytes}-byte loads, tile {p.tile}), from a CUDA "
          f"graph: kernel {ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s), sdpa "
          f"{library_ms:.4f} ms on the window's KV gathered in advance (max "
          f"abs diff from plain {sdpa_err:.3e}); plain {plain_ms:.4f} ms; "
          f"bound {max(t_bytes, t_ops):.4f} ms ({moved} bytes); max abs err "
          f"{err:.3e}, two calls bit for bit", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops), "max_abs_err": err}


def serve_trace(np):
    rng = np.random.default_rng(SEED)
    system = [int(t) for t in rng.integers(1, 49155, 64)]
    reqs = []
    for i in range(16):
        tail = [int(t) for t in rng.integers(1, 49155, int(rng.integers(16, 49)))]
        reqs.append((f"req{i}", system + tail, 32))
    return reqs


def teacher_force(torch, registry, cfg, params, seq, page_size, device):
    """Logits (len(seq) - 1, V) of a one-slot decode fed ``seq`` token by
    token through ``decode_step_paged`` on a fresh pool."""
    n_pages = -(-len(seq) // page_size)
    pool_k, pool_v = registry.paged_pool_init(cfg, n_pages + 1, page_size,
                                              device=device)
    tables = torch.arange(n_pages, dtype=torch.int32)[None]
    out = []
    for t in range(len(seq) - 1):
        logits, _, _ = registry.decode_step_paged(
            params, cfg, pool_k, pool_v, tables,
            torch.tensor([t], dtype=torch.int32),
            torch.tensor([seq[t]], dtype=torch.int32),
            append_mask=torch.tensor([True]))
        out.append(logits[0].float())
    return torch.stack(out)


def serve_phase(torch, np, kernel, ref, card: str):
    """Returns the kernel's launches on the greedy path and the greedy
    run's completions by id."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import count_params, init_tree

    cfg = configs.get("granite_3_2b")
    t0 = time.perf_counter()
    params = init_tree(registry.decls(cfg), SEED, "cuda",
                       dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"granite-3-2b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{count_params(params)} parameters in bf16, made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    page_size = 16

    def serve(**kw):
        engine = ContinuousBatchingEngine(cfg, params, slots=8, max_len=160,
                                          device="cuda", page_size=page_size,
                                          prefill_chunk=16, **kw)
        for rid, prompt, n_new in serve_trace(np):
            assert engine.submit(Request(rid, prompt, n_new))
        decode_ms, steps = [], 0
        t0 = time.perf_counter()
        while True:
            before = engine.token_steps
            ts = time.perf_counter()
            if not engine.step():
                break
            dt = time.perf_counter() - ts   # step() ends with the tokens on the host
            steps += 1
            if engine.token_steps - before == 1:
                decode_ms.append(dt * 1e3)
        return engine, decode_ms, steps, time.perf_counter() - t0

    # the main path: the engine as a user builds it (metered, its own
    # platform), counted
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    engine, decode_ms, steps, wall = serve()
    launches = kernel.launches
    stats = engine.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    done = {r.id: r for r in engine.completed}
    assert len(done) == 16, f"{len(done)} of 16 requests completed"
    for r in done.values():
        assert len(r.tokens) == r.max_new_tokens, (r.id, len(r.tokens))
        assert all(0 <= t < cfg.vocab for t in r.tokens), r.id
    assert stats["prompt_tokens_reused"] > 0, stats
    want = cfg.n_layers * stats["token_steps"]
    assert launches == want, f"kernel launches {launches} != {want}"
    print(f"serve: {steps} engine steps, {stats['token_steps']} one-token "
          f"steps, {stats['tokens_generated']} tokens, "
          f"{stats['prompt_tokens_reused']} prompt tokens reused; kernel "
          f"launches {launches} = {cfg.n_layers} layers x "
          f"{stats['token_steps']} steps")
    print(f"serve on {card}: decode step {statistics.median(decode_ms):.3f} ms "
          f"(median of {len(decode_ms)} decode-only steps), "
          f"{stats['tokens_generated'] / wall:.1f} tokens/s over {wall:.3f} s, "
          f"peak memory {peak_gb:.2f} GB")

    # the platform surface: one admit and one complete interrupt per
    # request, and a conserving meter
    irq = engine.platform.interrupts
    assert (irq.count("serve.admit"), irq.count("serve.complete")) == (16, 16)
    en = stats["energy"]
    per_request = sum(r.energy_uj for r in engine.completed)
    assert abs(en["total_uj"] - (en["attributed_uj"] + en["overhead_uj"])) \
        <= 1e-9 * en["total_uj"], en
    assert abs(en["attributed_uj"] - per_request) <= 1e-9 * per_request, en
    banks = engine.platform.power.states
    print(f"serve metering: {irq.count('serve.admit')} serve.admit and "
          f"{irq.count('serve.complete')} serve.complete interrupts; meter "
          f"total {en['total_uj']:.6f} uJ = attributed "
          f"{en['attributed_uj']:.6f} + overhead {en['overhead_uj']:.6f} "
          f"(= sum of Request.energy_uj within 1e-9 relative), "
          f"{en['projected_uj_per_token']:.4f} uJ per decode token at "
          f"{en['point']}; banks at the end: "
          f"{sorted((k, v.value) for k, v in banks.items() if k != 'host')}")
    # the meter only observes: unmetered runs give the same completions;
    # decode steps metered and not, in turns (metered, unmetered, metered)
    plain_engine, plain_ms, _, _ = serve(metered=False)
    again, again_ms, _, _ = serve()
    greedy = {r.id: r.tokens for r in engine.completed}
    assert {r.id: r.tokens for r in plain_engine.completed} == greedy
    assert {r.id: r.tokens for r in again.completed} == greedy
    assert "energy" not in plain_engine.stats()
    print(f"serve decode step on {card}, metered {statistics.median(decode_ms):.3f}"
          f" ms (main run), unmetered {statistics.median(plain_ms):.3f} ms, "
          f"metered again {statistics.median(again_ms):.3f} ms (medians); the "
          f"unmetered engine's 16 completions equal the metered ones")
    del plain_engine, again

    # teacher-force the last request (it adopted the shared prefix) through
    # the kernel path; every attention call is held to the plain version on
    # the same inputs (the pool, tables and lengths of the main path)
    req = engine.completed[-1]
    seq = list(req.prompt) + req.tokens
    errs, f64 = [], {"kernel": 0.0, "plain": 0.0, "score": 0.0}

    def checked(q, k_pool, v_pool, tables, lengths, *, window=None):
        got = kernel.paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                          window=window)
        want = ref.paged_attention(q, k_pool, v_pool, tables, lengths,
                                   window=window)
        errs.append(close(got, want, TOL["bfloat16"]))
        exact, score = attention_f64(torch, q, k_pool, v_pool, tables, lengths)
        f64["kernel"] = max(f64["kernel"], (got - exact).abs().max().item())
        f64["plain"] = max(f64["plain"], (want - exact).abs().max().item())
        f64["score"] = max(f64["score"], score)
        return got

    with on_cuda("paged_attention", checked):
        logits = teacher_force(torch, registry, cfg, params, seq, page_size,
                               "cuda")
    assert bool(torch.isfinite(logits).all())
    print(f"teacher-forced {req.id} ({len(seq) - 1} steps, {len(errs)} "
          f"attention calls): kernel vs plain on each call's inputs, max abs "
          f"err {max(errs):.3e} (tolerance {TOL['bfloat16']} + "
          f"{TOL['bfloat16']} * |plain|); against float64, max abs err "
          f"kernel {f64['kernel']:.3e}, plain {f64['plain']:.3e}, largest "
          f"|score| {f64['score']:.1f}; logits finite")

    # why the full-width logits are not compared across paths: at depth 40
    # this random-weight model is chaotic; a perturbation of 2^-9 (one bf16
    # ulp) on the plain path's attention output diverges as far as the kernel
    # path does. Printed, not asserted.
    short = seq[:17]
    with on_cuda("paged_attention", ref.paged_attention):
        plain = teacher_force(torch, registry, cfg, params, short, page_size,
                              "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def perturbed(*args, **kw):
        o = ref.paged_attention(*args, **kw).float()
        noise = torch.randn(o.shape, generator=gen, device=o.device)
        return (o * (1 + 2.0 ** -9 * noise)).to(args[0].dtype)

    with on_cuda("paged_attention", perturbed):
        noisy = teacher_force(torch, registry, cfg, params, short, page_size,
                              "cuda")
    fmt = lambda d: " ".join(f"{x:.3f}" for x in d.abs().amax(-1).tolist())
    print(f"full-width teacher-forced logits, max abs diff per step: kernel "
          f"vs plain path: {fmt(logits[:16] - plain)}; plain vs plain with "
          f"its attention output perturbed by 2^-9: {fmt(noisy - plain)}")
    profile_phase(torch, np, cfg, params, card)
    return launches, greedy


def dev_us(event) -> float:
    """Device time (us) of a profiler event, across torch versions."""
    return (getattr(event, "self_device_time_total", None)
            or event.self_cuda_time_total)


def kernel_name(key: str) -> str:
    """A profiler kernel's name without return type, namespace and
    arguments: ``flash_bwd_dq_mma_kernel<64, 2>``."""
    name = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0]


def device_profile(torch, fn, n: int = 1):
    """Wall ms, device-busy ms and launches per call of ``fn`` under
    ``torch.profiler`` (``n`` calls), and the device kernels by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    return wall_ms, busy_ms, launches / n, kernels


def profile_phase(torch, np, cfg, params, card: str) -> None:
    """Where a decode step's time goes: three engine-shaped one-token steps
    (8 lanes at 100 cached positions, greedy) under ``torch.profiler``."""
    from repro_torch.models import registry
    from repro_torch.serve import sampling
    from repro_torch.serve.paged import paged_step_fn

    step = paged_step_fn(cfg)
    pool_k, pool_v = registry.paged_pool_init(cfg, 81, 16, device="cuda")
    args = (np.arange(80, dtype=np.int32).reshape(8, 10),
            np.full((8,), 100, np.int32), np.arange(8, dtype=np.int32), None,
            None, np.ones((8,), bool), np.ones((8,), bool),
            sampling.zero_keys(8), np.zeros((8,), np.float32),
            np.zeros((8,), np.int32), np.ones((8,), np.float32))
    for _ in range(3):
        step(params, pool_k, pool_v, *args)[0].cpu()
    n = 3
    wall_ms, busy_ms, launches, kernels = device_profile(
        torch, lambda: step(params, pool_k, pool_v, *args)[0].cpu(), n)
    paged = [e for e in kernels if "paged_attention_kernel" in e.key]
    top = "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3 / n:.3f} ms"
                    for e in kernels[:5])
    print(f"profile on {card}, one-token step, 8 lanes x 100 positions: "
          f"wall {wall_ms:.3f} ms (under the profiler), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches:.0f} kernel launches per step; paged attention "
          f"{dev_us(paged[0]) / paged[0].count:.2f} us per call x "
          f"{paged[0].count // n} calls; top device time: {top}")


def sampler_profile(torch, np, cfg, params, card: str) -> None:
    """The profile phase's one-token step with lanes 0, 2, 4 and 6 sampled
    (temperature 0.8, top_k 50, top_p 0.9), and the sampler alone on that
    step's logits, under ``torch.profiler``."""
    from repro_torch.models import registry
    from repro_torch.serve import sampling
    from repro_torch.serve.paged import paged_step_fn

    step = paged_step_fn(cfg)
    pool_k, pool_v = registry.paged_pool_init(cfg, 81, 16, device="cuda")
    keys = torch.stack([sampling.seed_key(100 + i) for i in range(8)])
    mixed = np.where(np.arange(8) % 2 == 0, 0.8, 0.0).astype(np.float32)
    args = (np.arange(80, dtype=np.int32).reshape(8, 10),
            np.full((8,), 100, np.int32), np.arange(8, dtype=np.int32), None,
            None, np.ones((8,), bool), np.ones((8,), bool), keys, mixed,
            np.full((8,), 50, np.int32), np.full((8,), 0.9, np.float32))
    for _ in range(3):
        step(params, pool_k, pool_v, *args)[0].cpu()
    n = 3
    wall_ms, busy_ms, launches, _ = device_profile(
        torch, lambda: step(params, pool_k, pool_v, *args)[0].cpu(), n)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    logits = torch.randn((8, cfg.padded_vocab), generator=gen,
                         device="cuda").to(torch.bfloat16)
    inputs = (logits, keys.cuda(), torch.from_numpy(mixed).cuda(),
              torch.full((8,), 50, device="cuda"),
              torch.full((8,), 0.9, device="cuda"))
    for _ in range(3):
        sampling.sample(*inputs)
    s_wall, s_busy, s_launches, _ = device_profile(
        torch, lambda: sampling.sample(*inputs), n)
    print(f"profile on {card}, the profile phase's one-token step with 4 of "
          f"8 lanes sampled (temperature 0.8, top_k 50, top_p 0.9): wall "
          f"{wall_ms:.3f} ms (under the profiler), device busy "
          f"{busy_ms:.3f} ms, {launches:.0f} kernel launches per step; the "
          f"sampler alone on (8, {cfg.padded_vocab}) bf16 logits: "
          f"{s_busy:.3f} ms of device time, {s_launches:.0f} launches, wall "
          f"{s_wall:.3f} ms under the profiler", flush=True)


MIXED = {"temperature": 0.8, "top_k": 50, "top_p": 0.9, "seed": 100}


def mixed_sampling(i: int):
    """Request ``i``'s sampling in the mixed traces: every second request
    sampled (temperature 0.8, top_k 50, top_p 0.9, seed 100 + i), the
    others greedy (None)."""
    from repro_torch.serve.sampling import SamplingParams

    if i % 2:
        return None
    return SamplingParams(MIXED["temperature"], MIXED["top_k"],
                          MIXED["top_p"], MIXED["seed"] + i)


def meter_conserves(engine) -> None:
    en = engine.stats()["energy"]
    per_request = sum(r.energy_uj for r in engine.completed)
    assert abs(en["total_uj"] - (en["attributed_uj"] + en["overhead_uj"])) \
        <= 1e-9 * en["total_uj"], en
    assert abs(en["attributed_uj"] - per_request) <= 1e-9 * per_request, en


def chain_key(chains: dict, seed: int, n: int):
    """The key of seed ``seed``'s chain after ``n`` emitting launches,
    recomputed on the CPU (memoised in ``chains``)."""
    from repro_torch.serve import sampling

    if (seed, n) not in chains:
        chains[seed, n] = (sampling.seed_key(seed) if n == 0 else
                           sampling.split_keys(chain_key(
                               chains, seed, n - 1)[None])[0][0])
    return chains[seed, n]


def sampled_engine_phase(torch, np, kernel, greedy: dict, card: str) -> dict:
    """Full-width granite-3-2b on the paged backend (8 slots, 16-token
    pages, chunk 16, metered), :func:`serve_trace` with every second
    request sampled (:func:`mixed_sampling`), all submitted at once so that
    siblings stall on the first one's dedup claims and re-match its pages:
    served sync, async, and async preempted twice mid-trace. Checks sync ≡
    async ≡ replayed bit for bit (the journal cross-checks every replayed
    token), the greedy requests' tokens equal to the all-greedy run's
    (``greedy``), every attention call through the kernel, stalls and
    re-matches, the meter's conservation; and in the preempted run, after
    every step, the merge's counters zero and every occupied lane's key
    equal to its chain recomputed on the CPU from (seed, produced count),
    and every sampler call's tokens equal to the CPU's plain ``sample`` on
    the same logits and keys (greedy lanes always, sampled lanes where the
    top-2 gap of ``scores`` exceeds 1e-4 and the card's and the CPU's
    filters keep the same tokens). Prints decode-step time, tokens/s and a
    profiled window's busy share for sync and async, and profiles a
    one-token step with sampled lanes and the sampler alone
    (:func:`sampler_profile`). Runs last: after its profiled windows the
    profiler reports fewer of a later window's kernels than it launched,
    the more such windows came before (on an H100 with torch 2.11: the
    flash phase's by-kernel check failed when this phase ran before it),
    and every earlier phase checks its profiles by kernel.
    Makes the serve phase's weights again from the seed. Returns the
    kernel's launches by run."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve import sampling
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import init_tree

    cfg = configs.get("granite_3_2b")
    params = init_tree(registry.decls(cfg), SEED, "cuda",
                       dtype=torch.bfloat16)

    reqs = serve_trace(np)
    sampled = {rid for i, (rid, _, _) in enumerate(reqs)
               if mixed_sampling(i) is not None}
    dev = torch.device("cuda", torch.cuda.current_device())

    def engine_for(**kw):
        eng = ContinuousBatchingEngine(cfg, params, slots=8, max_len=160,
                                       device="cuda", page_size=16,
                                       prefill_chunk=16, **kw)
        for i, (rid, prompt, n_new) in enumerate(reqs):
            assert eng.submit(Request(rid, prompt, n_new,
                                      sampling=mixed_sampling(i)))
        return eng

    def check(eng, launches):
        stats = eng.stats()
        assert len(eng.completed) == 16, len(eng.completed)
        for r in eng.completed:
            assert len(r.tokens) == r.max_new_tokens, r.id
        assert launches == cfg.n_layers * stats["token_steps"], (
            launches, stats["token_steps"])
        assert stats["stalls"] > 0 and stats["rematches"] > 0, stats
        assert stats["sampled_requests"] >= 8, stats
        assert stats["journal"]["in_flight"] == 0, stats["journal"]
        meter_conserves(eng)
        return {r.id: r.tokens for r in eng.completed}, stats

    runs = {}
    for mode in ("sync", "async"):
        eng = engine_for(async_dispatch=mode == "async")
        decode_ms, prof = [], {}
        torch.cuda.synchronize()
        kernel.launches = 0
        t0 = time.perf_counter()
        while True:
            full = (not eng.queue and eng.steps > 0 and all(
                sl is not None and not sl.prefilling for sl in eng.slots))
            if full and not prof:
                prof["out"] = device_profile(torch, eng.step, 5)
                continue
            before = eng.token_steps
            ts = time.perf_counter()
            if not eng.step():
                break
            if eng.token_steps - before == 1:
                decode_ms.append((time.perf_counter() - ts) * 1e3)
        wall = time.perf_counter() - t0
        tokens, stats = check(eng, kernel.launches)
        runs[mode] = (tokens, stats, kernel.launches, decode_ms, wall,
                      prof["out"])
    assert runs["async"][0] == runs["sync"][0], "async != sync"
    for rid, toks in runs["sync"][0].items():
        if rid not in sampled:
            assert toks == greedy[rid], f"{rid}: greedy lane moved"
    assert any(runs["sync"][0][rid] != greedy[rid] for rid in sampled)
    st = runs["sync"][1]
    print(f"sampled engine: granite-3-2b, 16 requests (8 sampled: "
          f"temperature {MIXED['temperature']}, top_k {MIXED['top_k']}, "
          f"top_p {MIXED['top_p']}, seeds 100 + i), all submitted at once: "
          f"{st['steps']} engine steps, {st['token_steps']} one-token "
          f"steps, {st['stalls']} stalls, {st['rematches']} re-matches "
          f"({st['rematched_tokens']} tokens), "
          f"{st['prompt_tokens_reused']} prompt tokens reused; async tokens "
          f"equal sync's bit for bit; the 8 greedy requests equal the "
          f"all-greedy run's; kernel launches {runs['sync'][2]} (sync), "
          f"{runs['async'][2]} (async) = {cfg.n_layers} layers x one-token "
          f"steps; the meter conserves", flush=True)
    for mode, (_, stats, _, decode_ms, wall, prof) in runs.items():
        wall_ms, busy_ms, launches, _ = prof
        step_ms = statistics.median(decode_ms)
        print(f"sampled engine on {card}, {mode}: decode step "
              f"{step_ms:.3f} ms (median of {len(decode_ms)} one-token "
              f"steps), {stats['tokens_generated'] / wall:.1f} tokens/s over "
              f"{wall:.3f} s; 5 decode steps of 8 lanes under the profiler: "
              f"{wall_ms:.3f} ms a step, device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}% under the profiler, "
              f"{100 * busy_ms / step_ms:.1f}% of the median step), "
              f"{launches:.0f} launches a step", flush=True)

    # async, preempted twice, with every step and sampler call checked
    records, real_sample, chains = [], sampling.sample, {}

    def recording(logits, keys, temp, top_k, top_p):
        out = real_sample(logits, keys, temp, top_k, top_p)
        records.append(tuple(t.detach().cpu().clone() for t in
                             (logits, keys, temp, top_k, top_p, out)))
        return out

    eng = engine_for(async_dispatch=True)
    torch.cuda.synchronize()
    kernel.launches = 0
    n = steps_checked = 0
    cut = []
    with mock.patch.object(sampling, "sample", recording):
        while eng.step():
            n += 1
            buf = kernel.counter_buffer(dev)
            assert buf is None or not bool(buf.any()), f"counters, step {n}"
            for i, slot in enumerate(eng.slots):
                if slot is None:
                    continue
                sp = slot.request.sampling
                want = chain_key(chains, sp.seed if sp else 0,
                                 slot.produced)
                assert torch.equal(eng._keys[i], want), (n, i)
            steps_checked += 1
            if n in (12, 40):
                cut.append(len(eng.preempt()))
    launches = kernel.launches
    tokens, stats = check(eng, launches)
    assert all(cut) and stats["steps"] > runs["sync"][1]["steps"], cut
    assert tokens == runs["sync"][0], "replay after preempt() != undisturbed"
    calls = lanes = 0
    for logits, keys, temp, top_k, top_p, out in records:
        cpu = real_sample(logits, keys, temp, top_k, top_p)
        clear = temp == 0
        rows = torch.nonzero(~clear)[:, 0]        # the sampled lanes
        args = (logits[rows], keys[rows], temp[rows], top_k[rows],
                top_p[rows])
        z = sampling.scores(*args)
        z_card = sampling.scores(*(t.cuda() for t in args)).cpu()
        top2 = z.topk(2, -1).values
        clear[rows] = ((top2[:, 0] - top2[:, 1] > 1e-4)
                       & (z.isfinite() == z_card.isfinite()).all(-1))
        assert torch.equal(cpu[clear], out[clear]), "card != CPU sample"
        calls += 1
        lanes += int(clear.sum())
    print(f"sampled engine, async, preempted at steps 12 and 40 ({cut} "
          f"requests requeued): {stats['steps']} engine steps, tokens equal "
          f"the undisturbed run's bit for bit (journal cross-check on); after "
          f"each of {steps_checked} steps the merge's counters were zero and "
          f"every occupied lane's key equalled its chain recomputed on the "
          f"CPU from (seed, produced count); {calls} sampler calls compared "
          f"with the CPU's plain sample on the same logits and keys, "
          f"{lanes} of {8 * calls} lanes clear (greedy, or top-2 gap of the "
          f"scores > 1e-4 with equal filters) and equal; kernel launches "
          f"{launches}", flush=True)
    sampler_profile(torch, np, cfg, params, card)
    return {"engine, mixed sampling, sync": runs["sync"][2],
            "engine, mixed sampling, async": runs["async"][2],
            "engine, mixed sampling, async, preempted twice": launches}


def small_reference_phase(torch, np) -> None:
    """The card's path against the CPU's plain path on a small input: the
    granite smoke config (3 layers, float32 activations, bf16 pool), whose
    greedy margins are checked first. The engine's completions on the card
    equal those on the CPU, and teacher-forced logits agree."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import init_tree, tree_map

    cfg = dataclasses.replace(configs.smoke("granite_3_2b"), dtype="float32")
    params = init_tree(registry.decls(cfg), SEED, "cpu")
    # logits of O(1): the smoke embedding's 0.02 std leaves margins at the
    # level of the bf16 pool's rounding
    params["embed"] = params["embed"] * 10.0
    rng = np.random.default_rng(SEED)
    prefix = [int(t) for t in rng.integers(1, 256, 9)]
    reqs = [(f"s{i}", prefix + [int(t) for t in rng.integers(1, 256, 1 + i % 4)],
             4 + i % 3) for i in range(6)]
    out = {}
    for dev, metered in (("cpu", True), ("cuda", True), ("cuda", False)):
        p = tree_map(lambda t: t.to(dev), params)
        eng = ContinuousBatchingEngine(cfg, p, slots=3, max_len=32, device=dev,
                                       page_size=4, prefill_chunk=4,
                                       metered=metered)
        for r in reqs:
            eng.submit(Request(*r))
        eng.run_until_idle()
        out[dev if metered else "unmetered"] = {r.id: r.tokens
                                                for r in eng.completed}
        assert eng.stats()["prompt_tokens_reused"] > 0
        assert ("energy" in eng.stats()) == metered
    assert out["unmetered"] == out["cuda"], (out["unmetered"], out["cuda"])
    margin = float("inf")
    for rid, prompt, _ in reqs:
        seq = list(prompt) + out["cpu"][rid]
        lg = teacher_force(torch, registry, cfg, params, seq, 4, "cpu")
        top2 = lg[len(prompt) - 1:].topk(2, dim=-1).values
        margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item())
    assert margin > 1e-2, f"greedy margin {margin} too small to compare tokens"
    assert out["cuda"] == out["cpu"], (out["cuda"], out["cpu"])
    rid, prompt, _ = reqs[-1]
    seq = list(prompt) + out["cuda"][rid]
    p = tree_map(lambda t: t.to("cuda"), params)
    got = teacher_force(torch, registry, cfg, p, seq, 4, "cuda")
    with on_cuda("paged_attention", ref.paged_attention):
        want = teacher_force(torch, registry, cfg, p, seq, 4, "cuda")
    err = close(got, want, TOL["bfloat16"])
    print(f"smoke granite on the card vs the CPU's plain path: {len(reqs)} "
          f"completions equal (greedy margin >= {margin:.3f}), and equal "
          f"metered and unmetered on the card; teacher-forced "
          f"kernel vs plain logits max abs err {err:.3e} (tolerance "
          f"{TOL['bfloat16']}, the bf16 pool's)")


# ---------------------------------------------------------------------------
# Flash attention (the training path)
# ---------------------------------------------------------------------------

# B, S, H, K, D, window, causal (tests/test_kernels.py:21-27)
ATTN_CASES = [
    (2, 64, 4, 2, 16, None, True),
    (1, 48, 4, 4, 48, None, True),
    (2, 40, 8, 2, 16, 24, True),
    (1, 96, 4, 1, 64, None, False),
    (2, 64, 4, 2, 120, None, True),
]
# B, Sq, Sk, H, K, D, window, causal: the edges of the bf16 kernels' tiles
# (64 keys a dK/dV block; 64 query rows a step at D <= 64, 16 at D <= 128;
# 64 queries a forward or dQ block, 16 a warp, 64 keys a step)
# the G of the audio and VLM families: G 1 (musicgen-large's MHA: the
# dK/dV kernel's sum over a group is one head) at D 64, ragged S over three
# tiles, a window, and four heads; G 8 at D 128 (internvl2-76b)
FLASH_G_EDGES = [
    (2, 200, 200, 4, 4, 64, None, True),
    (1, 130, 130, 8, 8, 64, 40, True),
    (3, 64, 64, 2, 2, 64, None, True),
    (1, 150, 150, 16, 2, 128, None, True),
]
FLASH_EDGES = [
    (2, 80, 80, 4, 2, 8, None, True),        # D 8 (k depth padded to 16)
    (1, 200, 200, 4, 2, 120, None, True),    # D 120, S 200: ragged 64 and 32 tiles
    (2, 200, 200, 4, 2, 64, None, True),     # S over three tiles, ragged
    (1, 300, 300, 8, 2, 32, None, True),     # G 4 over five key tiles
    (2, 230, 230, 4, 1, 64, 40, True),       # a window that ends inside a tile
    (1, 200, 200, 4, 2, 128, 50, True),      # the same at D 128 (32-row steps)
    (1, 72, 136, 4, 2, 64, None, False),     # non-causal, Sq < Sk
    (1, 150, 70, 4, 4, 16, None, False),     # non-causal, Sq > Sk
] + FLASH_G_EDGES
GRANITE_TRAIN = (2, 4096, 32, 8, 64)      # B, S, H, K, D: granite's training shape
GROK_ATTN = (8, 1024, 48, 8, 128)         # B, S, H, K, D: grok-1's prefill attention
BF16_OPS_PER_S = 989e12                   # H100 SXM dense bf16 tensor cores
# the backward's float32 tolerance: the reference's own for gradients of the
# flash path (tests/test_kernels.py:61, atol 2e-4), with the forward's rtol;
# dk and dv sum G * S products in another order than the plain version
GRAD_TOL = {"float32": (2e-4, 2e-5), "bfloat16": (3e-2, 3e-2)}


def grouped(torch, fn, q, k, v, *rest, n_out):
    """Run a plain flash function one KV head (and its query heads) at a
    time, so a full-size score matrix is never formed: at granite's training
    shape one KV group's float32 scores are 0.5 GB, all of them 4.3 GB.
    ``rest`` are (B, S, H, D) tensors (o, do) and (B, H, S) ones (lse)."""
    kh = k.shape[2]
    g = q.shape[2] // kh
    outs = []
    for j in range(kh):
        heads = slice(j * g, (j + 1) * g)
        extra = [x[:, heads] if x.dim() == 3 else x[:, :, heads] for x in rest]
        outs.append(fn(q[:, :, heads], k[:, :, j:j + 1], v[:, :, j:j + 1],
                       *extra))
    cat = []
    for i in range(n_out):
        parts = [o[i] for o in outs]
        dim = 1 if parts[0].dim() == 3 else 2
        cat.append(torch.cat(parts, dim=dim))
    return cat


def flash_inputs(torch, gen, b, s, h, kh, d, dtype, sk=None):
    mk = lambda n, rows: torch.randn((b, rows, n, d), generator=gen,
                                     device="cuda").to(dtype)
    sk = s if sk is None else sk
    return mk(h, s), mk(kh, sk), mk(kh, sk), mk(h, s)      # q, k, v, do


def flash_check(torch, fkernel, fref, q, k, v, do, causal, window,
                dtype_name) -> dict:
    """Kernel forward and backward against the plain versions (grouped by
    KV head) on the same inputs, each tensor at :func:`close_scaled`'s
    bound; returns ``{name: (max abs err, scale)}`` for o, lse, dq, dk, dv."""
    o, lse = routed_fwd(torch, fkernel, q, k, v, causal, window)
    wo, wlse = grouped(torch, lambda *a: fref.flash_attention_ref(
        *a, causal=causal, window=window), q, k, v, n_out=2)
    tol = TOL[dtype_name]
    out = {"o": close_scaled(o, wo, tol, tol),
           "lse": (close(lse, wlse, TOL["float32"]), 1.0)}
    grads = fkernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=causal, window=window)
    want = grouped(torch, lambda *a: fref.flash_attention_bwd_ref(
        *a, causal=causal, window=window), q, k, v, o, lse, do, n_out=3)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        out[name] = close_scaled(g, w, *GRAD_TOL[dtype_name])
    return out


def routed_fwd(torch, fkernel, q, k, v, causal, window):
    """The CUDA forward, checked by the route the C entry reports: bf16 on
    the tensor cores, float32 on the CUDA cores, at every D."""
    mma0 = fkernel.launches_fwd_mma
    out = fkernel.flash_attention_fwd_cuda(q, k, v, causal=causal,
                                           window=window)
    on_mma = int(q.dtype == torch.bfloat16)
    assert fkernel.launches_fwd_mma - mma0 == on_mma, (q.dtype, q.shape)
    return out


def fmt_errs(errs: dict) -> str:
    return ", ".join(f"{k} {e:.3e}" + ("" if k == "lse" else f" (scale {s:.3e})")
                     for k, (e, s) in errs.items())


def flash_bound_ms(b, s, h, kh, d, elt, pairs, backward: bool):
    """Least time for the call on the card: the larger of its FLOPs over the
    bf16 tensor-core peak and its bytes (each input read once, each output
    written once) over the memory rate. ``pairs`` is the number of visible
    (query, key) pairs per (batch, head)."""
    per_pair = 10 * d if backward else 4 * d        # 5 products vs 2
    flops = per_pair * b * h * pairs
    q_bytes, kv_bytes, row = b * s * h * d * elt, b * s * kh * d * elt, b * h * s * 4
    if backward:   # q, k, v, o, do, lse in; dq, dk, dv out (delta in between)
        moved = 4 * q_bytes + 4 * kv_bytes + row
    else:          # q, k, v in; o, lse out
        moved = 2 * q_bytes + 2 * kv_bytes + row
    t_ops, t_bytes = flops / BF16_OPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_phase(torch, fkernel, fref) -> list[dict]:
    """The flash kernels against their plain versions on the reference's
    cases (float32 and bfloat16), against float64 at one small shape, and
    at granite's training shape; then times kernel, plain version and SDPA
    at that shape. Returns the two kernels' JSON entries (no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for case in ATTN_CASES:
        b, s, h, kh, d, win, causal = case
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            q, k, v, do = flash_inputs(torch, gen, b, s, h, kh, d, dt)
            errs = flash_check(torch, fkernel, fref, q, k, v, do, causal, win,
                               name)
            print(f"flash case B,S,H,K,D,window,causal={case} {name}: max abs "
                  f"err {fmt_errs(errs)}")
    for case in FLASH_EDGES:
        b, sq, sk, h, kh, d, win, causal = case
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            q, k, v, do = flash_inputs(torch, gen, b, sq, h, kh, d, dt, sk=sk)
            errs = flash_check(torch, fkernel, fref, q, k, v, do, causal, win,
                               name)
            print(f"flash edge B,Sq,Sk,H,K,D,window,causal={case} {name}: max "
                  f"abs err {fmt_errs(errs)}")

    # float64 yardstick at one small shape: both float32 versions against it
    q, k, v, do = flash_inputs(torch, gen, 2, 96, 8, 2, 64, torch.float32)
    o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True, window=None)
    g = fkernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    po, plse = fref.flash_attention_ref(q, k, v, causal=True)
    pg = fref.flash_attention_bwd_ref(q, k, v, po, plse, do, causal=True)
    x64 = [t.double() for t in (q, k, v, do)]
    eo, else_ = fref.flash_attention_ref(*x64[:3], causal=True)
    eg = fref.flash_attention_bwd_ref(*x64[:3], eo, else_, x64[3], causal=True)
    err = lambda a, b: max((x.double() - y).abs().max().item()
                           for x, y in zip(a, b))
    e_kernel, e_plain = err([o, *g], [eo, *eg]), err([po, *pg], [eo, *eg])
    assert e_kernel <= GRAD_TOL["float32"][0], e_kernel
    print(f"flash against float64 (B 2, S 96, H 8, K 2, D 64, causal): max abs "
          f"err of o, dq, dk, dv: kernel {e_kernel:.3e}, plain {e_plain:.3e}")

    b, s, h, kh, d = GRANITE_TRAIN
    q, k, v, do = flash_inputs(torch, gen, b, s, h, kh, d, torch.bfloat16)
    errs = flash_check(torch, fkernel, fref, q, k, v, do, True, None, "bfloat16")
    print(f"flash at granite's training shape B={b} S={s} H={h} K={kh} D={d} "
          f"bf16 causal: max abs err {fmt_errs(errs)} (bound tol * scale + "
          f"tol * |plain|, tol {TOL['bfloat16']}; lse {TOL['float32']} + "
          f"{TOL['float32']} * |plain|)")
    # no atomics: the same inputs give the same bits
    (o, lse), again = (fkernel.flash_attention_fwd_cuda(q, k, v, causal=True)
                       for _ in range(2))
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    del again
    first, second = (fkernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                      causal=True)
                     for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    del first, second
    print("flash at the training shape: two forward calls give bitwise equal "
          "o and lse, two backward calls bitwise equal dq, dk and dv")
    ms_fwd = time_ms(torch, lambda i: fkernel.flash_attention_fwd_cuda(
        q, k, v, causal=True), 1, inner=3, reps=7)
    ms_bwd = time_ms(torch, lambda i: fkernel.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=True), 1, inner=2, reps=5)
    _, busy, launches, kernels = device_profile(
        torch, lambda: fkernel.flash_attention_fwd_cuda(q, k, v, causal=True),
        n=3)
    # the device ran the tensor-core kernel, once a call
    assert [(kernel_name(e.key), e.count) for e in kernels] == [
        ("flash_fwd_mma_kernel<64>", 3)], [(e.key, e.count) for e in kernels]
    print(f"flash forward at the training shape, one call under the "
          f"profiler: {launches:.0f} launches, device {busy:.3f} ms: "
          + "; ".join(f"{kernel_name(e.key)} {dev_us(e) / e.count / 1e3:.3f} ms"
                      for e in kernels))
    _, busy, launches, kernels = device_profile(
        torch, lambda: fkernel.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        causal=True), n=3)
    print(f"flash backward at the training shape, one call under the "
          f"profiler: {launches:.0f} launches, device {busy:.3f} ms: "
          + "; ".join(f"{kernel_name(e.key)} {dev_us(e) / e.count / 1e3:.3f} ms"
                      for e in kernels))
    plain_fwd = time_ms(torch, lambda i: grouped(
        torch, lambda *a: fref.flash_attention_ref(*a, causal=True), q, k, v,
        n_out=2), 1, inner=1, reps=3)
    plain_bwd = time_ms(torch, lambda i: grouped(
        torch, lambda *a: fref.flash_attention_bwd_ref(*a, causal=True), q, k, v, o,
        lse, do, n_out=3), 1, inner=1, reps=3)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_fn = sdpa_gqa(torch, qs, ks, vs)
    with torch.no_grad():
        lib_fwd = time_ms(torch, lambda i: sdpa_fn(), 1, inner=10, reps=11)
    so = sdpa_fn()
    dos = do.transpose(1, 2)
    lib_bwd = time_ms(torch, lambda i: torch.autograd.grad(
        so, (qs, ks, vs), dos, retain_graph=True), 1, inner=10, reps=11)
    lib_both = time_ms(torch, lambda i: torch.autograd.grad(
        sdpa_fn(), (qs, ks, vs), dos), 1, inner=10, reps=11)
    pairs = s * (s + 1) // 2
    bound_f, by_f = flash_bound_ms(b, s, h, kh, d, 2, pairs, False)
    bound_b, by_b = flash_bound_ms(b, s, h, kh, d, 2, pairs, True)
    print(f"flash times at the training shape: forward kernel {ms_fwd:.3f} ms, "
          f"plain {plain_fwd:.3f} ms, sdpa {lib_fwd:.3f} ms, bound "
          f"{bound_f:.4f} ms ({by_f}); backward kernel {ms_bwd:.3f} ms, plain "
          f"{plain_bwd:.3f} ms, sdpa backward {lib_bwd:.3f} ms, bound "
          f"{bound_b:.4f} ms ({by_b}); sdpa forward+backward {lib_both:.3f} ms, "
          f"kernels forward+backward {ms_fwd + ms_bwd:.3f} ms")
    flash_shape(torch, fkernel, fref, gen, GROK_ATTN, False,
                "grok-1's prefill")
    src = "src/repro_torch/kernels/attention/csrc/flash_attention.cu"
    return [
        {"name": "flash_attention_fwd", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/attention/kernel.py:69",
         "max_abs_err": max(errs["o"][0], errs["lse"][0]), "ms": ms_fwd,
         "plain_ms": plain_fwd,
         "bound_ms": bound_f, "bound_by": by_f, "library_ms": lib_fwd},
        {"name": "flash_attention_bwd", "route": "cuda", "source": src,
         "replaces": "src/repro/models/layers.py:170",
         "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")),
         "ms": ms_bwd, "plain_ms": plain_bwd,
         "bound_ms": bound_b, "bound_by": by_b, "library_ms": lib_bwd},
    ]


def sdpa_gqa(torch, q, k, v):
    """SDPA (the yardstick, never called by the port) on (B, S, H, D)
    inputs, causal, KV heads shared by ``enable_gqa`` (repeated on torch
    before 2.5)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) < (2, 5):
        rep = q.shape[2] // k.shape[2]
        return lambda: sdpa(qs, ks.repeat_interleave(rep, 1),
                            vs.repeat_interleave(rep, 1), is_causal=True)
    return lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)


def train_phase(torch, np, fkernel, fref, card: str) -> tuple[int, int]:
    """Full-width, full-depth granite-3-2b trained by the training entry
    point (``repro_torch.launch.train``, ``--init true-fan-in``): 4 AdamW
    steps (global batch 4 in 2 microbatches, seq 4096, remat full) on
    ``LMPipeline`` batches. Checks finite, falling loss and the launch
    counts (every attention call went through the kernels), then holds
    every attention call of one microbatch to the plain version on that
    call's inputs, and profiles one step. Returns the forward and backward
    launch counts of the 4 steps."""
    from repro_torch import configs
    from repro_torch.data.lm import LMDataConfig, LMPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry, transformer
    from repro_torch.sharding.params import count_params, init_tree
    from repro_torch.train.trainer import TrainConfig, make_loss_fn

    cfg = configs.get("granite_3_2b")
    n_params = cfg.param_count()
    seq, global_batch, accum, steps, lr = 4096, 4, 2, 4, 3e-4
    argv = ["--arch", "granite-3-2b", "--init", "true-fan-in",
            "--steps", str(steps), "--global-batch", str(global_batch),
            "--accum", str(accum), "--seq", str(seq), "--lr", str(lr),
            "--optimizer", "adamw", "--seed", str(SEED)]
    # the launcher's init, loss and first batch, for the control and the
    # before/after loss on one fixed microbatch
    params = init_tree(registry.decls(cfg), SEED, "cuda",
                       dtype=torch.bfloat16)
    assert count_params(params) == n_params == 2_533_531_648
    loss_fn = make_loss_fn(cfg, TrainConfig(optimizer="adamw", lr=lr,
                                            accum=accum))
    mb = {k: v[0] for k, v in LMPipeline(LMDataConfig(
        vocab=cfg.vocab, seq=seq, global_batch=global_batch, accum=accum,
        seed=SEED)).batch_at(0).items()}

    # control: at the reference's own init the gradients of this 40-layer
    # model overflow (see transformer.true_fan_in; the launcher's default
    # init raises on its first step); printed, not asserted
    embed = params["embed"].detach().requires_grad_()
    grads = torch.autograd.grad(loss_fn(dict(params, embed=embed), mb)[0],
                                [embed])
    norm = torch.linalg.vector_norm(grads[0].float()).item()
    del grads, embed
    print(f"train control: at the reference's init, the embedding's gradient "
          f"norm on one microbatch is {norm:.4e}")
    with torch.no_grad():
        loss_before = loss_fn(transformer.true_fan_in(params, cfg),
                              mb)[0].item()
    del params
    torch.cuda.empty_cache()

    tokens = global_batch * seq
    # model FLOPs per step: 6 N T for the matmuls, and the causal attention
    # products (2 of them, 2 FLOPs per multiply-add) forward and twice that
    # backward; the remat recompute is not counted, as usual for mfu
    attn_flops = 3 * cfg.n_layers * global_batch * 4 * cfg.n_heads * \
        cfg.resolved_head_dim * (seq * (seq + 1) // 2)
    step_flops = 6 * n_params * tokens + attn_flops
    print(f"train: python -m repro_torch.launch.train {' '.join(argv)} "
          f"(granite-3-2b, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters in bf16, remat {cfg.remat})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fkernel.launches_fwd = fkernel.launches_bwd = fkernel.launches_fwd_mma = 0
    run = launch_train.main(argv)
    launches_fwd, launches_bwd = fkernel.launches_fwd, fkernel.launches_bwd
    # every forward (bf16, D 64) took the tensor-core kernel
    assert fkernel.launches_fwd_mma == launches_fwd, fkernel.launches_fwd_mma
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, times = run.losses, run.seconds
    for i, dt in enumerate(times):
        print(f"train step {i + 1}: {tokens / dt:.0f} tokens/s, mfu "
              f"{step_flops / (dt * BF16_OPS_PER_S):.4f}")
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert all(np.isfinite(run.grad_norms)), run.grad_norms
    assert losses[-1] < losses[0], losses
    assert torch.equal(run.data.batch_at(0)["tokens"][0], mb["tokens"])
    want = (steps * cfg.n_layers * accum * 2, steps * cfg.n_layers * accum)
    assert (launches_fwd, launches_bwd) == want, ((launches_fwd,
                                                   launches_bwd), want)
    steady = statistics.median(times[1:])
    print(f"train on {card}: step {steady:.3f} s (median of steps 2-{steps}; "
          f"step 1, the warm-up, {times[0]:.3f} s), {tokens / steady:.0f} "
          f"tokens/s, mfu {step_flops / (steady * BF16_OPS_PER_S):.4f} "
          f"({step_flops:.4e} FLOPs per step at 989 TFLOP/s), peak memory "
          f"{peak_gb:.2f} GB; flash launches {launches_fwd} forward (all "
          f"on the tensor-core kernel) = "
          f"{steps} steps x {cfg.n_layers} layers x {accum} microbatches x 2 "
          f"(forward and remat recompute), {launches_bwd} backward; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{' '.join(f'{x:.4f}' for x in run.grad_norms)}")

    # every attention call of one microbatch against the plain version on
    # that call's own inputs; the same microbatch before and after the 4
    # steps: a learning check free of the batch-to-batch noise of the
    # per-step losses
    loss = held_microbatch(torch, fref, loss_fn, run.params, mb,
                           cfg.n_layers, "train")
    assert loss < loss_before, (loss, loss_before)
    print(f"train: loss on the first microbatch {loss_before:.4f} before the "
          f"{steps} steps, {loss:.4f} after")
    train_profile(torch, run.train_step, run.params, run.opt_state,
                  run.data.batch_at(steps), card, launches_fwd // steps)
    return launches_fwd, launches_bwd


def held_microbatch(torch, fref, loss_fn, params, mb, n_layers: int,
                    label: str) -> float:
    """Every attention call of one microbatch's loss and backward held to
    the plain version on that call's own inputs (one KV-head group at a
    time), at bounds scaled to each tensor (``close_scaled``: the gradients
    of this mean loss are orders of magnitude below 1). The gradient's way
    in is the embedding table, or the embeddings of a batch that has them.
    Returns the microbatch's loss."""
    from repro_torch.kernels.attention import ops as attn_ops

    errs = {"fwd": [], "bwd": []}
    kernel_fwd, kernel_bwd = attn_ops._forward, attn_ops._backward

    def checked_fwd(q, k, v, causal, window):
        o, lse = kernel_fwd(q, k, v, causal, window)
        wo, wlse = grouped(torch, lambda *a: fref.flash_attention_ref(
            *a, causal=causal, window=window), q, k, v, n_out=2)
        close(lse, wlse, TOL["float32"])
        errs["fwd"].append(close_scaled(o, wo, TOL["bfloat16"],
                                        TOL["bfloat16"]))
        return o, lse

    def checked_bwd(q, k, v, o, lse, do, causal, window):
        got = kernel_bwd(q, k, v, o, lse, do, causal, window)
        want = grouped(torch, lambda *a: fref.flash_attention_bwd_ref(
            *a, causal=causal, window=window), q, k, v, o, lse, do, n_out=3)
        errs["bwd"] += [close_scaled(g, w, *GRAD_TOL["bfloat16"])
                        for g, w in zip(got, want)]
        return got

    if "embeds" in mb:
        way_in = mb["embeds"].to("cuda").requires_grad_()
        mb = dict(mb, embeds=way_in)
    else:
        way_in = params["embed"].detach().requires_grad_()
        params = dict(params, embed=way_in)
    with mock.patch.object(attn_ops, "_forward", checked_fwd), \
            mock.patch.object(attn_ops, "_backward", checked_bwd):
        loss, _ = loss_fn(params, mb)
        torch.autograd.grad(loss, [way_in])
    # remat "full": every forward runs twice, once more in the backward
    assert len(errs["fwd"]) == 2 * n_layers, len(errs["fwd"])
    assert len(errs["bwd"]) == 3 * n_layers, len(errs["bwd"])
    span = lambda xs: (f"max abs err {max(e for e, _ in xs):.3e}, scales "
                       f"{min(s for _, s in xs):.3e} to "
                       f"{max(s for _, s in xs):.3e}")
    print(f"{label}: every attention call of one microbatch held to the "
          f"plain version on its own inputs: {len(errs['fwd'])} forward "
          f"calls, o {span(errs['fwd'])} (bound {TOL['bfloat16']} * scale + "
          f"{TOL['bfloat16']} * |plain|; lse {TOL['float32']} + "
          f"{TOL['float32']} * |plain|), {len(errs['bwd']) // 3} backward "
          f"calls, dq/dk/dv {span(errs['bwd'])} (bound "
          f"{GRAD_TOL['bfloat16'][0]} * scale + {GRAD_TOL['bfloat16'][1]} * "
          f"|plain|)")
    return loss.item()


def train_profile(torch, train_step, params, state, batch, card: str,
                  fwd_per_step: int) -> None:
    """One train step under ``torch.profiler``: the device's busy share and
    the top device kernels. Checks by the device kernels' names that the
    step's ``fwd_per_step`` flash forwards all ran the tensor-core kernel."""
    wall_ms, busy_ms, launches, kernels = device_profile(
        torch, lambda: train_step(params, state, batch))
    fwd = {}
    for e in kernels:
        name = kernel_name(e.key)
        if name.startswith("flash_fwd"):
            fwd[name] = fwd.get(name, 0) + e.count
    assert fwd == {"flash_fwd_mma_kernel<64>": fwd_per_step}, fwd
    top = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in kernels[:8])
    print(f"train profile on {card}, one step: wall {wall_ms:.1f} ms (under "
          f"the profiler), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} kernel launches; "
          f"top device time: {top}")


def small_train_reference_phase(torch, np) -> None:
    """The card's training path against the CPU's plain path on a small
    input: the granite smoke config on tokens and the musicgen smoke
    config on float32 embeddings, in float32, the same params and the same
    numpy batches (attention projections at their true fan-in, which keeps
    the gradients well conditioned in float32), 2 AdamW steps. Loss and
    grad norm agree to 1e-5; AdamW's first steps move each element by
    about lr whatever its gradient's size, so an element whose gradient is
    below float32 noise may step either way: params agree to 2e-6 in all
    but 0.1% of the elements and, leaf by leaf, within 4 lr in every
    one."""
    from repro_torch import configs
    from repro_torch.models import registry, transformer
    from repro_torch.sharding.params import init_tree, tree_leaves, tree_map
    from repro_torch.train.trainer import TrainConfig, make_train_step

    rng = np.random.default_rng(SEED)
    for arch in ("granite_3_2b", "musicgen_large"):
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                                  remat="full")
        params = transformer.true_fan_in(
            init_tree(registry.decls(cfg), SEED, "cpu"), cfg)
        toks = rng.integers(0, cfg.vocab, size=(2, 2, 2, 97))
        if registry.uses_token_inputs(cfg):
            batches = [{"tokens": torch.from_numpy(t[..., :-1]),
                        "labels": torch.from_numpy(t[..., 1:])} for t in toks]
        else:
            emb = rng.normal(size=(2, 2, 2, 96, cfg.d_model)).astype(
                np.float32)
            batches = [{"embeds": torch.from_numpy(e),
                        "labels": torch.from_numpy(t[..., 1:])}
                       for e, t in zip(emb, toks)]
        tc = TrainConfig(accum=2)
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev, copy=True), params)
            step, opt = make_train_step(cfg, tc)
            state = opt.init(p)
            ms = [step(p, state, b)[2] for b in batches]
            out[dev] = ([float(m["loss"]) for m in ms],
                        [float(m["grad_norm"]) for m in ms],
                        [t.cpu() for t in tree_leaves(p)])
        (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
        np.testing.assert_allclose(lg, lc, rtol=1e-5)
        np.testing.assert_allclose(gg, gc, rtol=1e-5)
        leaf_max = [(a - b).abs().max().item() for a, b in zip(pg, pc)]
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
        # each AdamW step moves an element by at most about lr (|update| <=
        # 1.3 lr in the first two steps), so two steps stay within 4 lr
        assert max(leaf_max) <= 4 * tc.lr, leaf_max
        share = (diffs > 2e-6).float().mean().item()
        assert share < 1e-3, share
        inputs = ("tokens" if registry.uses_token_inputs(cfg)
                  else "float32 embeddings")
        print(f"small train reference ({cfg.name}, float32, {inputs}, 2 "
              f"steps of 2 x 2 x 96 positions) on the card vs the CPU's plain "
              f"path: losses {lg} vs {lc}, grad norms {gg} vs {gc}; params "
              f"max abs diff {max(leaf_max):.3e} (leaf by leaf, "
              f"{len(leaf_max)} leaves), {100 * share:.3f}% of elements "
              f"above 2e-6")


# ---------------------------------------------------------------------------
# RG-LRU scan and the hybrid family's serving (the serve driver's path)
# ---------------------------------------------------------------------------

# B, S, W (tests/test_kernels.py:110), then a ragged S and W and one step
RGLRU_CASES = [(2, 64, 32), (1, 128, 128), (3, 32, 64), (2, 200, 48), (1, 1, 3)]
# the kernels' tile of time steps (rglru_scan.cu's kTile, in blocks of 32
# lanes) and shapes that cross it: S under half a tile, at half a tile and
# past it, at T - 1, T, T + 1 and 2T + 3; W 3, 5, 17 and 2561 (4-byte
# copies, a ragged last group of lanes) and 36 (16-byte copies, a last
# group of 4 lanes); B 1 at recurrentgemma's width
RGLRU_TILE = 128
RGLRU_EDGES = ([(2, s, 48) for s in (63, 64, 65, 131, RGLRU_TILE - 1,
                                     RGLRU_TILE, RGLRU_TILE + 1,
                                     2 * RGLRU_TILE + 3)]
               + [(2, 131, 3), (3, 65, 5), (2, 70, 17), (1, 131, 2561),
                  (2, 67, 36), (1, 131, 2560)])
RG_PREFILL = (8, 4096, 2560)              # B, S, W: recurrentgemma's prefill scans
RG_ATTN = (8, 4096, 10, 1, 256, 2048)     # B, S, H, K, D, window: its attention
RG_SERVE = {"batch": 8, "prompt_len": 4096, "steps": 64}


def rglru_inputs(torch, gen, b, s, w):
    """a in [0, 0.95) as a gate's decay, b ~ N(0, 0.5^2), float32."""
    a = torch.rand((b, s, w), generator=gen, device="cuda") * 0.95
    bb = torch.randn((b, s, w), generator=gen, device="cuda") * 0.5
    return a, bb


def misaligned(torch, x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary (the RG-LRU kernels then take 4-byte copies)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def rglru_case(torch, gen, rkernel, rref, b, s, w, offset=False):
    """The forward kernel against its plain version: ``(errors of y and
    h_final, bitwise equal to it and a second call bit for bit)``; with
    ``offset`` the inputs start off 16-byte alignment."""
    a, bb = rglru_inputs(torch, gen, b, s, w)
    if offset:
        a, bb = misaligned(torch, a), misaligned(torch, bb)
    y, h = rkernel.rglru_scan_cuda(a, bb)
    wy, wh = rref.rglru(a, bb)
    errs = (close_scaled(y, wy, RGLRU_TOL, RGLRU_TOL),
            close_scaled(h, wh, RGLRU_TOL, RGLRU_TOL))
    y2, h2 = rkernel.rglru_scan_cuda(a, bb)
    return errs, all(torch.equal(*p) for p in ((y, wy), (h, wh), (y, y2),
                                                (h, h2)))


def rglru_phase(torch, rkernel, rref) -> dict:
    """The CUDA scan against its plain version on the reference's cases, a
    ragged S and W, one step, the edges of its tiles (``RGLRU_EDGES``) and
    inputs off 16-byte alignment, each bit for bit and two calls bit for
    bit; against float64; and at recurrentgemma-2b's training microbatch
    (:data:`RG_TRAIN_SCAN`, B 1) and prefill shape (B 8), each tensor at
    :func:`close_scaled`'s bound with the reference's atol 1e-5; times
    kernel and plain version at both. Returns the kernel's JSON entry (the
    prefill shape's numbers, the training microbatch's under ``train_*``;
    no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tol = 1e-5                              # tests/test_kernels.py:118
    for case in RGLRU_CASES:
        (ey, eh), exact = rglru_case(torch, gen, rkernel, rref, *case)
        assert exact, case
        print(f"rglru case B,S,W={case}: max abs err y {ey[0]:.3e}, h_final "
              f"{eh[0]:.3e}; bitwise equal {exact}")
    for case in RGLRU_EDGES:
        assert rglru_case(torch, gen, rkernel, rref, *case)[1], case
    assert rglru_case(torch, gen, rkernel, rref, 2, 131, 48, offset=True)[1]
    print(f"rglru tile edges (T {RGLRU_TILE}) B,S,W in {RGLRU_EDGES} and "
          f"(2, 131, 48) off 16-byte alignment: bitwise equal to the plain "
          f"version, two calls bit for bit")
    a, bb = rglru_inputs(torch, gen, 2, 512, 256)
    y, h = rkernel.rglru_scan_cuda(a, bb)
    py, ph = rref.rglru(a, bb)
    ey, eh = rref.rglru(a.double(), bb.double())
    e_kernel = max((y.double() - ey).abs().max().item(),
                   (h.double() - eh).abs().max().item())
    e_plain = max((py.double() - ey).abs().max().item(),
                  (ph.double() - eh).abs().max().item())
    assert e_kernel <= tol, e_kernel
    print(f"rglru against float64 (B 2, S 512, W 256): max abs err kernel "
          f"{e_kernel:.3e}, plain {e_plain:.3e}")

    out = []
    for (b, s, w), label in ((RG_TRAIN_SCAN, "training microbatch"),
                             (RG_PREFILL, "prefill shape")):
        a, bb = rglru_inputs(torch, gen, b, s, w)
        y, h = rkernel.rglru_scan_cuda(a, bb)
        wy, wh = rref.rglru(a, bb)
        ey, eh = close_scaled(y, wy, tol, tol), close_scaled(h, wh, tol, tol)
        exact = torch.equal(y, wy) and torch.equal(h, wh)
        assert exact, (b, s, w)
        again = rkernel.rglru_scan_cuda(a, bb)
        assert torch.equal(y, again[0]) and torch.equal(h, again[1])
        del wy, wh, again
        ms = time_ms(torch, lambda i: rkernel.rglru_scan_cuda(a, bb), 1,
                     inner=10, reps=11)
        plain_ms = time_ms(torch, lambda i: rref.rglru(a, bb), 1, inner=1,
                           reps=3)
        moved, t_bytes, t_ops = rglru_bound(b, s, w)
        print(f"rglru at recurrentgemma-2b's {label} B={b} S={s} W={w} "
              f"({-(-w // 32) * b} blocks of 32 lanes): max abs err y {ey[0]:.3e} (scale {ey[1]:.3e}), h_final "
              f"{eh[0]:.3e}; bitwise equal {exact}, two calls bit for bit; "
              f"kernel {ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s), plain "
              f"{plain_ms:.3f} ms, bound {max(t_bytes, t_ops):.4f} ms "
              f"({moved} bytes); no single PyTorch call computes a linear "
              f"recurrence")
        del a, bb, y, h
        out.append({"max_abs_err": max(ey[0], eh[0]), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
    train, prefill = out
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru/kernel.py:46", **prefill,
            "library_ms": None, "train_ms": train["ms"],
            "train_plain_ms": train["plain_ms"],
            "train_bound_ms": train["bound_ms"]}


def rglru_bound(b: int, s: int, w: int, backward: bool = False):
    """Bytes the scan (or its backward) must move, each input read once
    and each output written once, and its bounds in ms from those bytes
    and from its float operations: ``(bytes, ms by bytes, ms by
    operations)``."""
    if backward:   # dy, a, y, dh in; da, db out; a multiply-add and da
        moved, ops = 5 * b * s * w * 4 + b * w * 4, 3 * b * s * w
    else:          # a, b in; y, h_final out; a multiply and an add a step
        moved, ops = 3 * b * s * w * 4 + b * w * 4, 2 * b * s * w
    return (moved, moved / HBM_BYTES_PER_S * 1e3,
            ops / FP32_OPS_PER_S * 1e3)


def window_pairs(s: int, window: int) -> int:
    """Visible (query, key) pairs of a causal call with a window."""
    return sum(min(qpos + 1, window) for qpos in range(s))


def per_row(torch, fn, *xs):
    """A plain flash function one batch row at a time (at the prefill shape
    one row's float32 scores are 0.7 GB), outputs concatenated."""
    outs = [fn(*(x[i:i + 1] for x in xs)) for i in range(xs[0].shape[0])]
    return [torch.cat(parts) for parts in zip(*outs)]


def sdpa_windowed(torch, q, k, v, window):
    """SDPA (the yardstick, never called by the port) on (B, S, H, D)
    inputs with the window as a boolean mask; the first backend that takes
    it, tried in PyTorch's own order. Returns (fn, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    h = q.shape[2]
    qs = q.transpose(1, 2)
    ks, vs = (x.transpose(1, 2).repeat_interleave(h // x.shape[2], dim=1)
              for x in (k, v))
    s = q.shape[1]
    qpos = torch.arange(s, device=q.device)
    mask = (qpos[:, None] >= qpos[None, :]) & (qpos[:, None] - qpos[None, :] < window)
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue

        def fn(backend=backend):
            with sdpa_kernel(backend):
                return sdpa(qs, ks, vs, attn_mask=mask)
        try:                 # the yardstick only: a backend that refuses
            with warnings.catch_warnings():     # the mask or D 256 is skipped
                warnings.simplefilter("ignore")
                fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, name
    raise RuntimeError("no SDPA backend takes the windowed call")


# B, Sq, Sk, H, K, D, window, causal: the edges of the bf16 forward's D 256
# tile (64 queries a block, 16 a warp, 32 keys a step) and of the
# backward's (64 keys and one query head a dK/dV block, 64 queries a step,
# 16 keys a dQ step; G = H / K heads' shares summed, none at G 1)
FLASH256_EDGES = [
    (2, 80, 80, 4, 1, 136, 24, True),        # D 136: above 128, padded to 256
    (1, 96, 96, 4, 2, 200, None, True),      # D 200
    (2, 83, 83, 4, 1, 256, None, True),      # S over three key steps, ragged
    (1, 150, 150, 4, 1, 256, 40, True),      # a window that ends inside a step
    (1, 130, 130, 10, 1, 256, 64, True),     # MQA, G 10 (recurrentgemma's)
    (1, 72, 136, 4, 2, 256, None, False),    # non-causal, Sq < Sk
    (1, 150, 70, 4, 1, 256, None, False),    # non-causal, Sq > Sk
    (1, 100, 100, 2, 2, 256, 48, True),      # G 1: no shares to sum
    (2, 140, 140, 8, 2, 256, None, True),    # G 4 in each of two KV heads
]


def flash256_phase(torch, fkernel, fref) -> dict:
    """The CUDA flash forward at head dim 256 (MQA, a window) against its
    plain version on a small case and on the edges of the bf16 kernel's
    D 256 tile in float32 and bfloat16 (bf16 on the tensor cores, float32
    on the CUDA cores, by the C entry's route), float32 and bf16 against
    float64 on the same inputs, and at recurrentgemma-2b's prefill shape
    (B 8, S 4096, H 10, K 1, D 256, window 2048, bf16), where two calls give
    the same bits; times kernel, plain version and windowed SDPA there.
    Returns the JSON entry (no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    cases = [(2, 80, 80, 4, 1, 256, 24, True)] + FLASH256_EDGES
    for b, sq, sk, h, kh, d, win, causal in cases:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            q, k, v, _ = flash_inputs(torch, gen, b, sq, h, kh, d, dt, sk=sk)
            o, lse = routed_fwd(torch, fkernel, q, k, v, causal, win)
            wo, wlse = fref.flash_attention_ref(q, k, v, causal=causal,
                                                window=win)
            eo = close_scaled(o, wo, TOL[name], TOL[name])
            el = close(lse, wlse, TOL["float32"])
            print(f"flash D 256 case B,Sq,Sk,H,K,D,window,causal="
                  f"{(b, sq, sk, h, kh, d, win, causal)} {name}: max abs err "
                  f"o {eo[0]:.3e} (scale {eo[1]:.3e}), lse {el:.3e}")
    # float64 on the same inputs: float32's o (CUDA cores) within float32's
    # tol, bf16's (tensor cores) at bf16's bound; lse at float32's in both
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        q, k, v, _ = flash_inputs(torch, gen, 1, 96, 4, 1, 256, dt)
        o, lse = routed_fwd(torch, fkernel, q, k, v, True, 40)
        po, plse = fref.flash_attention_ref(q, k, v, causal=True, window=40)
        eo, else_ = fref.flash_attention_ref(q.double(), k.double(),
                                             v.double(), causal=True,
                                             window=40)
        if dt == torch.float32:
            e_kernel = (o.double() - eo).abs().max().item()
            assert e_kernel <= TOL["float32"], e_kernel
        else:
            e_kernel = close_scaled(o, eo, TOL[name], TOL[name])[0]
        e_lse = close(lse, else_, TOL["float32"])
        e_plain = (po.double() - eo).abs().max().item()
        print(f"flash D 256 against float64 (B 1, S 96, H 4, K 1, window 40, "
              f"{name} inputs): max abs err of o: kernel {e_kernel:.3e}, plain "
              f"{e_plain:.3e}; of lse: kernel {e_lse:.3e}, plain "
              f"{(plse.double() - else_).abs().max().item():.3e}")

    b, s, h, kh, d, win = RG_ATTN
    q, k, v, _ = flash_inputs(torch, gen, b, s, h, kh, d, torch.bfloat16)
    o, lse = routed_fwd(torch, fkernel, q, k, v, True, win)
    plain = lambda: per_row(torch, lambda *x: fref.flash_attention_ref(
        *x, causal=True, window=win), q, k, v)
    wo, wlse = plain()
    eo = close_scaled(o, wo, TOL["bfloat16"], TOL["bfloat16"])
    el = close(lse, wlse, TOL["float32"])
    del wo, wlse
    again = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True, window=win)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    del again
    ms = time_ms(torch, lambda i: fkernel.flash_attention_fwd_cuda(
        q, k, v, causal=True, window=win), 1, inner=5, reps=7)
    plain_ms = time_ms(torch, lambda i: plain(), 1, inner=1, reps=3)
    sdpa_fn, backend = sdpa_windowed(torch, q, k, v, win)
    lib_ms = time_ms(torch, lambda i: sdpa_fn(), 1, inner=3, reps=5)
    pairs = window_pairs(s, win)
    bound, by = flash_bound_ms(b, s, h, kh, d, 2, pairs, False)
    print(f"flash D 256 at recurrentgemma's prefill shape B={b} S={s} H={h} "
          f"K={kh} D={d} window {win} bf16 ({pairs} visible pairs per head): "
          f"max abs err o {eo[0]:.3e} (scale {eo[1]:.3e}), lse {el:.3e}; two "
          f"calls give bitwise equal o and lse; kernel {ms:.3f} ms "
          f"({4 * b * h * d * pairs / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms (one batch row at a time), sdpa with the window "
          f"as a mask {lib_ms:.3f} ms (backend {backend}), bound "
          f"{bound:.4f} ms ({by})")
    return {"name": "flash_attention_fwd_d256", "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/attention/kernel.py:69",
            "max_abs_err": max(eo[0], el), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def counted_serve(launch_serve, serve, counts):
    """``serve()`` (a call of ``launch_serve.main`` or ``launch_serve.run``)
    with each prefill and decode call recorded as ``(name, launches of each
    counter during the call)``; ``counts`` is a zero-argument function
    returning the counters."""
    import dataclasses

    calls = []
    real_build = launch_serve.build_serve

    def counting_build(*a, **kw):
        sv = real_build(*a, **kw)

        def counted(name, fn):
            def run(*args):
                before = counts()
                out = fn(*args)
                calls.append((name, *(c - c0 for c, c0 in zip(counts(),
                                                               before))))
                return out
            return run
        return dataclasses.replace(sv, prefill_fn=counted("prefill", sv.prefill_fn),
                                   decode_fn=counted("decode", sv.decode_fn))

    with mock.patch.object(launch_serve, "build_serve", counting_build):
        run = serve()
    return run, calls


def hybrid_serve_phase(torch, np, rkernel, rref, fkernel, fref,
                       card: str) -> tuple[int, int]:
    """Full-width recurrentgemma-2b served by the serve driver
    (``repro_torch.launch.serve``): batch 8, a 4096-token prompt, 64 greedy
    steps, random bf16 weights from the seed. Checks the launch counts of
    every call (18 scans and 8 flash forwards in the prefill, all on the
    tensor-core kernel, none in a decode step), then holds every scan and
    flash call of one prompt's prefill to the plain versions on that call's
    own inputs (the flash o and lse to the plain version in float64), and
    profiles a prefill (its flash kernels checked by name) and a decode
    step. Returns the run's scan and flash-forward launch counts."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import griffin, registry

    argv = ["--arch", "recurrentgemma-2b", "--batch", str(RG_SERVE["batch"]),
            "--prompt-len", str(RG_SERVE["prompt_len"]),
            "--steps", str(RG_SERVE["steps"]), "--seed", str(SEED)]
    print(f"hybrid serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    rkernel.launches = fkernel.launches_fwd = fkernel.launches_fwd_mma = 0
    run, calls = counted_serve(launch_serve, lambda: launch_serve.main(argv),
                               lambda: (rkernel.launches,
                                        fkernel.launches_fwd,
                                        fkernel.launches_fwd_mma))
    launches = (rkernel.launches, fkernel.launches_fwd)
    cfg = run.cfg
    n_rec = griffin._pattern(cfg).count("rec")
    n_attn = cfg.n_layers - n_rec
    assert (n_rec, n_attn) == (18, 8)
    assert cfg.param_count() == 2_682_191_360
    # the prefill's flash forwards (bf16, D 256) on the tensor-core kernel
    assert calls[0] == ("prefill", n_rec, n_attn, n_attn), calls[0]
    assert calls[1:] == [("decode", 0, 0, 0)] * RG_SERVE["steps"], calls[1:4]
    assert launches == (n_rec, n_attn), launches
    assert fkernel.launches_fwd_mma == n_attn, fkernel.launches_fwd_mma
    b, steps = RG_SERVE["batch"], RG_SERVE["steps"]
    assert tuple(run.tokens.shape) == (b, steps)
    assert bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all())
    assert bool(torch.isfinite(run.logits.float()).all())
    assert int(run.cache.pos) == RG_SERVE["prompt_len"] + steps
    step_ms = statistics.median(run.decode_s) * 1e3
    print(f"hybrid serve on {card}: recurrentgemma-2b, {cfg.n_layers} layers "
          f"({n_rec} RG-LRU, {n_attn} local attention), "
          f"{cfg.param_count()} parameters in bf16; prefill {b} x "
          f"{RG_SERVE['prompt_len']} tokens {run.prefill_s:.3f} s "
          f"({b * RG_SERVE['prompt_len'] / run.prefill_s:.0f} tokens/s); "
          f"decode step {step_ms:.3f} ms (median of {steps}; first "
          f"{run.decode_s[0] * 1e3:.3f} ms), {b * steps / sum(run.decode_s):.1f} "
          f"tokens/s; peak memory {run.peak_bytes / 1e9:.2f} GB; launches "
          f"{launches[0]} scans and {launches[1]} flash forwards (all on the "
          f"tensor-core kernel) in the prefill, 0 in each of the {steps} "
          f"decode steps")

    # every scan and flash call of one prompt's prefill against the plain
    # versions on that call's own inputs
    errs = {"scan": [], "flash": []}
    kernel_scan, kernel_fwd = rglru_ops._scan, attn_ops._forward

    def checked_scan(a, bb):
        y, h = kernel_scan(a, bb)
        wy, wh = rref.rglru(a, bb)
        errs["scan"].append(max(close_scaled(y, wy, 1e-5, 1e-5),
                                close_scaled(h, wh, 1e-5, 1e-5)))
        return y, h

    flash = []

    def checked_fwd(q, k, v, causal, window):
        # o and lse against the plain version computed in float64, as the
        # moe serve phase holds grok's lse: these random weights give large
        # scores whose softmax hangs on near-ties, and there the float32
        # plain version's own o lies up to 2.1 of the bound from float64
        # (PERF.md), so holding the kernel to it would ask for its rounding
        o, lse = kernel_fwd(q, k, v, causal, window)
        wo, wlse = fref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window)
        eo, e64 = fref.flash_attention_ref(q.double(), k.double(), v.double(),
                                           causal=causal, window=window)
        eo = eo.float()
        eo_s = close_scaled(o, eo, TOL["bfloat16"], TOL["bfloat16"])
        el = close(lse, e64, TOL["float32"])
        # err/bound of the kernel and of the float32 plain version
        worst_o = lambda x, want, sc: ((x.float() - want).abs() / (
            TOL["bfloat16"] * sc + TOL["bfloat16"] * want.abs())).max().item()
        worst_l = lambda x, want: ((x.double() - want.double()).abs() / (
            TOL["float32"] + TOL["float32"] * want.double().abs())).max().item()
        w_s = min(1.0, wo.float().square().mean().sqrt().item())
        flash.append({
            "o": worst_o(o, eo, eo_s[1]), "o plain": worst_o(wo, eo, eo_s[1]),
            "o to plain": worst_o(o, wo.float(), w_s),
            "lse": worst_l(lse, e64), "lse plain": worst_l(wlse, e64),
            "lse to plain": worst_l(lse, wlse), "lse err": el})
        errs["flash"].append(eo_s)
        return o, lse

    with mock.patch.object(rglru_ops, "_scan", checked_scan), \
            mock.patch.object(attn_ops, "_forward", checked_fwd), \
            torch.inference_mode():
        one, _ = registry.prefill(run.params, cfg, run.prompt[:1],
                                  max_len=run.serve.max_len)
    assert bool(torch.isfinite(one.float()).all())
    assert (len(errs["scan"]), len(errs["flash"])) == (n_rec, n_attn)
    per_call = lambda key: " ".join(f"{f[key]:.3f}" for f in flash)
    print(f"hybrid serve: the {n_attn} flash forwards of that prefill, worst "
          f"err/bound per call against the plain version in float64: o "
          f"(bound {TOL['bfloat16']} * scale + {TOL['bfloat16']} * "
          f"|float64|) kernel {per_call('o')}, the float32 plain version "
          f"{per_call('o plain')}; lse (bound {TOL['float32']} + "
          f"{TOL['float32']} * |float64|) kernel {per_call('lse')}, the "
          f"float32 plain version {per_call('lse plain')}. Kernel against "
          f"the float32 plain version: o {per_call('o to plain')}, lse "
          f"{per_call('lse to plain')}; lse max abs err against float64 "
          f"{max(f['lse err'] for f in flash):.3e}", flush=True)
    del flash
    span = lambda xs: (f"max abs err {max(e for e, _ in xs):.3e}, scales "
                       f"{min(s for _, s in xs):.3e} to "
                       f"{max(s for _, s in xs):.3e}")
    print(f"hybrid serve: every call of one prompt's prefill held to the "
          f"plain version on its own inputs: {n_rec} scans, "
          f"{span(errs['scan'])} (bound 1e-5 * scale + 1e-5 * |plain|); "
          f"{n_attn} flash forwards against the plain version in float64, "
          f"o {span(errs['flash'])} (bound {TOL['bfloat16']} * scale + "
          f"{TOL['bfloat16']} * |float64|; lse {TOL['float32']} + "
          f"{TOL['float32']} * |float64|)")
    del errs
    hybrid_profile(torch, run, card,
                   flash={"flash_fwd_mma_kernel<256>": n_attn})
    return launches


def hybrid_profile(torch, run, card: str, label: str = "hybrid",
                   flash: dict | None = None) -> None:
    """One batch-8 prefill and three decode steps of a serve-driver run
    under ``torch.profiler``: device busy share and the top device
    kernels. ``flash``: the prefill's flash kernels, by name, and their
    launches, which the profile must show."""
    sv, params = run.serve, run.params
    for name, fn, n in (
            ("prefill", lambda: sv.prefill_fn(params, run.prompt), 1),
            ("decode step", lambda: sv.decode_fn(
                params, run.cache, run.tokens[:, -1:]), 3)):
        fn()
        wall_ms, busy_ms, launches, kernels = device_profile(torch, fn, n)
        if name == "prefill" and flash is not None:
            seen = {kernel_name(e.key): e.count for e in kernels
                    if kernel_name(e.key).startswith("flash_")}
            assert seen == flash, seen
        top = "; ".join(f"{e.key[:44]} {dev_us(e) / 1e3 / n:.3f} ms x"
                        f"{e.count // n}" for e in kernels[:6])
        print(f"{label} {name} profile on {card}: wall {wall_ms:.3f} ms (under "
              f"the profiler), device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} kernel "
              f"launches; top device time: {top}")


def small_hybrid_reference_phase(torch, np) -> None:
    """The card's serve path against the CPU's plain path on a small input:
    the recurrentgemma smoke config, the same bf16 params (attention at its
    true fan-in and the embedding x 10, as tests/test_torch_griffin.py
    holds the port to JAX), a 40-token prompt (past the 16-token window)
    and 12 teacher-forced decode steps. Logits and the caches agree at the
    bf16 bound, greedy tokens wherever the margin is clear, and the card's
    prefill went through the kernels."""
    from repro_torch import configs
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.rglru import kernel as rkernel
    from repro_torch.models import griffin, registry
    from repro_torch.serve.engine import build_serve
    from repro_torch.sharding.params import init_tree, tree_map

    cfg = configs.smoke("recurrentgemma_2b")
    params = griffin.true_fan_in(
        init_tree(registry.decls(cfg), SEED, "cpu", dtype=torch.bfloat16),
        cfg)
    params["embed"] = params["embed"] * 10.0
    s, steps, tol = 40, 12, 6e-2
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s + steps)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        sv = build_serve(cfg, 2, s + steps, prefill_len=s, device=dev)
        r0, f0 = rkernel.launches, fkernel.launches_fwd
        logits, cache = sv.prefill_fn(p, toks[:, :s])
        launched = (rkernel.launches - r0, fkernel.launches_fwd - f0)
        seq = [logits.float().cpu()]
        for t in range(steps):
            logits, cache = sv.decode_fn(p, cache, toks[:, s + t:s + t + 1])
            seq.append(logits.float().cpu())
        out[dev] = (torch.stack(seq), cache, launched)
    (want, wcache, _), (got, gcache, launched) = out["cpu"], out["cuda"]
    assert launched == (4, 1), launched
    err = close(got, want, tol)
    for f in ("conv", "h", "k", "v"):
        close(getattr(gcache, f).cpu(), getattr(wcache, f), tol)
    top2 = want.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 2 * tol * (1 + top2[..., 0].abs())
    same = got.argmax(-1)[clear] == want.argmax(-1)[clear]
    assert bool(same.all()) and int(clear.sum()) > steps, int(clear.sum())
    print(f"smoke recurrentgemma on the card (kernels: 4 scans, 1 flash "
          f"forward in the prefill) vs the CPU's plain path: prefill of 40 "
          f"tokens and {steps} decode steps, logits max abs err {err:.3e} "
          f"(tolerance {tol} + {tol} * |plain|), caches within it; greedy "
          f"tokens equal at all {int(clear.sum())} of {clear.numel()} steps "
          f"with a clear margin")


# ---------------------------------------------------------------------------
# SSD chunk scan and the SSM family's serving (the serve driver's path)
# ---------------------------------------------------------------------------

# b, s, h, p, n, chunk (tests/test_kernels.py:68-72), then ragged S
SSD_CASES = [(2, 64, 4, 16, 16, 16), (1, 128, 2, 32, 8, 32), (2, 32, 8, 8, 64, 8)]
SSD_RAGGED = [(2, 37, 3, 16, 16, 16), (1, 300, 2, 64, 128, 256), (1, 1, 2, 8, 4, 8)]
# the edges of the tensor-core route (bf16 B and C): S 1, ragged last chunks
# against its 64-row tiles and 128-row blocks, chunks of 8, 100, 256 and
# 1024, P 8, 16 and 64, N 4, 16 and 128, and odd P and N (narrow copies)
SSD_EDGES = [(1, 1, 2, 8, 4, 8), (2, 37, 3, 16, 16, 16), (1, 300, 2, 8, 4, 100),
             (2, 520, 3, 64, 128, 256), (1, 77, 2, 64, 128, 8),
             (1, 2100, 2, 16, 16, 1024), (1, 1100, 2, 64, 128, 1024),
             (2, 130, 3, 33, 5, 64), (1, 200, 4, 64, 16, 100)]
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}      # tests/test_kernels.py:83
# the edges of the backward's tensor-core route (chunks of 64, 16-row warp
# tiles): S 1, a ragged end, exactly one chunk, one step past it, two chunks
# and a ragged third; P 8 to 64 and N 4 to 128, odd P and N (narrow copies)
SSD_BWD_EDGES = [(1, 1, 2, 8, 4), (2, 37, 3, 16, 16), (1, 64, 2, 64, 128),
                 (1, 65, 2, 64, 128), (2, 150, 3, 33, 5), (1, 128, 2, 7, 77),
                 (1, 200, 4, 64, 16), (2, 96, 2, 40, 128)]
M2_PREFILL = (8, 4096, 32, 64, 128, 256)   # b, s, h, p, n, chunk: mamba2-370m
M2_SERVE = {"batch": 8, "prompt_len": 4096, "steps": 64}
TF32_OPS_PER_S = 495e12                    # H100 SXM dense TF32 tensor cores


def ssd_inputs(torch, gen, b, s, h, p, n, x_dtype=None, bc_dtype=None,
               heads_share_bc=False):
    """The reference test's draws on the card: x ~ N(0, 0.5^2), dA =
    -|N(0, 0.1^2)|, B and C ~ N(0, 0.3^2); B and C drawn once and expanded
    over the heads (stride 0) when ``heads_share_bc``, as the model passes
    them."""
    mk = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    x = (mk(b, s, h, p) * 0.5).to(x_dtype or torch.float32)
    dA = -(mk(b, s, h) * 0.1).abs()
    hb = 1 if heads_share_bc else h
    B, C = ((mk(b, s, hb, n) * 0.3).to(bc_dtype or torch.float32)
            for _ in range(2))
    if heads_share_bc:
        B, C = (t.expand(b, s, h, n) for t in (B, C))
    return x, dA, B, C


def model_decay(torch, gen, b, s, h):
    """dA = dt A with dt = softplus(N(0, 1)) and A = -1: the reference
    init's decay, whose cumsum reaches about -200 over a chunk of 256."""
    return -torch.nn.functional.softplus(torch.randn(
        (b, s, h), generator=gen, device="cuda"))


def ssd_check(torch, skernel, sref, x, dA, B, C, chunk, tol, f64=False):
    """Kernel against the plain chunked version on the same inputs, y and
    the final state each at :func:`close_scaled`'s bound; with ``f64`` the
    plain version computes in float64. At the model's scale (|y| in the
    tens, the cumsum of dA near -200 at a chunk's end) the float32 plain
    version is itself off float64 by several 1e-4 (its decays are
    differences of that cumsum), so there the kernel is held to float64."""
    y, st = skernel.ssd_cuda(x, dA, B, C, chunk=chunk)
    wy, wst = sref.ssd_chunked(x.double() if f64 else x, dA, B, C,
                               chunk=chunk)
    return close_scaled(y, wy, tol, tol), close_scaled(st, wst, tol, tol)


def ssd_route(skernel, fn):
    """``fn()`` and the route its SSD launch took, by the C entry's report:
    ``"tc"`` or ``"fma"``."""
    tc0 = skernel.launches_tc
    out = fn()
    return out, "tc" if skernel.launches_tc > tc0 else "fma"


def ssd_case(torch, gen, skernel, sref, b, s, h, p, n, chunk, x_dtype,
             bc_dtype, shared=False):
    """One call against the plain version at the reference's tolerance for
    x's dtype (:func:`close_scaled`), its route by the C entry's report
    against :func:`kernel.plan`'s, and a second call's bits. Returns the
    errors of y and the state, and the route."""
    x, dA, B, C = ssd_inputs(torch, gen, b, s, h, p, n, x_dtype=x_dtype,
                             bc_dtype=bc_dtype, heads_share_bc=shared)
    (y, st), ran = ssd_route(skernel,
                             lambda: skernel.ssd_cuda(x, dA, B, C, chunk=chunk))
    route = skernel.plan(b, s, h, p, n, chunk, x.dtype, B.dtype).route
    assert ran == route, ((b, s, h, p, n, chunk), x_dtype, bc_dtype, ran)
    wy, wst = sref.ssd_chunked(x, dA, B, C, chunk=chunk)
    tol = SSD_TOL[str(x_dtype).split(".")[1]]
    ey, es = close_scaled(y, wy, tol, tol), close_scaled(st, wst, tol, tol)
    y2, st2 = skernel.ssd_cuda(x, dA, B, C, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(st, st2), (b, s, h, p, n, chunk)
    return ey, es, route


def ssd_bound_ms(b, s, h, p, n, chunk, x_bytes, bc_bytes, bc_bf16, shared):
    """Least time for one call, two ways: the larger of its operations at
    the card's peak for their type and its bytes (x, dA, the stored B and C
    read once; y and the state written once) over the memory rate.
    Operations (2 a multiply-add), per chunk of L steps over its L (L + 1) /
    2 pairs j <= i: the C.B^T scores, 2 n a pair, are products of B and C
    alone, so they run on the bf16 tensor cores when B and C are bf16
    (float32 accumulation, as the plain version computes them), and once
    for all heads when the heads share B and C (``shared``: stride 0); the
    rest per (b, h): the decayed scores' product with x (2 p a pair), the
    C.S^T term and the state update (4 L n p). ``"cuda_core"`` counts that
    rest as float32 on the CUDA cores (67 TFLOP/s); ``"tc"`` as the TF32
    products a float32-accurate tensor-core kernel runs (495 TFLOP/s): 3
    per product of two float32 operands (x float32 in scores . x), 2 where
    one operand is bf16 (C and B in C.S^T and the state update, bf16 x).
    Returns ``{"cuda_core": (ms, by), "tc": (ms, by), "f32": ops, "tf32":
    ops, "score": ops, "bytes": n}``."""
    score = sx = sn = 0
    for t0 in range(0, s, chunk):
        length = min(chunk, s - t0)
        pairs = length * (length + 1) // 2
        score += 2 * pairs * n
        sx += 2 * pairs * p
        sn += 4 * length * n * p
    score *= b * (1 if shared else h)
    sx, sn = sx * b * h, sn * b * h
    f32, tf32 = sx + sn, (3 if x_bytes == 4 else 2) * sx + 2 * sn
    moved = 2 * b * s * h * p * x_bytes + b * s * h * 4 + bc_bytes \
        + b * h * p * n * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_score = score / (BF16_OPS_PER_S if bc_bf16 else FP32_OPS_PER_S) * 1e3
    out = {"f32": f32, "tf32": tf32, "score": score, "bytes": moved}
    for key, t_ops in (("cuda_core", f32 / FP32_OPS_PER_S * 1e3 + t_score),
                       ("tc", tf32 / TF32_OPS_PER_S * 1e3 + t_score)):
        out[key] = (max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes")
    return out


def ptxas_report(lib, names: str = r"ssd_chunk_scan_kernel|ssd_tc_[a-z]+_kernel"
                 ) -> dict:
    """Registers and spilled bytes of each kernel whose name matches
    ``names`` in a library's ``-Xptxas -v`` report (kept beside it as
    ``.log``), by kernel name and first template argument."""
    kinds = {"f": "<float>", "13__nv_bfloat16": "<bf16>", None: ""}
    out = {}
    for block in lib.with_suffix(".log").read_text().split(
            "Compiling entry function")[1:]:
        m = re.search(rf"({names})(?:I(f|13__nv_bfloat16))?", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs and spill:
            out[m.group(1) + kinds[m.group(2)]] = (int(regs.group(1)),
                                                   int(spill.group(1)))
    return out


def ssd_phase(torch, skernel, sref) -> dict:
    """The CUDA SSD chunk scan against its plain version: float32 B and C
    (the CUDA-core route) on the reference's cases and ragged S, bf16 B and
    C (the tensor-core route) on its edges (``SSD_EDGES``), contiguous and
    broadcast over the heads with stride 0, each in float32 and bf16 x,
    each call's route by the C entry's report and a second call's bits;
    both routes against a float64 oracle; and at mamba2-370m's prefill
    shape against the plain version in float64, where two calls give the
    same bits. Times kernel and plain version there and prints both bounds,
    the kernels' registers, spills and shared memory, and the workspace.
    Returns the kernel's JSON entry (no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    routes = {}
    runs = ([(case, dt, torch.float32, False) for case in SSD_CASES + SSD_RAGGED
             for dt in (torch.float32, torch.bfloat16)]
            + [(case, dt, torch.bfloat16, shared) for case in SSD_EDGES
               for dt in (torch.float32, torch.bfloat16)
               for shared in (False, True)])
    for case, dt, bc_dt, shared in runs:
        ey, es, route = ssd_case(torch, gen, skernel, sref, *case, dt, bc_dt,
                                 shared)
        routes[route] = routes.get(route, 0) + 1
        print(f"ssd case b,s,h,p,n,chunk={case} x {str(dt)[6:]} B/C "
              f"{str(bc_dt)[6:]}{' shared' if shared else ''} ({route}): max "
              f"abs err y {ey[0]:.3e} (scale {ey[1]:.3e}), state {es[0]:.3e}")
    assert routes.get("fma") == 2 * len(SSD_CASES + SSD_RAGGED) and \
        routes.get("tc") == 4 * len(SSD_EDGES), routes
    # the model's inputs: float32 x, bf16 B and C shared by the heads
    x, dA, B, C = ssd_inputs(torch, gen, 2, 520, 8, 64, 128,
                             bc_dtype=torch.bfloat16, heads_share_bc=True)
    assert B.stride(2) == 0
    ey, es = ssd_check(torch, skernel, sref, x, dA, B, C, 256,
                       SSD_TOL["float32"])
    print(f"ssd with bf16 B and C expanded over 8 heads (stride 0), s 520, "
          f"chunk 256: max abs err y {ey[0]:.3e} (scale {ey[1]:.3e}), state "
          f"{es[0]:.3e}")

    # float64 yardstick at one small shape: both routes and the float32
    # plain version against it
    for bc_dt in (torch.float32, torch.bfloat16):
        x, dA, B, C = ssd_inputs(torch, gen, 2, 200, 4, 32, 64, bc_dtype=bc_dt)
        (y, st), ran = ssd_route(
            skernel, lambda: skernel.ssd_cuda(x, dA, B, C, chunk=64))
        py, pst = sref.ssd_chunked(x, dA, B, C, chunk=64)
        ey, est = sref.ssd_ref(*(t.double() for t in (x, dA, B, C)))
        err = lambda a, b: max((a[0].double() - b[0]).abs().max().item(),
                               (a[1].double() - b[1]).abs().max().item())
        e_kernel, e_plain = err((y, st), (ey, est)), err((py, pst), (ey, est))
        assert e_kernel <= SSD_TOL["float32"], e_kernel
        print(f"ssd against float64 (b 2, s 200, h 4, p 32, n 64, chunk 64, B "
              f"and C {str(bc_dt)[6:]}, {ran} route): max abs err of y and "
              f"state: kernel {e_kernel:.3e}, plain {e_plain:.3e}")

    # mamba2-370m's prefill shape with the model's dtypes and dA of its size
    b, s, h, p, n, chunk = M2_PREFILL
    x, _, B, C = ssd_inputs(torch, gen, b, s, h, p, n,
                            bc_dtype=torch.bfloat16, heads_share_bc=True)
    dA = model_decay(torch, gen, b, s, h)
    pl = skernel.plan(b, s, h, p, n, chunk, x.dtype, B.dtype, 1)
    (ey, es), ran = ssd_route(skernel, lambda: ssd_check(
        torch, skernel, sref, x, dA, B, C, chunk, SSD_TOL["float32"],
        f64=True))
    assert ran == pl.route == "tc", (ran, pl)
    y1, s1 = skernel.ssd_cuda(x, dA, B, C, chunk=chunk)
    y2, s2 = skernel.ssd_cuda(x, dA, B, C, chunk=chunk)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    del y1, s1, y2, s2
    py, _ = sref.ssd_chunked(x, dA, B, C, chunk=chunk)
    wy, _ = sref.ssd_chunked(x.double(), dA, B, C, chunk=chunk)
    e_plain = (py.double() - wy).abs().max().item()
    del py, wy
    ms = time_ms(torch, lambda i: skernel.ssd_cuda(x, dA, B, C, chunk=chunk),
                 1, inner=5, reps=7)
    plain_ms = time_ms(torch, lambda i: sref.ssd_chunked(x, dA, B, C,
                                                         chunk=chunk),
                       1, inner=1, reps=3)
    bc_bytes = 2 * b * s * n * B.element_size()     # B and C as stored
    bd = ssd_bound_ms(b, s, h, p, n, chunk, 4, bc_bytes,
                      B.dtype == torch.bfloat16, B.stride(2) == 0)
    (bound, by), (core_bound, core_by) = bd["tc"], bd["cuda_core"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            skernel.ssd_cuda(x, dA, B, C, chunk=chunk)
        torch.cuda.synchronize()
    parts = {kernel_name(ev.key): dev_us(ev) / ev.count / 1e3
             for ev in prof.key_averages() if "ssd_tc" in ev.key}
    regs = ptxas_report(skernel.build())
    smem = {k: skernel.smem_bytes(k, x.dtype, chunk) for k in ("state", "out")}
    print(f"ssd at mamba2-370m's prefill shape b={b} s={s} h={h} p={p} n={n} "
          f"chunk {chunk} (x float32, B and C bf16 shared by the heads), "
          f"{ran} route, 3 launches a call: against the plain version in "
          f"float64, max abs err y {ey[0]:.3e} (scale {ey[1]:.3e}), state "
          f"{es[0]:.3e} (the float32 plain version's y: {e_plain:.3e}); two "
          f"calls bit for bit; kernel {ms:.4f} ms ({bd['tf32'] / ms / 1e9:.1f} "
          f"TFLOP/s of TF32 products), its launches "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; plain {plain_ms:.3f} ms; tensor-core bound {bound:.4f} ms "
          f"({by}; {bd['tf32']:.4e} TF32 operations at "
          f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s, {bd['score']:.4e} bf16 C.B^T "
          f"score operations, once for all heads, at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; {bd['bytes']} bytes); "
          f"CUDA-core bound {core_bound:.4f} ms ({core_by}; {bd['f32']:.4e} "
          f"float32 operations at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s); "
          f"workspace {pl.workspace_bytes} bytes; -Xptxas -v "
          + ", ".join(f"{k} {r} registers, {sp} B spilled"
                      for k, (r, sp) in regs.items())
          + f"; dynamic shared memory a block: state {smem['state']} B, out "
          f"{smem['out']} B; no single PyTorch call computes the SSD scan",
          flush=True)
    assert all(sp == 0 for _, sp in regs.values()), regs
    assert ms > bound, (ms, bound)
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:67",
            "max_abs_err": max(ey[0], es[0]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def mamba2_serve_phase(torch, np, skernel, sref, card: str) -> int:
    """Full-width mamba2-370m served by the serve driver
    (``repro_torch.launch.serve``): batch 8, a 4096-token prompt, 64 greedy
    steps, random bf16 weights from the seed. Checks the launch counts of
    every call (48 SSD scans in the prefill, every one on the tensor-core
    route, none in a decode step), then holds every SSD call of one
    prompt's prefill to the plain version in float64 on that call's own
    inputs and checks its route, and profiles a prefill and a decode step.
    Returns the run's SSD launch count."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry

    argv = ["--arch", "mamba2-370m", "--batch", str(M2_SERVE["batch"]),
            "--prompt-len", str(M2_SERVE["prompt_len"]),
            "--steps", str(M2_SERVE["steps"]), "--seed", str(SEED)]
    print(f"mamba2 serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    skernel.launches = skernel.launches_tc = 0
    run, calls = counted_serve(launch_serve, lambda: launch_serve.main(argv),
                               lambda: (skernel.launches,))
    launches, launches_tc = skernel.launches, skernel.launches_tc
    cfg = run.cfg
    b, steps = M2_SERVE["batch"], M2_SERVE["steps"]
    assert cfg.n_layers == 48 and cfg.param_count() == 368_227_840
    assert calls[0] == ("prefill", cfg.n_layers), calls[0]
    assert calls[1:] == [("decode", 0)] * steps, calls[1:4]
    assert launches == launches_tc == cfg.n_layers, (launches, launches_tc)
    assert tuple(run.tokens.shape) == (b, steps)
    assert bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all())
    assert bool(torch.isfinite(run.logits.float()).all())
    assert bool(torch.isfinite(run.cache.state).all())
    assert int(run.cache.pos) == M2_SERVE["prompt_len"] + steps
    step_ms = statistics.median(run.decode_s) * 1e3
    print(f"mamba2 serve on {card}: mamba2-370m, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.ssm_heads} heads of {cfg.ssm_head_dim}, "
          f"state {cfg.ssm_state}, {cfg.param_count()} parameters in bf16; "
          f"prefill {b} x {M2_SERVE['prompt_len']} tokens {run.prefill_s:.3f} s "
          f"({b * M2_SERVE['prompt_len'] / run.prefill_s:.0f} tokens/s); "
          f"decode step {step_ms:.3f} ms (median of {steps}; first "
          f"{run.decode_s[0] * 1e3:.3f} ms), {b * steps / sum(run.decode_s):.1f} "
          f"tokens/s; peak memory {run.peak_bytes / 1e9:.2f} GB "
          f"({run.peak_bytes} B); launches {launches} SSD scans in the "
          f"prefill ({launches_tc} on the tensor-core route, each with a "
          f"workspace of {skernel.plan(b, M2_SERVE['prompt_len'], cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk, torch.float32, torch.bfloat16, 1).workspace_bytes} "
          f"B), 0 in each of the {steps} decode steps")

    # every SSD call of one prompt's prefill against the plain version on
    # that call's own inputs, computed in float64 (see ssd_check); the
    # float32 plain version's own error is printed beside it
    errs, plain_errs, kernel_scan = [], [], ssd_ops._scan

    def checked_scan(x, dA, B, C, chunk):
        (y, st), ran = ssd_route(skernel,
                                 lambda: kernel_scan(x, dA, B, C, chunk))
        assert ran == "tc", ran
        wy, wst = sref.ssd_chunked(x.double(), dA, B, C, chunk=chunk)
        tol = SSD_TOL["float32"]
        errs.append(max(close_scaled(y, wy, tol, tol),
                        close_scaled(st, wst, tol, tol)))
        py, _ = sref.ssd_chunked(x, dA, B, C, chunk=chunk)
        plain_errs.append((py.double() - wy).abs().max().item())
        return y, st

    with mock.patch.object(ssd_ops, "_scan", checked_scan), \
            torch.inference_mode():
        one, _ = registry.prefill(run.params, cfg, run.prompt[:1],
                                  max_len=run.serve.max_len)
    assert bool(torch.isfinite(one.float()).all())
    assert len(errs) == cfg.n_layers, len(errs)
    print(f"mamba2 serve: every SSD call of one prompt's prefill held to the "
          f"plain version in float64 on its own inputs, each on the "
          f"tensor-core route: {len(errs)} calls, "
          f"max abs err {max(e for e, _ in errs):.3e}, scales "
          f"{min(s for _, s in errs):.3e} to {max(s for _, s in errs):.3e} "
          f"(bound {SSD_TOL['float32']} * scale + {SSD_TOL['float32']} * "
          f"|plain|); the float32 plain version's y off float64 by up to "
          f"{max(plain_errs):.3e}")
    del errs
    hybrid_profile(torch, run, card, label="mamba2")
    silu_launches(torch, run)
    return launches


def silu_launches(torch, run) -> None:
    """The share of a mamba2 decode step's launches that its SiLU takes:
    ``mamba2._silu`` rounds each step to bf16 as XLA does (bit parity
    with the reference on the CPU), in more launches a call than
    ``F.silu``'s one. Counts the calls in one decode step and the launches
    of one call of each at the step's shape under the profiler."""
    from repro_torch.models import mamba2

    calls, real = [], mamba2._silu

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    with mock.patch.object(mamba2, "_silu", counted):
        run.serve.decode_fn(run.params, run.cache, run.tokens[:, -1:])
    z = torch.randn((M2_SERVE["batch"], 1, run.cfg.d_inner),
                    device="cuda").to(torch.bfloat16)
    per = {}
    for name, fn in (("_silu", real), ("F.silu", torch.nn.functional.silu)):
        fn(z)
        per[name] = device_profile(torch, lambda: fn(z), 3)[2]
    extra = len(calls) * (per["_silu"] - per["F.silu"])
    print(f"mamba2 decode step: {len(calls)} SiLU calls "
          f"({len(calls) // run.cfg.n_layers} a layer), {per['_silu']:.0f} "
          f"launches each as XLA rounds it against {per['F.silu']:.0f} for "
          f"F.silu: {extra:.0f} launches a step beyond F.silu's")


def small_mamba2_reference_phase(torch, np) -> None:
    """The card's serve path against the CPU's plain path on a small input:
    the mamba2 smoke config, the same bf16 params (the embedding x 10, as
    tests/test_torch_mamba2.py holds the port to JAX), a 37-token prompt
    (4 chunks of 8 and a ragged 5) and 12 teacher-forced decode steps.
    Logits and the caches agree at the bf16 bound, greedy tokens wherever
    the margin is clear, and the card's prefill went through the kernel."""
    from repro_torch import configs
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.models import registry
    from repro_torch.serve.engine import build_serve
    from repro_torch.sharding.params import init_tree, tree_map

    cfg = configs.smoke("mamba2_370m")
    params = init_tree(registry.decls(cfg), SEED, "cpu",
                       dtype=torch.bfloat16)
    params["embed"] = params["embed"] * 10.0
    s, steps, tol = 37, 12, 6e-2
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s + steps)))
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        sv = build_serve(cfg, 2, s + steps, prefill_len=s, device=dev)
        s0 = skernel.launches
        logits, cache = sv.prefill_fn(p, toks[:, :s])
        launched = skernel.launches - s0
        seq = [logits.float().cpu()]
        for t in range(steps):
            logits, cache = sv.decode_fn(p, cache, toks[:, s + t:s + t + 1])
            seq.append(logits.float().cpu())
        out[dev] = (torch.stack(seq), cache, launched)
    (want, wcache, _), (got, gcache, launched) = out["cpu"], out["cuda"]
    assert launched == cfg.n_layers, launched
    err = close(got, want, tol)
    for f in ("conv_x", "conv_B", "conv_C", "state"):
        close(getattr(gcache, f).cpu(), getattr(wcache, f), tol)
    top2 = want.topk(2, dim=-1).values
    clear = top2[..., 0] - top2[..., 1] > 2 * tol * (1 + top2[..., 0].abs())
    same = got.argmax(-1)[clear] == want.argmax(-1)[clear]
    assert bool(same.all()) and int(clear.sum()) > 0, int(clear.sum())
    print(f"smoke mamba2 on the card (kernel: {launched} SSD scans in the "
          f"prefill) vs the CPU's plain path: prefill of {s} tokens and "
          f"{steps} decode steps, logits max abs err {err:.3e} (tolerance "
          f"{tol} + {tol} * |plain|), caches within it; greedy tokens equal at "
          f"all {int(clear.sum())} of {clear.numel()} steps with a clear "
          f"margin")


# ---------------------------------------------------------------------------
# Training the hybrid and SSM families: the backward kernels of the RG-LRU
# scan, of flash attention at head dim 256 and of the SSD chunk scan, and
# full-width recurrentgemma-2b and mamba2-370m through the launcher
# ---------------------------------------------------------------------------

# granite's recipe (AdamW, lr 3e-4, global batch 4, seq 4096, remat full, 4
# steps); recurrentgemma-2b in 4 microbatches of 1: in 2 of 2 it runs out
# of memory on an 80 GB H100 (``tools/train_memory.py``: 82.13 GB allocated
# at its peak when the loss over 2 x 4096 rows of its 256,000-entry
# vocabulary asked for 8.4 GB more; in 4 of 1 it peaks at about 66 GB);
# width and depth are whole
TRAIN_RECIPE = {"global_batch": 4, "seq": 4096, "steps": 4, "lr": 3e-4}
RG_TRAIN = {"arch": "recurrentgemma-2b", "accum": 4, "init": "true-fan-in"}
M2_TRAIN = {"arch": "mamba2-370m", "accum": 2, "init": "reference"}
RG_TRAIN_SCAN = (1, 4096, 2560)             # B, S, W: a microbatch's scans
RG_TRAIN_ATTN = (1, 4096, 10, 1, 256, 2048)  # B, S, H, K, D, window
# the recipe's microbatch of 2, which does not fit the card at
# recurrentgemma-2b's width: its backward kernels are timed there too
RG_RECIPE_SCAN = (2, 4096, 2560)
RG_RECIPE_ATTN = (2, 4096, 10, 1, 256, 2048)
M2_TRAIN_SSD = (2, 4096, 32, 64, 128, 256)  # b, s, h, p, n, chunk
RGLRU_TOL = 1e-5                            # tests/test_kernels.py:118
# one AdamW step, card against the CPU's plain path (and, in
# tests/test_torch_train.py, the port against the JAX package): loss, grad
# norm (relative), and the share of parameter elements allowed past 2e-6.
# Both families run bf16 activations, so their gradients agree to bf16's
# precision, and AdamW's first update moves each element by about lr
# whatever its gradient's size: an element whose gradient is below the
# bf16 noise may step either way (|diff| up to 2 lr)
RECURRENT_STEP_TOL = (1e-3, 1e-2, 5e-2)
# the gradients one step hands AdamW, leaf by leaf (the same two
# comparisons): the 2-norm of the difference relative to the reference's.
# Port against the JAX package on the CPU the largest readings were 6.4e-2
# (Griffin, whose bf16 noise passes through every layer) and 1.5e-2
# (Mamba-2); a leaf with a missing, flipped or wrongly scaled gradient reads
# 1 or more
RECURRENT_GRAD_TOL = {"hybrid": 0.15, "ssm": 0.05}


def leaf_grad_errs(got, want) -> list[float]:
    """``||got - want|| / ||want||`` for each pair of gradient leaves
    (numpy arrays); a leaf whose reference gradient is all zero reads the
    norm of ``got``."""
    import numpy as np

    out = []
    for g, w in zip(got, want, strict=True):
        g, w = (np.asarray(x, np.float64) for x in (g, w))
        ref = float(np.linalg.norm(w))
        diff = float(np.linalg.norm(g - w))
        out.append(diff / ref if ref > 0 else diff)
    return out


def train_launches(cfg, accum: int, steps: int) -> dict:
    """The kernel launches of ``steps`` train steps of ``accum``
    microbatches, from the layer pattern: a layer under remat (``"full"``
    or ``"dots"``) launches its forward kernels twice, in the forward and
    in the backward's recompute; a layer outside it (griffin's tail) once.
    Keys: ``scan``, ``scan_bwd``, ``flash_fwd``, ``flash_bwd`` (hybrid),
    ``ssd``, ``ssd_bwd`` (SSM)."""
    from repro_torch.models import griffin

    twice = 1 if cfg.remat == "none" else 2
    if cfg.family == "hybrid":
        n_full, tail = griffin.plan(cfg)
        pat = list(griffin._block(cfg))
        per = {}
        for kind, fwd, bwd in (("rec", "scan", "scan_bwd"),
                               ("attn", "flash_fwd", "flash_bwd")):
            inner, outer = pat.count(kind) * n_full, tail.count(kind)
            per[fwd], per[bwd] = twice * inner + outer, inner + outer
    elif cfg.family == "ssm":
        per = {"ssd": twice * cfg.n_layers, "ssd_bwd": cfg.n_layers}
    else:
        raise ValueError(f"{cfg.family}: not a recurrent family")
    return {k: v * accum * steps for k, v in per.items()}


def rglru_bwd_case(torch, gen, rkernel, rref, b, s, w, offset=False):
    """The backward kernel against its plain version on the forward
    kernel's own y: ``(errors of da and db, bitwise equal to it and a
    second call bit for bit)``; with ``offset`` a, y and dy start off
    16-byte alignment."""
    a, bb = rglru_inputs(torch, gen, b, s, w)
    y, _ = rkernel.rglru_scan_cuda(a, bb)
    dy = torch.randn((b, s, w), generator=gen, device="cuda")
    dh = torch.randn((b, w), generator=gen, device="cuda")
    if offset:
        a, y, dy = (misaligned(torch, x) for x in (a, y, dy))
    da, db = rkernel.rglru_scan_bwd_cuda(a, y, dy, dh)
    wa, wb = rref.rglru_bwd(a, y, dy, dh)
    errs = (close_scaled(da, wa, RGLRU_TOL, RGLRU_TOL),
            close_scaled(db, wb, RGLRU_TOL, RGLRU_TOL))
    da2, db2 = rkernel.rglru_scan_bwd_cuda(a, y, dy, dh)
    return errs, all(torch.equal(*p) for p in ((da, wa), (db, wb),
                                                (da, da2), (db, db2)))


def ssd_bwd_case(torch, gen, skernel, sref, b, s, h, p, n, chunk, x_dtype,
                 bc_dtype, shared=False, decay=False, f64=False) -> dict:
    """The backward kernels against the plain backward (``ref.ssd_bwd``,
    autograd of the chunked version, in chunks of ``chunk``: the function
    does not depend on it; in float64 with ``f64``) on the same inputs and
    output gradients, each gradient at :func:`close_scaled`'s bound with
    the forward's tolerance for x's dtype; the route the C entry reports
    (``launches_bwd_tc``) against :func:`kernel.plan_bwd`'s (bf16 B and C:
    the tensor cores); a second call gives the same bits and leaves the tc
    route's row counters at zero. ``decay``: the model's dA
    (:func:`model_decay`). Returns ``{name: (max abs err, scale)}`` for dx,
    ddA, dB, dC."""
    x, dA, B, C = ssd_inputs(torch, gen, b, s, h, p, n, x_dtype=x_dtype,
                             bc_dtype=bc_dtype, heads_share_bc=shared)
    if decay:
        dA = model_decay(torch, gen, b, s, h)
    dy = (torch.randn(x.shape, generator=gen, device="cuda") * 0.5).to(x.dtype)
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda") * 0.1
    counters = torch.zeros(b * h, dtype=torch.int32, device="cuda")
    tc0 = skernel.launches_bwd_tc
    got = skernel.ssd_bwd_cuda(x, dA, B, C, dy, dst, counters=counters)
    ran = "tc" if skernel.launches_bwd_tc > tc0 else "fma"
    route = skernel.plan_bwd(b, s, h, p, n, B.dtype).route
    assert ran == route == ("tc" if bc_dtype == torch.bfloat16 else "fma"), \
        ((b, s, h, p, n), x_dtype, bc_dtype, ran)
    want = sref.ssd_bwd(x.double() if f64 else x, dA, B, C, dy, dst,
                        chunk=chunk)
    tol = SSD_TOL[str(x.dtype).split(".")[1]]
    errs = {name: close_scaled(g, w, tol, tol)
            for name, g, w in zip(("dx", "ddA", "dB", "dC"), got, want)}
    again = skernel.ssd_bwd_cuda(x, dA, B, C, dy, dst, counters=counters)
    assert all(torch.equal(u, v) for u, v in zip(got, again)), \
        (b, s, h, p, n, chunk)
    assert not bool(counters.any()), counters
    return errs


def ssd_bwd_bound_ms(b, s, h, p, n, x_bytes, bc_bytes):
    """Least time for one backward call: the larger of its operations and
    its bytes (x, dA, dy, the stored B and C and the final state's gradient
    read once; dx, ddA and the per-head dB and dC written once) over the
    memory rate. Operations (2 a multiply-add): what the function needs
    whatever the chunking, six (p, n) multiply-adds a step and head (the
    state recomputed, the state's gradient carried back, and dy.h, dh.B,
    dh^T.x and dh.h for dC, dx, dB and ddA); the kernels' own chunks of 64
    add a quadratic term that a chunk of 1 would not have, so it is left
    out. Float32-accurate on the tensor cores (3 TF32 products each, 495
    TFLOP/s) and on the CUDA cores (67 TFLOP/s). Returns ``{"tc": (ms, by),
    "cuda_core": (ms, by), "f32": ops, "bytes": n}``."""
    ops = 2 * 6 * p * n * b * s * h
    moved = 3 * b * s * h * p * x_bytes + 2 * b * s * h * 4 + bc_bytes \
        + b * h * p * n * 4 + 2 * b * s * h * n * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    out = {"f32": ops, "bytes": moved}
    for key, t_ops in (("tc", 3 * ops / TF32_OPS_PER_S * 1e3),
                       ("cuda_core", ops / FP32_OPS_PER_S * 1e3)):
        out[key] = (max(t_ops, t_bytes),
                    "operations" if t_ops >= t_bytes else "bytes")
    return out


def sdpa_windowed_bwd(torch, q, k, v, do, window):
    """SDPA's backward (the yardstick, never called by the port) on (B, S,
    H, D) inputs with the window as a boolean mask: ``(fn, backend)``, fn
    running the backward of one forward kept alive, on the first backend
    that takes both passes, in PyTorch's own order."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, s = q.shape[2], q.shape[1]
    qs, ks, vs = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    kr, vr = (x.repeat_interleave(h // x.shape[1], dim=1) for x in (ks, vs))
    pos = torch.arange(s, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
    dos = do.transpose(1, 2).contiguous()
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:                 # the yardstick only: a backend that refuses
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")     # the mask or D 256
                out = sdpa(qs, kr, vr, attn_mask=mask)
                torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return (lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                            retain_graph=True)), name
    raise RuntimeError("no SDPA backend takes the windowed backward")


def backward_phase(torch, rkernel, rref, fkernel, fref, skernel,
                   sref) -> list[dict]:
    """The three backward kernels of the recurrent families' training
    against their plain versions: the RG-LRU scan's on the reference's
    cases and a ragged S and W, bit for bit by design, and against float64;
    the flash backward at head dim 256 on the edges of its tiles
    (``FLASH256_EDGES``) in float32 (CUDA cores) and bf16 (tensor cores),
    against float64; the SSD chunk scan's on the forward's cases, its edges
    with B and C per head and shared, float32 and bf16 x, against float64
    and at the model's decay. Then each at the training shape that the
    train phases give it (the RG-LRU and flash backwards also at the
    recipe's microbatch of 2, :data:`RG_RECIPE_SCAN` and
    :data:`RG_RECIPE_ATTN`), held to its plain version, two calls bit for bit,
    timed (CUDA events) beside its plain version, its bound and the library
    call (SDPA's backward with the window as a mask, for the flash
    backward; none computes a scan). Returns the three JSON entries (no
    launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    out = []

    # RG-LRU
    for case in RGLRU_CASES:
        (ea, eb), exact = rglru_bwd_case(torch, gen, rkernel, rref, *case)
        assert exact, case
        print(f"rglru backward case B,S,W={case}: max abs err da {ea[0]:.3e}, "
              f"db {eb[0]:.3e}; bitwise equal {exact}")
    for case in RGLRU_EDGES:
        assert rglru_bwd_case(torch, gen, rkernel, rref, *case)[1], case
    assert rglru_bwd_case(torch, gen, rkernel, rref, 2, 131, 48,
                          offset=True)[1]
    print(f"rglru backward tile edges (T {RGLRU_TILE}) B,S,W in "
          f"{RGLRU_EDGES} and (2, 131, 48) off 16-byte alignment: bitwise "
          f"equal to the plain version, two calls bit for bit")
    a, bb = rglru_inputs(torch, gen, 2, 512, 256)
    y, _ = rkernel.rglru_scan_cuda(a, bb)
    dy = torch.randn(a.shape, generator=gen, device="cuda")
    dh = torch.randn((2, 256), generator=gen, device="cuda")
    got = rkernel.rglru_scan_bwd_cuda(a, y, dy, dh)
    want = rref.rglru_bwd(a.double(), y.double(), dy.double(), dh.double())
    e64 = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
    assert e64 <= RGLRU_TOL, e64
    print(f"rglru backward against float64 (B 2, S 512, W 256): max abs err "
          f"{e64:.3e}")
    for (b, s, w), label in ((RG_TRAIN_SCAN, "the training microbatch"),
                             (RG_RECIPE_SCAN, "the recipe's microbatch")):
        a, bb = rglru_inputs(torch, gen, b, s, w)
        y, _ = rkernel.rglru_scan_cuda(a, bb)
        dy = torch.randn(a.shape, generator=gen, device="cuda")
        dh = torch.randn((b, w), generator=gen, device="cuda")
        da, db = rkernel.rglru_scan_bwd_cuda(a, y, dy, dh)
        wa, wb = rref.rglru_bwd(a, y, dy, dh)
        errs = (close_scaled(da, wa, RGLRU_TOL, RGLRU_TOL),
                close_scaled(db, wb, RGLRU_TOL, RGLRU_TOL))
        assert torch.equal(da, wa) and torch.equal(db, wb)
        again = rkernel.rglru_scan_bwd_cuda(a, y, dy, dh)
        assert torch.equal(da, again[0]) and torch.equal(db, again[1])
        del wa, wb, again
        ms = time_ms(torch, lambda i: rkernel.rglru_scan_bwd_cuda(
            a, y, dy, dh), 1, inner=10, reps=11)
        plain_ms = time_ms(torch, lambda i: rref.rglru_bwd(a, y, dy, dh), 1,
                           inner=1, reps=3)
        moved, t_bytes, t_ops = rglru_bound(b, s, w, backward=True)
        print(f"rglru backward at {label} B={b} S={s} W={w} "
              f"({-(-w // 32) * b} blocks of 32 lanes): max abs err "
              f"da {errs[0][0]:.3e} (scale {errs[0][1]:.3e}), db "
              f"{errs[1][0]:.3e}; bitwise equal to the plain version, two "
              f"calls bit for bit; kernel {ms:.4f} ms "
              f"({moved / ms / 1e6:.1f} GB/s), plain {plain_ms:.3f} ms, bound "
              f"{max(t_bytes, t_ops):.4f} ms ({moved} bytes); no single "
              f"PyTorch call computes a linear recurrence")
        del a, bb, y, dy, da, db
        if (b, s, w) != RG_TRAIN_SCAN:
            continue
        out.append({"name": "rglru_scan_bwd", "route": "cuda",
                    "source": "src/repro_torch/kernels/rglru/csrc/"
                              "rglru_scan.cu",
                    "replaces": "none (backward of src/repro/kernels/rglru/"
                                "kernel.py:46; the reference differentiates "
                                "src/repro/models/griffin.py:87)",
                    "max_abs_err": max(errs[0][0], errs[1][0]), "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                    "library_ms": None})

    # flash backward at head dim 256: bf16 on the D 256 route (the C
    # entry's count), float32 not; two calls give the same bits
    for b, sq, sk, h, kh, d, win, causal in FLASH256_EDGES:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            q, k, v, do = flash_inputs(torch, gen, b, sq, h, kh, d, dt, sk=sk)
            d0 = fkernel.launches_bwd_d256
            fe = flash_check(torch, fkernel, fref, q, k, v, do, causal, win,
                             name)
            assert fkernel.launches_bwd_d256 - d0 == (dt == torch.bfloat16)
            o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=causal,
                                                      window=win)
            first, second = (fkernel.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=causal, window=win)
                for _ in range(2))
            assert all(torch.equal(x, z) for x, z in zip(first, second))
            print(f"flash D 256 backward edge B,Sq,Sk,H,K,D,window,causal="
                  f"{(b, sq, sk, h, kh, d, win, causal)} {name}: max abs err "
                  f"{fmt_errs(fe)}; two calls bit for bit")
    q, k, v, do = flash_inputs(torch, gen, 1, 96, 4, 1, 256, torch.float32)
    o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True, window=40)
    got = fkernel.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True,
                                           window=40)
    x64 = [t.double() for t in (q, k, v, do)]
    eo, el = fref.flash_attention_ref(*x64[:3], causal=True, window=40)
    want = fref.flash_attention_bwd_ref(*x64[:3], eo, el, x64[3], causal=True,
                                        window=40)
    pg = fref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                      window=40)
    e_kernel = max((g.double() - w).abs().max().item() for g, w in zip(got, want))
    e_plain = max((g.double() - w).abs().max().item() for g, w in zip(pg, want))
    assert e_kernel <= GRAD_TOL["float32"][0], e_kernel
    print(f"flash D 256 backward against float64 (B 1, S 96, H 4, K 1, window "
          f"40, float32): max abs err of dq, dk, dv: kernel {e_kernel:.3e}, "
          f"plain {e_plain:.3e}")
    for (b, s, h, kh, d, win), label in (
            (RG_TRAIN_ATTN, "the training microbatch"),
            (RG_RECIPE_ATTN, "the recipe's microbatch")):
        q, k, v, do = flash_inputs(torch, gen, b, s, h, kh, d,
                                   torch.bfloat16)
        fe = flash_check(torch, fkernel, fref, q, k, v, do, True, win,
                         "bfloat16")
        o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True,
                                                  window=win)
        first, second = (fkernel.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=True, window=win) for _ in range(2))
        assert all(torch.equal(x, z) for x, z in zip(first, second))
        del first, second
        ms = time_ms(torch, lambda i: fkernel.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=True, window=win), 1, inner=3, reps=7)
        plain_ms = time_ms(torch, lambda i: fref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=True, window=win), 1, inner=1, reps=3)
        kernels = device_profile(
            torch, lambda: fkernel.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal=True, window=win), n=3)[3]
        # the D 256 route: delta's kernel, the dK/dV kernel, the sum of its
        # shares (G > 1) and the dQ kernel, once each a call. Names only:
        # after the earlier phases' profiles the profiler may drop events
        # (a full run saw 6 of 12 launches), so counts are printed
        per_call = 3 + (h > kh)
        names = {}
        for e in kernels:
            base = kernel_name(e.key).split("<")[0]
            names[base] = names.get(base, 0) + e.count
        assert "flash_bwd_dkdv_d256_kernel" in names and set(names) <= {
            "flash_bwd_delta_kernel", "flash_bwd_dkdv_d256_kernel",
            "flash_bwd_d256_sum_kernel", "flash_bwd_dq_mma_kernel"}, names
        sdpa_bwd, backend = sdpa_windowed_bwd(torch, q, k, v, do, win)
        lib_ms = time_ms(torch, lambda i: sdpa_bwd(), 1, inner=3, reps=5)
        del sdpa_bwd
        pairs = window_pairs(s, win)
        bound, by = flash_bound_ms(b, s, h, kh, d, 2, pairs, True)
        print(f"flash D 256 backward at {label} B={b} S={s} H={h} K={kh} "
              f"D={d} window {win} bf16 ({pairs} visible pairs a head): "
              f"max abs err {fmt_errs(fe)}; two calls bit for bit; kernel "
              f"{ms:.3f} ms ({10 * b * h * d * pairs / ms / 1e9:.1f} "
              f"TFLOP/s), 3 calls under the profiler, "
              f"{sum(names.values())} of {3 * per_call} launches seen: "
              + "; ".join(f"{kernel_name(e.key)} "
                          f"{dev_us(e) / e.count / 1e3:.3f} ms x{e.count}"
                          for e in kernels)
              + f"; plain {plain_ms:.3f} ms, sdpa backward with the window as "
              f"a mask {lib_ms:.3f} ms (backend {backend}), bound "
              f"{bound:.4f} ms ({by})")
        del q, k, v, do, o, lse
        if (b, s, h, kh, d, win) != RG_TRAIN_ATTN:
            continue
        out.append({"name": "flash_attention_bwd_d256", "route": "cuda",
                    "source": "src/repro_torch/kernels/attention/csrc/"
                              "flash_attention.cu",
                    "replaces": "none (backward of src/repro/kernels/"
                                "attention/kernel.py:69; the reference "
                                "differentiates "
                                "src/repro/models/layers.py:243)",
                    "max_abs_err": max(fe[n][0] for n in ("dq", "dk", "dv")),
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by, "library_ms": lib_ms})

    # SSD
    runs = ([(case, dt, torch.float32, False) for case in SSD_CASES + SSD_RAGGED
             for dt in (torch.float32, torch.bfloat16)]
            + [(case, dt, torch.bfloat16, shared) for case in SSD_EDGES
               for dt in (torch.float32, torch.bfloat16)
               for shared in (False, True)])
    runs += [((*case, skernel.BWD_CHUNK), dt, torch.bfloat16, shared)
             for case in SSD_BWD_EDGES for dt in (torch.float32, torch.bfloat16)
             for shared in (False, True)]
    for case, dt, bc_dt, shared in runs:
        se = ssd_bwd_case(torch, gen, skernel, sref, *case, dt, bc_dt, shared)
        print(f"ssd backward case b,s,h,p,n,chunk={case} x {str(dt)[6:]} B/C "
              f"{str(bc_dt)[6:]}{' shared' if shared else ''} "
              f"({skernel.plan_bwd(*case[:5], bc_dt).route} route): max abs err "
              + ", ".join(f"{k} {e:.3e}" for k, (e, _) in se.items()))
    for decay in (False, True):
        se = ssd_bwd_case(torch, gen, skernel, sref, 2, 300, 4, 32, 64, 64,
                          torch.float32, torch.bfloat16, True, decay=decay,
                          f64=True)
        print(f"ssd backward against float64 (b 2, s 300, h 4, p 32, n 64, "
              f"{'the model' if decay else 'the test'}'s decay): max abs err "
              + ", ".join(f"{k} {e:.3e} (scale {sc:.3e})"
                          for k, (e, sc) in se.items()))
    b, s, h, p, n, chunk = M2_TRAIN_SSD
    x, _, B, C = ssd_inputs(torch, gen, b, s, h, p, n,
                            bc_dtype=torch.bfloat16, heads_share_bc=True)
    dA = model_decay(torch, gen, b, s, h)
    dy = torch.randn(x.shape, generator=gen, device="cuda") * 0.5
    dst = torch.randn((b, h, p, n), generator=gen, device="cuda") * 0.1
    tc0 = skernel.launches_bwd_tc
    got = skernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
    assert skernel.launches_bwd_tc == tc0 + 1     # the tensor-core route
    want = sref.ssd_bwd(x.double(), dA, B, C, dy, dst, chunk=chunk)
    tol = SSD_TOL["float32"]
    se = {name: close_scaled(g, w, tol, tol)
          for name, g, w in zip(("dx", "ddA", "dB", "dC"), got, want)}
    pg = sref.ssd_bwd(x, dA, B, C, dy, dst, chunk=chunk)
    e_plain = {name: (g.double() - w).abs().max().item()
               for name, g, w in zip(("dx", "ddA", "dB", "dC"), pg, want)}
    del want, pg
    again = skernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
    assert all(torch.equal(u, z) for u, z in zip(got, again))
    del got, again
    ms = time_ms(torch, lambda i: skernel.ssd_bwd_cuda(x, dA, B, C, dy, dst),
                 1, inner=3, reps=7)
    plain_ms = time_ms(torch, lambda i: sref.ssd_bwd(x, dA, B, C, dy, dst,
                                                     chunk=chunk),
                       1, inner=1, reps=3)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            skernel.ssd_bwd_cuda(x, dA, B, C, dy, dst)
        torch.cuda.synchronize()
    parts = {kernel_name(ev.key): dev_us(ev) / ev.count / 1e3
             for ev in prof.key_averages() if "ssd_bwd" in ev.key}
    bd = ssd_bwd_bound_ms(b, s, h, p, n, 4, 2 * b * s * n * B.element_size())
    (bound, by), (core_bound, core_by) = bd["tc"], bd["cuda_core"]
    regs = ptxas_report(skernel.build(), r"ssd_bwd_(?:tc_)?[a-z]+_kernel")
    pl = skernel.plan_bwd(b, s, h, p, n, B.dtype)
    assert pl.route == "tc", pl
    smem = {k: skernel.smem_bytes(k, x.dtype, pl.chunk)
            for k in ("bwd_state", "bwd_grad")}
    print(f"ssd backward at mamba2-370m's training microbatch b={b} s={s} "
          f"h={h} p={p} n={n} (x float32, B and C bf16 shared by the heads, "
          f"the model's decay), route {pl.route}: 2 launches a call "
          f"(ssd_bwd_tc_state_kernel with the row pass, ssd_bwd_tc_grad_kernel) "
          f"in chunks of {pl.chunk}, shared memory a block state "
          f"{smem['bwd_state']} B, grad {smem['bwd_grad']} B, workspace "
          f"{pl.workspace_bytes} B: against the plain version in float64, max "
          f"abs err " + ", ".join(f"{k} {e:.3e} (scale {sc:.3e})"
                                  for k, (e, sc) in se.items())
          + "; the float32 plain version's: "
          + ", ".join(f"{k} {e:.3e}" for k, e in e_plain.items())
          + f"; two calls bit for bit; kernel {ms:.4f} ms "
          f"({bd['f32'] / ms / 1e9:.1f} TFLOP/s of the function's float32 "
          f"operations), its launches "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; plain {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}: "
          f"{bd['f32']:.4e} float32-accurate operations, 6 (p, n) "
          f"multiply-adds a step and head, as 3 TF32 products "
          f"each at {TF32_OPS_PER_S / 1e12:.0f} TFLOP/s; {bd['bytes']} bytes); "
          f"CUDA-core bound {core_bound:.4f} ms ({core_by}, "
          f"{FP32_OPS_PER_S / 1e12:.0f} TFLOP/s); -Xptxas -v "
          + ", ".join(f"{k} {r} registers, {sp} B spilled"
                      for k, (r, sp) in regs.items())
          + "; no single PyTorch call computes the SSD scan", flush=True)
    out.append({"name": "ssd_bwd", "route": "cuda",
                "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan.cu",
                "replaces": "none (backward of src/repro/kernels/ssd/"
                            "kernel.py:67; the reference differentiates "
                            "src/repro/models/mamba2.py:47)",
                "max_abs_err": max(e for e, _ in se.values()), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": None})
    return out


def recurrent_counts(rkernel, fkernel, skernel) -> dict:
    """The launch counters of the recurrent families' kernels, by the keys
    of :func:`train_launches`, and the calls the C entries ran on the
    flash forward's tensor-core kernel, the flash backward's D 256 route
    and the SSD's tensor-core routes."""
    return {"scan": rkernel.launches, "scan_bwd": rkernel.launches_bwd,
            "flash_fwd": fkernel.launches_fwd,
            "flash_bwd": fkernel.launches_bwd,
            "flash_fwd_mma": fkernel.launches_fwd_mma,
            "flash_bwd_d256": fkernel.launches_bwd_d256,
            "ssd": skernel.launches, "ssd_tc": skernel.launches_tc,
            "ssd_bwd": skernel.launches_bwd,
            "ssd_bwd_tc": skernel.launches_bwd_tc}


def zero_counts(rkernel, fkernel, skernel) -> None:
    rkernel.launches = rkernel.launches_bwd = 0
    fkernel.launches_fwd = fkernel.launches_bwd = fkernel.launches_fwd_mma = 0
    fkernel.launches_bwd_d256 = 0
    skernel.launches = skernel.launches_tc = skernel.launches_bwd = 0
    skernel.launches_bwd_tc = 0


def checked_kernels(torch, rkernel, rref, fkernel, fref, skernel, sref,
                    errs: dict):
    """Patches that hold every kernel call of a pass to its plain version on
    that call's own inputs, errors appended to ``errs[name]``: the RG-LRU
    scan and its backward bit for bit (by design) and at 1e-5 under
    :func:`close_scaled`; the flash forward (o, lse) and backward (dq, dk,
    dv), and the SSD scan (y, state) and its backward (dx, ddA, dB, dC),
    against the plain versions computed in float64 on the same inputs (at
    full width the float32 plain versions themselves come near the bound
    from float64: ROADMAP queue 3), at the reference's tolerances."""
    real = {"scan": rkernel.rglru_scan_cuda,
            "scan_bwd": rkernel.rglru_scan_bwd_cuda,
            "flash_fwd": fkernel.flash_attention_fwd_cuda,
            "flash_bwd": fkernel.flash_attention_bwd_cuda,
            "ssd": skernel.ssd_cuda, "ssd_bwd": skernel.ssd_bwd_cuda}

    def scan(a, b):
        y, h = real["scan"](a, b)
        wy, wh = rref.rglru(a, b)
        assert torch.equal(y, wy) and torch.equal(h, wh)
        errs.setdefault("scan", []).append(
            close_scaled(y, wy, RGLRU_TOL, RGLRU_TOL))
        return y, h

    def scan_bwd(a, y, dy, dh):
        da, db = real["scan_bwd"](a, y, dy, dh)
        wa, wb = rref.rglru_bwd(a, y, dy, dh)
        assert torch.equal(da, wa) and torch.equal(db, wb)
        errs.setdefault("scan_bwd", []).append(max(
            close_scaled(da, wa, RGLRU_TOL, RGLRU_TOL),
            close_scaled(db, wb, RGLRU_TOL, RGLRU_TOL)))
        return da, db

    def flash_fwd(q, k, v, causal, window):
        o, lse = real["flash_fwd"](q, k, v, causal=causal, window=window)
        wo, wl = fref.flash_attention_ref(q.double(), k.double(), v.double(),
                                          causal=causal, window=window)
        close(lse, wl, TOL["float32"])
        errs.setdefault("flash_fwd", []).append(
            close_scaled(o, wo, TOL["bfloat16"], TOL["bfloat16"]))
        return o, lse

    def flash_bwd(q, k, v, o, lse, do, causal, window):
        got = real["flash_bwd"](q, k, v, o, lse, do, causal=causal,
                                window=window)
        want = fref.flash_attention_bwd_ref(
            *(t.double() for t in (q, k, v, o, lse, do)), causal=causal,
            window=window)
        errs.setdefault("flash_bwd", []).append(max(
            close_scaled(g, w, *GRAD_TOL["bfloat16"])
            for g, w in zip(got, want)))
        return got

    def ssd(x, dA, B, C, chunk):
        y, st = real["ssd"](x, dA, B, C, chunk=chunk)
        wy, wst = sref.ssd_chunked(x.double(), dA, B, C, chunk=chunk)
        tol = SSD_TOL["float32"]
        errs.setdefault("ssd", []).append(max(close_scaled(y, wy, tol, tol),
                                              close_scaled(st, wst, tol, tol)))
        return y, st

    def ssd_bwd(x, dA, B, C, dy, dstate):
        got = real["ssd_bwd"](x, dA, B, C, dy, dstate)
        want = sref.ssd_bwd(x.double(), dA, B, C, dy, dstate,
                            chunk=skernel.BWD_CHUNK)
        tol = SSD_TOL["float32"]
        errs.setdefault("ssd_bwd", []).append(max(
            close_scaled(g, w, tol, tol) for g, w in zip(got, want)))
        return got

    return [mock.patch.object(rkernel, "rglru_scan_cuda", scan),
            mock.patch.object(rkernel, "rglru_scan_bwd_cuda", scan_bwd),
            mock.patch.object(fkernel, "flash_attention_fwd_cuda", flash_fwd),
            mock.patch.object(fkernel, "flash_attention_bwd_cuda", flash_bwd),
            mock.patch.object(skernel, "ssd_cuda", ssd),
            mock.patch.object(skernel, "ssd_bwd_cuda", ssd_bwd)]


def recurrent_train_phase(torch, np, spec: dict, kernels: tuple,
                          card: str) -> dict:
    """Full-width, full-depth ``spec["arch"]`` trained by the training
    entry point (``repro_torch.launch.train``) on ``LMPipeline`` batches:
    granite's recipe (:data:`TRAIN_RECIPE`) in ``spec["accum"]``
    microbatches. Prints the launch counts worked out from the layer
    pattern (:func:`train_launches`) before the run and checks them exactly
    after it, with every bf16 flash forward on the tensor-core kernel and
    every SSD forward on the tensor-core route; checks finite, falling
    losses; then on one microbatch holds every kernel call, forward and
    backward, to its plain version (:func:`checked_kernels`), checks that
    every parameter leaf's gradient is finite and not all zero, and
    compares the microbatch's loss before and after the steps; profiles one
    step. Returns the run's launches by counter (:func:`recurrent_counts`)."""
    import contextlib

    from repro_torch import configs
    from repro_torch.data.lm import LMDataConfig, LMPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree, tree_leaves
    from repro_torch.train import trainer

    rkernel, rref, fkernel, fref, skernel, sref = kernels
    cfg = configs.get(spec["arch"])
    r = TRAIN_RECIPE
    accum, steps = spec["accum"], r["steps"]
    argv = ["--arch", spec["arch"], "--init", spec["init"],
            "--steps", str(steps), "--global-batch", str(r["global_batch"]),
            "--accum", str(accum), "--seq", str(r["seq"]), "--lr", str(r["lr"]),
            "--optimizer", "adamw", "--seed", str(SEED)]
    want = train_launches(cfg, accum, steps)
    print(f"{spec['arch']} train: python -m repro_torch.launch.train "
          f"{' '.join(argv)} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.param_count()} parameters in bf16, remat {cfg.remat}); "
          f"launches worked out from the layer pattern: "
          + ", ".join(f"{k} {v}" for k, v in want.items()), flush=True)
    tc = trainer.TrainConfig(optimizer="adamw", lr=r["lr"], accum=accum)
    loss_fn = trainer.make_loss_fn(cfg, tc)
    mb = {k: v[0] for k, v in LMPipeline(LMDataConfig(
        vocab=cfg.vocab, seq=r["seq"], global_batch=r["global_batch"],
        accum=accum, seed=SEED)).batch_at(0).items()}
    params = init_tree(registry.decls(cfg), SEED, "cuda", dtype=torch.bfloat16)
    if spec["init"] == "true-fan-in":
        params = registry.true_fan_in(params, cfg)
    with torch.no_grad():
        loss_before = loss_fn(params, mb)[0].item()
    del params
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    zero_counts(rkernel, fkernel, skernel)
    run = launch_train.main(argv)
    got = recurrent_counts(rkernel, fkernel, skernel)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert {k: got[k] for k in want} == want, (got, want)
    assert got["flash_fwd_mma"] == got["flash_fwd"], got
    assert got["flash_bwd_d256"] == got["flash_bwd"], got
    assert got["ssd_tc"] == got["ssd"], got
    assert got["ssd_bwd_tc"] == got["ssd_bwd"], got
    losses, times = run.losses, run.seconds
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert all(np.isfinite(run.grad_norms)), run.grad_norms
    assert losses[-1] < losses[0], losses
    assert torch.equal(run.data.batch_at(0)["tokens"][0], mb["tokens"])
    tokens = r["global_batch"] * r["seq"]
    step_flops = 6 * cfg.param_count() * tokens
    steady = statistics.median(times[1:])
    print(f"{spec['arch']} train on {card}: step {steady:.3f} s (median of "
          f"steps 2-{steps}; step 1 {times[0]:.3f} s), {tokens / steady:.0f} "
          f"tokens/s, mfu {step_flops / (steady * BF16_OPS_PER_S):.4f} (6 N T "
          f"= {step_flops:.4e} FLOPs a step at 989 TFLOP/s), peak memory "
          f"{peak_gb:.2f} GB; launches "
          + ", ".join(f"{k} {got[k]}" for k in want)
          + (f" (as worked out; all {got['ssd_bwd_tc']} SSD backwards on the "
             f"tensor-core route)" if cfg.family == "ssm" else
             f" (as worked out; all {got['flash_bwd_d256']} flash backwards "
             f"on the D 256 route)")
          + f"; losses {' '.join(f'{x:.4f}' for x in losses)}; "
          f"grad norms {' '.join(f'{x:.4f}' for x in run.grad_norms)}",
          flush=True)

    # one microbatch: every kernel call held to its plain version, and the
    # gradient of every parameter leaf
    errs: dict = {}
    key, n_stack = registry.stacked(cfg)
    zero_counts(rkernel, fkernel, skernel)
    with contextlib.ExitStack() as stack:
        for patch in checked_kernels(torch, *kernels, errs):
            stack.enter_context(patch)
        tree, leaves = trainer._layer_leaves(run.params, key, n_stack)
        loss, _ = loss_fn(tree, mb)
        grads = torch.autograd.grad(loss, leaves)
    one = train_launches(cfg, 1, 1)
    assert {k: len(errs.get(k, [])) for k in one} == one, \
        ({k: len(v) for k, v in errs.items()}, one)
    bad = [i for i, g in enumerate(grads)
           if not bool(torch.isfinite(g).all()) or not bool((g != 0).any())]
    assert not bad, f"{len(bad)} of {len(grads)} leaves have a non-finite or " \
                    f"all-zero gradient (first: leaf {bad[0]})"
    n_leaves = len(grads)
    del grads, leaves, tree
    assert loss.item() < loss_before, (loss.item(), loss_before)
    span = lambda xs: (f"max abs err {max(e for e, _ in xs):.3e}, scales "
                       f"{min(s for _, s in xs):.3e} to "
                       f"{max(s for _, s in xs):.3e}")
    print(f"{spec['arch']} train: on one microbatch every kernel call held to "
          f"its plain version on its own inputs: "
          + "; ".join(f"{k} x{len(v)} {span(v)}" for k, v in errs.items())
          + f" (scans bit for bit; the flash and SSD calls against float64); "
          f"all {n_leaves} parameter leaves have finite, not all-zero "
          f"gradients; loss on that microbatch {loss_before:.4f} before the "
          f"{steps} steps, {loss.item():.4f} after", flush=True)
    del errs, loss

    # one step under the profiler
    batch = run.data.batch_at(steps)
    wall_ms, busy_ms, launches, kern = device_profile(
        torch, lambda: run.train_step(run.params, run.opt_state, batch))
    ours = ("rglru_scan", "flash_", "ssd_")
    shares, seen = {}, 0
    for e in kern:
        name = kernel_name(e.key)
        if name.startswith(ours):
            shares[name] = shares.get(name, 0.0) + dev_us(e) / 1e3
            seen += e.count
    # device kernels a step launches: a call of the scan, its backward or
    # the flash forward is one; a D 256 flash backward four (delta, dK/dV,
    # the sum of its shares over recurrentgemma's G 10, dQ); an SSD call
    # three; its backward two (the tensor-core route, which every call of
    # the run took)
    one = train_launches(cfg, accum, 1)
    weights = {"scan": 1, "scan_bwd": 1, "flash_fwd": 1, "flash_bwd": 4,
               "ssd": 3, "ssd_bwd": 2}
    expected = sum(weights[k] * v for k, v in one.items())
    top = "; ".join(f"{kernel_name(e.key)[:40]} {dev_us(e) / 1e3:.1f} ms "
                    f"x{e.count}" for e in kern[:6])
    what, prefixes = (("the SSD backward", ("ssd_bwd",))
                      if cfg.family == "ssm" else
                      ("the flash backward", ("flash_bwd",)))
    bwd_ms = sum(v for k, v in shares.items() if k.startswith(prefixes))
    top = (f"{what} {bwd_ms:.1f} ms ({100 * bwd_ms / busy_ms:.1f}% of device "
           f"time); " + top)
    print(f"{spec['arch']} train profile on {card}, one step: wall "
          f"{wall_ms:.1f} ms (under the profiler), device busy {busy_ms:.1f} "
          f"ms ({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} kernel "
          f"launches; the port's kernels' share of device time ({seen} of "
          f"their {expected} launches seen: fewer means the profiler dropped "
          f"events and these are lower bounds): "
          + "; ".join(f"{k} {v:.2f} ms ({100 * v / busy_ms:.2f}%)"
                      for k, v in sorted(shares.items()))
          + f"; top device time: {top}", flush=True)
    del run, batch
    return got


def small_recurrent_train_reference_phase(torch, np) -> None:
    """The card's training path against the CPU's plain path on a small
    input: the recurrentgemma smoke config (attention at its true fan-in)
    and the mamba2 smoke config, float32 params, remat full, one AdamW
    step of 2 microbatches of 2 x 48 tokens from the same params and numpy
    batches. The gradients handed to AdamW agree leaf by leaf at
    :data:`RECURRENT_GRAD_TOL`; loss, grad norm and every parameter after
    the step at :data:`RECURRENT_STEP_TOL` (both families run bf16
    activations); and the card's step went through every kernel of its
    family."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.rglru import kernel as rkernel
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree, tree_leaves, tree_map
    from repro_torch.train.trainer import (TrainConfig, make_grad_fn,
                                           make_train_step)

    loss_tol, norm_tol, share_tol = RECURRENT_STEP_TOL
    for arch in ("recurrentgemma_2b", "mamba2_370m"):
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32",
                                  remat="full")
        params = registry.true_fan_in(
            init_tree(registry.decls(cfg), SEED, "cpu"), cfg)
        rng = np.random.default_rng(SEED)
        toks = rng.integers(0, cfg.vocab, size=(2, 2, 49))
        batch = {"tokens": torch.from_numpy(toks[..., :-1]),
                 "labels": torch.from_numpy(toks[..., 1:])}
        tc = TrainConfig(accum=2)
        out, grads = {}, {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev, copy=True), params)
            grads[dev] = [g.double().cpu().numpy() for g in
                          tree_leaves(make_grad_fn(cfg, tc)(p, batch)[2])]
            step, opt = make_train_step(cfg, tc)
            zero_counts(rkernel, fkernel, skernel)
            m = step(p, opt.init(p), batch)[2]
            counts = recurrent_counts(rkernel, fkernel, skernel)
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        [t.cpu() for t in tree_leaves(p)])
        want = train_launches(cfg, 2, 1)
        assert {k: counts[k] for k in want} == want, (counts, want)
        gerrs = leaf_grad_errs(grads["cuda"], grads["cpu"])
        gtol = RECURRENT_GRAD_TOL[cfg.family]
        assert max(gerrs) <= gtol, (max(gerrs), gerrs.index(max(gerrs)))
        (lc, gc, pc), (lg, gg, pg) = out["cpu"], out["cuda"]
        np.testing.assert_allclose(lg, lc, rtol=loss_tol)
        np.testing.assert_allclose(gg, gc, rtol=norm_tol)
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
        assert diffs.max().item() <= 2 * tc.lr, diffs.max().item()
        share = (diffs > 2e-6).float().mean().item()
        assert share < share_tol, share
        print(f"small train reference ({cfg.name}, float32 params, one step "
              f"of 2 x 2 x 48 tokens, kernels "
              + ", ".join(f"{k} {v}" for k, v in want.items())
              + f") on the card vs the CPU's plain path: gradients of all "
              f"{len(gerrs)} leaves within {gtol} (relative 2-norm, largest "
              f"{max(gerrs):.3e}, median {statistics.median(gerrs):.3e}); "
              f"loss {lg:.6f} vs "
              f"{lc:.6f}, grad norm {gg:.6f} vs {gc:.6f}; params max abs diff "
              f"{diffs.max().item():.3e}, {100 * share:.3f}% of elements "
              f"above 2e-6")


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (the CGRA) and the paper's healthcare pipeline
# ---------------------------------------------------------------------------

# B, S, D, W (tests/test_kernels.py:167-169), then W 1, ragged S and D
CONV_CASES = [(2, 64, 32, 4), (1, 256, 128, 4), (3, 32, 16, 2), (1, 64, 64, 8)]
CONV_RAGGED = [(2, 64, 32, 1), (2, 37, 13, 3), (1, 1, 5, 4), (3, 100, 200, 8)]
CONV_TOL = {"float32": 1e-5, "bfloat16": 5e-2}     # tests/test_kernels.py:175
# the seizure CNN's three layers: (B, S, D) of each depthwise call, W 4
HEALTH_SHAPES = [(1, 1024, 32), (1, 512, 32), (1, 256, 16)]
RG_CONV = (8, 4096, 2560, 4)      # B, S, D, W: recurrentgemma-2b's conv, bf16
CGRA_LAUNCHES = 23 + 32 + 32      # one depthwise call per input channel


def conv_inputs(torch, gen, b, s, d, w, dtype=None, broadcast=False):
    """x (B, S, D) and taps (W, D) on the card; ``broadcast`` expands one
    channel over D with stride 0, as the seizure CNN's CGRA path does."""
    dtype = dtype or torch.float32
    x = torch.randn((b, s, 1 if broadcast else d), generator=gen,
                    device="cuda").to(dtype)
    if broadcast:
        x = x.expand(b, s, d)
    taps = (0.4 * torch.randn((w, d), generator=gen, device="cuda")).to(dtype)
    return x, taps


def conv_check(torch, ckernel, cref, x, taps) -> float:
    """Kernel against the plain version in float32 (the reference's own
    test holds its bf16 kernel to the float32 oracle); float32 inputs must
    agree bit for bit (the kernel rounds each product and sum as the plain
    version does)."""
    got = ckernel.conv1d_cuda(x, taps)
    want = cref.conv1d(x.float(), taps.float())
    torch.cuda.synchronize()
    name = str(x.dtype).split(".")[1]
    err = close_at(got, want, CONV_TOL[name], CONV_TOL[name])
    if x.dtype == torch.float32 and taps.dtype == torch.float32:
        assert torch.equal(got, want), f"float32 not bitwise: {err:.3e}"
    return err


def conv_bytes(x, taps) -> int:
    """Bytes one call must move: each distinct input element read once (an
    input expanded with stride 0 counts its storage once), y written once,
    the taps as float32 (the kernel's accumulation type)."""
    distinct = 1
    for n, st in zip(x.shape, x.stride()):
        distinct *= n if st else 1
    return distinct * x.element_size() + x.numel() * x.element_size() \
        + taps.numel() * 4


def graph_ms(torch, fn, inner: int = 100, reps: int = 11) -> float:
    """Median ms per call of ``fn`` replayed from a CUDA graph of ``inner``
    calls (CUDA events around each replay): the device's time for the call,
    without the host's time to issue it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def conv_timing(torch, ckernel, cref, x, taps, label: str) -> dict:
    """Kernel, plain version and cuDNN's depthwise conv (the yardstick,
    never called by the port) with CUDA events, and the call's bound. At a
    small shape, where issuing a call from Python takes longer than the
    card takes to run it, the three are also timed replayed from a CUDA
    graph, and the JSON entry reports those device times."""
    b, s, d = x.shape
    w = taps.shape[0]
    cudnn = lambda: torch.nn.functional.conv1d(
        x.transpose(1, 2), taps.T[:, None, :].to(x.dtype), groups=d,
        padding=w - 1)[..., :s].transpose(1, 2)
    name = str(x.dtype).split(".")[1]
    want = cref.conv1d(x.float(), taps.float())
    lib_err = close_at(cudnn(), want, CONV_TOL[name], CONV_TOL[name])
    err = conv_check(torch, ckernel, cref, x, taps)
    big = x.numel() > 1 << 20
    ms = time_ms(torch, lambda i: ckernel.conv1d_cuda(x, taps), 1,
                 inner=10 if big else 100)
    plain_ms = time_ms(torch, lambda i: cref.conv1d(x, taps), 1,
                       inner=5 if big else 50, reps=11)
    library_ms = time_ms(torch, lambda i: cudnn(), 1, inner=10 if big else 100)
    times = (f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
             f"cudnn depthwise conv {library_ms * 1e3:.2f} us")
    if not big:
        times = (f"issued eagerly (CUDA events over back-to-back calls): "
                 f"{times}; replayed from a CUDA graph (the card's time): ")
        ms = graph_ms(torch, lambda: ckernel.conv1d_cuda(x, taps))
        plain_ms = graph_ms(torch, lambda: cref.conv1d(x, taps))
        library_ms = graph_ms(torch, cudnn)
        times += (f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                  f"cudnn depthwise conv {library_ms * 1e3:.2f} us")
    moved = conv_bytes(x, taps)
    ops = 2 * w * x.numel()
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    print(f"conv1d {label} B={b} S={s} D={d} W={w} x {name}"
          f"{' (stride 0 over D)' if x.stride(2) == 0 else ''}: {times} "
          f"(cudnn's max abs err vs plain {lib_err:.3e}); bound "
          f"{bound * 1e3:.4f} us "
          f"({'bytes' if t_bytes >= t_ops else 'operations'}: {moved} bytes "
          f"at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, {ops} float32 operations); "
          f"kernel max abs err vs plain {err:.3e}")
    return {"name": "conv1d_causal", "route": "cuda",
            "source": "src/repro_torch/kernels/conv1d/csrc/conv1d_causal.cu",
            "replaces": "src/repro/kernels/conv1d/kernel.py:36",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def conv1d_phase(torch, ckernel, cref) -> dict:
    """The CUDA depthwise causal conv against its plain version on the
    reference's cases (float32 and bfloat16), at W 1, ragged S and D, a
    stride-0 and a transposed input, against a float64 oracle, and at the
    healthcare layers' shapes; then timed at layer 0's shape (the path's
    own) and at one shape where bytes dominate. Returns the kernel's JSON
    entry (no launches), timed at the path's shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for case in CONV_CASES + CONV_RAGGED:
        for dt in (torch.float32, torch.bfloat16):
            x, taps = conv_inputs(torch, gen, *case, dtype=dt)
            err = conv_check(torch, ckernel, cref, x, taps)
            print(f"conv1d case B,S,D,W={case} {str(dt).split('.')[1]}: max "
                  f"abs err {err:.3e}")
    # float32 x with bf16 taps, a stride-0 input and a transposed input
    x, taps = conv_inputs(torch, gen, 2, 50, 24, 4)
    errs = [conv_check(torch, ckernel, cref, x, taps.to(torch.bfloat16)),
            conv_check(torch, ckernel, cref, *conv_inputs(
                torch, gen, 2, 70, 40, 4, broadcast=True)),
            conv_check(torch, ckernel, cref,
                       x.transpose(0, 1).contiguous().transpose(0, 1), taps)]
    print(f"conv1d float32 x with bf16 taps, stride-0 input, transposed "
          f"input: max abs err {max(errs):.3e}")
    # float64 oracle: kernel and plain version (float32) against it
    x, taps = conv_inputs(torch, gen, 2, 300, 48, 4)
    exact = cref.conv1d(x.double(), taps.double())
    e_kernel = (ckernel.conv1d_cuda(x, taps).double() - exact).abs().max().item()
    e_plain = (cref.conv1d(x, taps).double() - exact).abs().max().item()
    assert e_kernel <= CONV_TOL["float32"], e_kernel
    print(f"conv1d against float64 (B 2, S 300, D 48, W 4): max abs err "
          f"kernel {e_kernel:.3e}, plain {e_plain:.3e}")
    for b, s, d in HEALTH_SHAPES:
        err = conv_check(torch, ckernel, cref, *conv_inputs(
            torch, gen, b, s, d, 4, broadcast=True))
        print(f"conv1d at the seizure CNN's shape ({b}, {s}, {d}), W 4, "
              f"stride-0 input: max abs err {err:.3e} (bitwise equal)")
    entry = conv_timing(torch, ckernel, cref, *conv_inputs(
        torch, gen, *HEALTH_SHAPES[0], 4, broadcast=True),
        "at the path's shape (seizure CNN layer 0)")
    b, s, d, w = RG_CONV
    conv_timing(torch, ckernel, cref, *conv_inputs(
        torch, gen, b, s, d, w, dtype=torch.bfloat16),
        "not on any path (both packages run that conv plain), at "
        "recurrentgemma's conv shape,")
    return entry


def healthcare_phase(torch, np, ckernel, cref, card: str) -> int:
    """The flow of ``examples/healthcare_pipeline.py`` through the port on
    the card: the HEEPocrates platform with the CGRA attached, bank gating
    from each acquisition, the heartbeat classifier, the seizure CNN on the
    host path and through the CGRA (the conv1d kernel, one call per input
    channel), and the energy story. Checks 87 kernel launches per CGRA
    ``apply``, every one of those calls against the plain version on its
    own inputs, and the card's flags and logits against the CPU's plain
    path on the same seeded weights; prints wall times. Returns the launch
    count of the counted ``apply``."""
    import dataclasses

    from repro_torch.apps import healthcare as H
    from repro_torch.core import energy as E
    from repro_torch.core.platform import Platform, XHeepConfig
    from repro_torch.core.power import PowerState
    from repro_torch.core.xaif import REGISTRY
    from repro_torch.data import biosignal

    platform = Platform(XHeepConfig(core="cv32e20", bus="fully_connected",
                                    addressing="contiguous", n_banks=8))
    cgra = REGISTRY.get("conv1d", "cuda")
    platform.attach(cgra)
    assert (len(cgra.slave_ports), len(cgra.master_ports),
            cgra.bus_width_bits) == (2, 4, 128)
    assert "cgra" in platform.power.domains
    print(f"attached accelerator: {cgra.name} ({len(cgra.slave_ports)} slave "
          f"+ {len(cgra.master_ports)} master ports = {cgra.bus_width_bits} "
          f"bit/cycle)")
    for spec in (biosignal.HEARTBEAT_ECG, biosignal.SEIZURE_EEG):
        used = biosignal.AcquisitionSim(spec, n_banks=8).bank_states()
        for i, u in enumerate(used):
            platform.power.set_state(f"bank{i}",
                                     PowerState.ON if u else PowerState.OFF)
        on = [platform.power.is_active(f"bank{i}") for i in range(8)]
        assert on == used, (on, used)
        print(f"{spec.name}: window {spec.window_bytes / 1024:.1f} KiB -> "
              f"{sum(used)}/8 banks on; acquisition power "
              f"{E.power_acquisition(2):.0f} uW (paper: 286 uW)")

    # the main path: one CGRA apply, counted
    ckernel.launches = 0
    logits_cgra, macs_sz = H.run_seizure(0, impl="cgra")
    launches = ckernel.launches
    assert launches == CGRA_LAUNCHES, launches
    logits_host, _ = H.run_seizure(0, impl="host")
    assert np.allclose(logits_host, logits_cgra, atol=1e-4), (logits_host,
                                                             logits_cgra)
    flags, macs_hb = H.run_heartbeat(0)
    verdict = "SEIZURE" if logits_cgra[1] > logits_cgra[0] else "normal"
    print(f"heartbeat classifier: {int(flags.sum())} abnormal beats of "
          f"{flags.size} ({macs_hb} MACs on host CPU @ "
          f"{E.power_processing(True) / 1000:.2f} mW)")
    print(f"seizure CNN ({macs_sz} MACs): host == CGRA within 1e-4 (max abs "
          f"diff {np.abs(logits_host - logits_cgra).max():.3e}), verdict: "
          f"{verdict}; {launches} conv1d launches in one CGRA apply")

    # every conv1d call of one CGRA apply against the plain version on its
    # own inputs (these launches are not the counted run's)
    errs = []

    def checked(x, w):
        got = cgra.fn(x, w)
        errs.append(close_at(got, cref.conv1d(x, w), CONV_TOL["float32"],
                             CONV_TOL["float32"]))
        return got

    REGISTRY.register(dataclasses.replace(cgra, fn=checked),
                      allow_override=True)
    try:
        again, _ = H.run_seizure(0, impl="cgra")
    finally:
        REGISTRY.register(cgra, allow_override=True)
    assert len(errs) == CGRA_LAUNCHES and np.array_equal(again, logits_cgra)
    print(f"every conv1d call of one CGRA apply held to the plain version on "
          f"its own inputs: {len(errs)} calls, max abs err {max(errs):.3e} "
          f"(tolerance {CONV_TOL['float32']} + {CONV_TOL['float32']} * "
          f"|plain|)")

    # the card against the CPU's plain path on the same seeded weights
    cpu = {impl: H.run_seizure(0, impl=impl, device="cpu")[0]
           for impl in ("host", "cgra")}
    err = max(np.abs(logits_host - cpu["host"]).max(),
              np.abs(logits_cgra - cpu["cgra"]).max())
    assert err <= 1e-5, (logits_host, logits_cgra, cpu)
    model = H.HeartbeatModel()
    ecg = biosignal.ecg_window(biosignal.HEARTBEAT_ECG, seed=0)
    s0, thr0, sc, thrc = (t.cpu() for t in model._scores(ecg, None, "cuda"))
    w0, wthr0, wsc, wthrc = model._scores(ecg, None, "cpu")
    cpu_flags, _ = H.run_heartbeat(0, device="cpu")
    # a flag is compared where both of its scores clear their thresholds by
    # more than the two devices' difference in them
    gap = max((s0 - w0).abs().max().item(), (sc - wsc).abs().max().item(),
              abs(thr0 - wthr0).item(), abs(thrc - wthrc).item())
    clear = (((w0 - wthr0).abs() > 2 * gap + 1e-6)
             & ((wsc - wthrc).abs() > 2 * gap + 1e-6)).numpy()
    assert np.array_equal(flags[clear], cpu_flags[clear]), (flags, cpu_flags)
    print(f"card vs the CPU's plain path on the same seeded weights: seizure "
          f"logits max abs err {err:.3e} (tolerance 1e-5); heartbeat flags "
          f"equal at all {int(clear.sum())} of {clear.size} beats whose "
          f"margin clears the devices' score difference {gap:.3e}")

    # wall times of one apply and one classify, synchronised
    cnn = H.SeizureCNN()
    params = cnn.init("cuda")
    eeg = biosignal.eeg_window(biosignal.SEIZURE_EEG, seed=0, seizure=True)

    def wall_ms(fn, n=30):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    host_ms = wall_ms(lambda: cnn.apply(eeg, "host", params))
    cgra_ms = wall_ms(lambda: cnn.apply(eeg, "cgra", params))
    classify_ms = wall_ms(lambda: model.classify(ecg))
    n_prof = 3
    _, busy_ms, per_apply, kernels = device_profile(
        torch, lambda: cnn.apply(eeg, "cgra", params), n_prof)
    conv = [e for e in kernels if "conv1d_causal_kernel" in e.key]
    conv_us = sum(dev_us(e) for e in conv) / n_prof
    print(f"healthcare on {card}: seizure CNN apply host {host_ms:.3f} ms, "
          f"CGRA {cgra_ms:.3f} ms; heartbeat classify {classify_ms:.3f} ms "
          f"(medians of 30, synchronised); profiled CGRA apply: "
          f"{per_apply:.0f} launches, device busy {busy_ms:.3f} ms, of it "
          f"the {CGRA_LAUNCHES} conv1d calls {conv_us / 1e3:.3f} ms")

    # energy story (paper Fig. 6) and race-to-sleep
    e_cpu = E.conv_energy_uj(on_cgra=False)
    e_cgra = E.conv_energy_uj(on_cgra=True)
    assert abs(e_cpu / e_cgra - 4.9) / 4.9 < 0.02, e_cpu / e_cgra
    print(f"16x16 conv(3x3): host {e_cpu:.3f} uJ vs CGRA {e_cgra:.3f} uJ -> "
          f"{e_cpu / e_cgra:.1f}x benefit (paper: 4.9x)")
    for name in list(platform.power.states):
        if name != "host":
            platform.power.set_state(name, PowerState.OFF)
    leak = platform.power.leakage_uw()
    assert leak == 0.0, leak
    print(f"post-processing leakage: {leak} uW (accelerators power-gated)")
    return launches


# ---------------------------------------------------------------------------
# Grouped matmul and the MoE family's serving (the serve driver's path)
# ---------------------------------------------------------------------------

# E, C, D, F (tests/test_kernels.py:137-139), then ragged C, D and F (D or F
# off a multiple of 8 takes the mma.sync route's element-by-element loads)
GMM_CASES = [(4, 16, 32, 64), (2, 128, 64, 128), (8, 8, 16, 16)]
GMM_RAGGED = [(3, 37, 45, 77), (1, 1, 1, 1), (2, 200, 64, 136),
              (2, 130, 300, 129), (1, 300, 8, 8)]
# the edges of the bf16 TMA routes' tiles (wgmma: 128 x 256 output tiles,
# 64-deep D steps; split D: 16 x 128 tiles, chunks of 64-deep steps): C
# around 16, 64 and 128 rows, D off the 64-deep step, F around 128 and 256
# columns, 1 and 3 experts, and two cases where one persistent block walks
# tiles of two experts (100 and 30 tiles an expert on 132 SMs)
GMM_EDGES = ([(3, c, 72, 264) for c in (1, 8, 63, 64, 65, 127, 128, 129)]
             + [(1, c, d, 136) for d in (8, 56, 64, 72, 1008) for c in (8, 129)]
             + [(3, c, 56, f) for f in (8, 136, 256, 264) for c in (1, 65)]
             + [(2, 1280, 64, 2560), (3, 300, 1008, 1000)])
GMM_TOL = {"float32": 1e-4, "bfloat16": 5e-2}      # tests/test_kernels.py:147
GROK_LAYERS = 4                  # of grok-1's 64: 42.58 GB of bf16 weights
GROK_SERVE = {"batch": 8, "prompt_len": 1024, "steps": 64}
GROK_PARAMS = 21_290_539_008
# the expert FFN's four grouped-matmul shapes on that path: (label, E, C,
# D, F); C is the capacity (prefill: 8192 tokens x top-2 x 1.25 / 8
# experts; decode: min(8, T))
GMM_PATH = [("prefill gate/up", 8, 2560, 6144, 32768),
            ("prefill down", 8, 2560, 32768, 6144),
            ("decode gate/up", 8, 8, 6144, 32768),
            ("decode down", 8, 8, 32768, 6144)]


def gmm_inputs(torch, gen, e, c, d, f, dtype):
    """x ~ N(0, 1), w ~ N(0, 1 / D) (the fan-in init), drawn in dtype."""
    x = torch.randn((e, c, d), generator=gen, device="cuda", dtype=dtype)
    w = torch.randn((e, d, f), generator=gen, device="cuda", dtype=dtype)
    return x, w.mul_(d ** -0.5)


def gmm_bound_ms(e, c, d, f, elt, ops_per_s) -> tuple[float, str, int]:
    """The least time for one call: each input read and the output written
    once against ``2 E C D F`` operations at the type's peak."""
    moved = (e * c * d + e * d * f + e * c * f) * elt
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * e * c * d * f / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", moved


def gmm_route(gkernel, fn):
    """``fn()`` and the route its grouped-matmul launch took, by the C
    entry's report: ``"wgmma"``, ``"splitd"`` or ``"other"`` (the mma.sync
    and float32 routes)."""
    w0, s0 = gkernel.launches_wgmma, gkernel.launches_splitd
    out = fn()
    ran = ("wgmma" if gkernel.launches_wgmma > w0 else
           "splitd" if gkernel.launches_splitd > s0 else "other")
    return out, ran


def gmm_case(torch, gen, gkernel, gref, e, c, d, f, dt, scaled=False):
    """One call against the plain version at the reference's tolerance
    (``close_scaled`` where ``scaled``), its route against the plan's, and a
    second call's bits; returns the error and the route."""
    x, w = gmm_inputs(torch, gen, e, c, d, f, dt)
    y, ran = gmm_route(gkernel, lambda: gkernel.grouped_matmul_cuda(x, w))
    want = gref.grouped_matmul(x, w)
    tol = GMM_TOL[str(dt)[6:]]
    err = (close_scaled(y, want, tol, tol) if scaled else
           (close(y, want, tol), None))
    route = gkernel.plan(e, c, d, f, dt).route
    assert ran == (route if route in ("wgmma", "splitd") else "other"), \
        ((e, c, d, f), dt, route, ran)
    assert torch.equal(y, gkernel.grouped_matmul_cuda(x, w)), (e, c, d, f)
    return err, route


def gmm_phase(torch, gkernel, gref) -> dict:
    """The CUDA grouped matmul against its plain version: the reference's
    cases in float32 (1e-4) and bf16 (5e-2), ragged C, D and F, the edges
    of the TMA routes' tiles (``GMM_EDGES``), an input off 16-byte
    alignment, float32 against float64, and the four shapes of grok-1's
    expert FFN (bf16, each held with :func:`close_scaled`); every call's
    route by the C entry's report (bf16 prefill shapes on wgmma, decode
    shapes on split D), two calls giving the same bits; times kernel, plain
    version and ``torch.bmm`` (the yardstick, never called by the port) at
    the four shapes. Returns the kernel's JSON entry (no launches), timed
    at the prefill's gate/up shape."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    routes = {}
    for case in GMM_CASES + GMM_RAGGED + GMM_EDGES:
        for dt in (torch.float32, torch.bfloat16):
            err, route = gmm_case(torch, gen, gkernel, gref, *case, dt)
            routes[route] = routes.get(route, 0) + 1
            print(f"gmm E,C,D,F={case} {str(dt)[6:]} ({route}): max abs err "
                  f"{err[0]:.3e}")
    assert all(routes.get(r) for r in gkernel.ROUTES), routes
    # an input whose data starts 2 bytes past a 16-byte boundary takes the
    # mma.sync route, the aligned one wgmma
    x, w = gmm_inputs(torch, gen, 2, 64, 64, 64, torch.bfloat16)
    xo = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(
        x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    yo, ran_o = gmm_route(gkernel, lambda: gkernel.grouped_matmul_cuda(xo, w))
    ya, ran_a = gmm_route(gkernel, lambda: gkernel.grouped_matmul_cuda(x, w))
    assert (ran_o, ran_a) == ("other", "wgmma"), (ran_o, ran_a)
    assert torch.equal(yo, ya)
    x, w = gmm_inputs(torch, gen, 4, 96, 1000, 72, torch.float32)
    want = torch.einsum("ecd,edf->ecf", x.double(), w.double())
    e_kernel = (gkernel.grouped_matmul_cuda(x, w).double() - want).abs().max().item()
    e_plain = (gref.grouped_matmul(x, w).double() - want).abs().max().item()
    assert e_kernel <= GMM_TOL["float32"], e_kernel
    print(f"gmm routes of those calls: {routes}; against float64 (E 4, C 96, "
          f"D 1000, F 72, float32): max abs err kernel {e_kernel:.3e}, plain "
          f"{e_plain:.3e}; an input off 16-byte alignment (mma.sync route) "
          f"gives the aligned result (wgmma route) bit for bit")

    entry = None
    for label, e, c, d, f in GMM_PATH:
        err, route = gmm_case(torch, gen, gkernel, gref, e, c, d, f,
                              torch.bfloat16, scaled=True)
        prefill = c > 8
        assert route == ("wgmma" if prefill else "splitd"), (label, route)
        splits = gkernel.plan(e, c, d, f, torch.bfloat16).splits
        torch.cuda.empty_cache()
        x, w = gmm_inputs(torch, gen, e, c, d, f, torch.bfloat16)
        inner, reps = (3, 5) if prefill else (10, 11)
        ms = time_ms(torch, lambda i: gkernel.grouped_matmul_cuda(x, w), 1,
                     inner=inner, reps=reps)
        lib_ms = time_ms(torch, lambda i: torch.bmm(x, w), 1, inner=inner,
                         reps=reps)
        plain_ms = time_ms(torch, lambda i: gref.grouped_matmul(x, w), 1,
                           inner=1, reps=3)
        bound, by, moved = gmm_bound_ms(e, c, d, f, 2, BF16_OPS_PER_S)
        print(f"gmm at grok-1's {label} shape x ({e}, {c}, {d}) w ({e}, {d}, "
              f"{f}) bf16, {route} route (S {splits}): max abs err "
              f"{err[0]:.3e} (scale {err[1]:.3e}), two calls bit for bit; "
              f"kernel {ms:.4f} ms ({2 * e * c * d * f / ms / 1e9:.1f} "
              f"TFLOP/s, {moved / ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} "
              f"ms, torch.bmm {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
              f"{moved} bytes)", flush=True)
        if entry is None:
            entry = {"name": "grouped_matmul", "route": "cuda",
                     "source": "src/repro_torch/kernels/moe/csrc/"
                               "grouped_matmul.cu",
                     "replaces": "src/repro/kernels/moe/kernel.py:38",
                     "max_abs_err": err[0], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
        del x, w
        torch.cuda.empty_cache()
    return entry


def drops(eidx, n_exp: int, cap: int) -> int:
    """Slots dropped past the capacity: ``sum_e max(0, count_e - cap)``."""
    counts = eidx.reshape(-1).bincount(minlength=n_exp)
    return int((counts - cap).clamp_min(0).sum())


def grok_serve_phase(torch, np, gkernel, gref, fkernel, fref,
                     card: str) -> int:
    """Full-width grok-1 cut to 4 of its 64 layers, served by the serve
    driver (``repro_torch.launch.serve.run``): batch 8, a 1024-token
    prompt, 64 greedy steps, random bf16 weights from the seed. Checks the
    launch counts of every call (12 grouped matmuls on the wgmma route and
    4 flash forwards in the prefill, 12 grouped matmuls on the split-D
    route and no flash forward in each decode step), then holds every
    grouped-matmul call of a prefill of the same prompts and of one decode
    step, and every flash forward of that prefill (head dim 128), to the
    plain version on that call's own inputs (the flash lse to the plain
    version in float64), counts the prefill's dropped slots, and profiles
    a prefill and a decode step. Returns the run's grouped-matmul launch
    count, the config and the weights (for the lane engine's phase)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers as L

    cfg = dataclasses.replace(configs.get("grok_1_314b"), n_layers=GROK_LAYERS)
    b, s, steps = (GROK_SERVE[k] for k in ("batch", "prompt_len", "steps"))
    print(f"moe serve: repro_torch.launch.serve.run(grok-1-314b at "
          f"{GROK_LAYERS} layers, batch {b}, prompt {s}, steps {steps}, seed "
          f"{SEED})", flush=True)
    gkernel.launches = fkernel.launches_fwd = fkernel.launches_fwd_mma = 0
    gkernel.launches_wgmma = gkernel.launches_splitd = 0
    run, calls = counted_serve(
        launch_serve, lambda: launch_serve.run(cfg, b, s, steps, seed=SEED),
        lambda: (gkernel.launches, fkernel.launches_fwd,
                 fkernel.launches_fwd_mma, gkernel.launches_wgmma,
                 gkernel.launches_splitd))
    launches = gkernel.launches
    per_call = 3 * cfg.n_layers                 # gate, up, down a layer
    assert cfg.param_count() == GROK_PARAMS, cfg.param_count()
    # the flash forwards (bf16, D 128) on the tensor-core kernel; every
    # grouped matmul of the prefill on the wgmma route, of a decode step on
    # the split-D route
    assert calls[0] == ("prefill", per_call, cfg.n_layers, cfg.n_layers,
                        per_call, 0), calls[0]
    assert calls[1:] == [("decode", per_call, 0, 0, 0, per_call)] * steps, \
        calls[1:4]
    assert launches == per_call * (1 + steps), launches
    assert tuple(run.tokens.shape) == (b, steps)
    assert bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all())
    assert bool(torch.isfinite(run.logits.float()).all())
    assert bool(torch.isfinite(run.cache.k.float()).all())
    assert int(run.cache.pos) == s + steps
    step_ms = statistics.median(run.decode_s) * 1e3
    print(f"moe serve on {card}: grok-1-314b at full width, {cfg.n_layers} of "
          f"its 64 layers (d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.moe_experts} experts of d_ff {cfg.d_ff}, top-"
          f"{cfg.moe_top_k}), {cfg.param_count()} parameters in bf16; "
          f"prefill {b} x {s} tokens {run.prefill_s:.3f} s "
          f"({b * s / run.prefill_s:.0f} tokens/s); decode step "
          f"{step_ms:.3f} ms (median of {steps}; first "
          f"{run.decode_s[0] * 1e3:.3f} ms), {b * steps / sum(run.decode_s):.1f} "
          f"tokens/s; peak memory {run.peak_bytes / 1e9:.2f} GB; launches "
          f"{per_call} grouped matmuls and {cfg.n_layers} flash forwards (on "
          f"the tensor-core kernel) in the prefill, its grouped matmuls on "
          f"the wgmma route, {per_call} grouped matmuls in each of the "
          f"{steps} decode steps on the split-D route ({launches} in the "
          f"run)", flush=True)

    # every grouped-matmul call of a prefill of the same prompts and of one
    # decode step, and every flash forward of that prefill, against the
    # plain version on that call's own inputs
    errs, routes = {"prefill": [], "decode": [], "flash": []}, []
    real_route, kernel_fwd = L.route, attn_ops._forward

    def recording_route(xt, router, top_k):
        out = real_route(xt, router, top_k)
        routes.append(out[2])
        return out

    def checked(phase):
        def gmm(x, w):
            y = gkernel.grouped_matmul_cuda(x, w)
            errs[phase].append(close_scaled(y, gref.grouped_matmul(x, w),
                                            GMM_TOL["bfloat16"],
                                            GMM_TOL["bfloat16"]))
            return y
        return gmm

    def checked_fwd(q, k, v, causal, window):
        o, lse = kernel_fwd(q, k, v, causal, window)
        wo, wlse = fref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window)
        # lse against the plain version computed in float64, as the SSD
        # phase holds its kernel: these random weights give scores whose
        # large terms cancel, and there the float32 plain version's own lse
        # lies up to 0.92 of this bound from float64 (PERF.md), so holding
        # the kernel to it would ask for its rounding
        _, e64 = grouped(torch, lambda *a: fref.flash_attention_ref(
            *a, causal=causal, window=window), q.double(), k.double(),
            v.double(), n_out=2)
        el = close_scaled(lse, e64, TOL["float32"], TOL["float32"])
        worst = lambda x: ((x.double() - e64).abs() / (
            TOL["float32"] * el[1] + TOL["float32"] * e64.abs())).max().item()
        errs["flash"].append((
            close_scaled(o, wo, TOL["bfloat16"], TOL["bfloat16"]), el,
            tuple(q.shape), tuple(k.shape), worst(lse), worst(wlse),
            (lse - wlse).abs().max().item()))
        return o, lse

    sv, params = run.serve, run.params
    with mock.patch.object(L, "route", recording_route):
        with mock.patch.object(moe_ops, "grouped_matmul", checked("prefill")), \
                mock.patch.object(attn_ops, "_forward", checked_fwd):
            logits, _ = sv.prefill_fn(params, run.prompt)
        assert bool(torch.isfinite(logits.float()).all())
        cap = L.capacity(b * s, cfg.moe_top_k, cfg.moe_capacity_factor,
                         cfg.moe_experts)
        dropped = [drops(r, cfg.moe_experts, cap) for r in routes]
        routes.clear()
        run.cache.pos = run.cache.pos - 1      # rewrite the last position
        with mock.patch.object(moe_ops, "grouped_matmul", checked("decode")):
            logits, _ = sv.decode_fn(params, run.cache, run.tokens[:, -1:])
        assert bool(torch.isfinite(logits.float()).all())
    assert [len(errs[k]) for k in errs] == [per_call, per_call,
                                            cfg.n_layers], errs
    hd = cfg.resolved_head_dim
    assert all(qs == (b, s, cfg.n_heads, hd) and ks == (b, s, cfg.n_kv_heads, hd)
               for _, _, qs, ks, *_ in errs["flash"]), errs["flash"]
    span = lambda xs: (f"max abs err {max(e for e, _ in xs):.3e}, scales "
                       f"{min(sc for _, sc in xs):.3e} to "
                       f"{max(sc for _, sc in xs):.3e}")
    print(f"moe serve: every grouped-matmul call held to the plain version "
          f"on its own inputs (bound {GMM_TOL['bfloat16']} * scale + "
          f"{GMM_TOL['bfloat16']} * |plain|): prefill {per_call} calls, "
          f"{span(errs['prefill'])}; one decode step {per_call} calls, "
          f"{span(errs['decode'])}. Prefill routing: capacity {cap} slots an "
          f"expert, {sum(dropped)} of {cfg.n_layers * b * s * cfg.moe_top_k} "
          f"slots dropped (per layer {dropped})", flush=True)
    flash_o, flash_lse = ([e[i] for e in errs["flash"]] for i in (0, 1))
    print(f"moe serve: every flash forward of that prefill held to the "
          f"plain version on its own inputs: {cfg.n_layers} calls at q "
          f"{errs['flash'][0][2]}, k/v {errs['flash'][0][3]} bf16, o "
          f"{span(flash_o)} (bound {TOL['bfloat16']} * scale + "
          f"{TOL['bfloat16']} * |plain|); lse against the plain version in "
          f"float64, {span(flash_lse)} (bound {TOL['float32']} * scale + "
          f"{TOL['float32']} * |float64|), worst err/bound per call: kernel "
          f"{' '.join(f'{e[4]:.3f}' for e in errs['flash'])}, the float32 "
          f"plain version {' '.join(f'{e[5]:.3f}' for e in errs['flash'])}; "
          f"kernel against the float32 plain version, max abs err "
          f"{max(e[6] for e in errs['flash']):.3e}", flush=True)
    del errs
    moe_profile(torch, run, card)
    del run, sv, logits
    torch.cuda.empty_cache()
    return launches, cfg, params


def moe_profile(torch, run, card: str) -> None:
    """One batch-8 prefill and three decode steps (each rewriting the last
    position) under ``torch.profiler``: device busy share and the grouped
    matmul's share of device time, its kernels checked by name (the
    prefill's on ``gmm_wgmma_kernel``, a decode step's on
    ``gmm_splitd_kernel`` and its reduce pass)."""
    sv, params = run.serve, run.params

    def step():
        run.cache.pos = run.cache.pos - 1
        sv.decode_fn(params, run.cache, run.tokens[:, -1:])

    for name, fn, n in (
            ("prefill", lambda: sv.prefill_fn(params, run.prompt), 1),
            ("decode step", step, 3)):
        fn()
        wall_ms, busy_ms, launches, kernels = device_profile(torch, fn, n)
        gmm_ms = sum(dev_us(e) for e in kernels if "gmm_" in e.key) / 1e3 / n
        gmm_names = {kernel_name(e.key) for e in kernels if "gmm_" in e.key}
        assert gmm_names == ({"gmm_wgmma_kernel"} if name == "prefill" else
                             {"gmm_splitd_kernel",
                              "gmm_splitd_reduce_kernel"}), gmm_names
        top = "; ".join(f"{e.key[:44]} {dev_us(e) / 1e3 / n:.3f} ms x"
                        f"{e.count // n}" for e in kernels[:5])
        print(f"moe {name} profile on {card}: wall {wall_ms:.3f} ms (under "
              f"the profiler), device busy {busy_ms:.3f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} kernel "
              f"launches; grouped matmul ({', '.join(sorted(gmm_names))}) "
              f"{gmm_ms:.3f} ms "
              f"({100 * gmm_ms / busy_ms:.1f}% of device time); top device "
              f"time: {top}", flush=True)


def small_moe_reference_phase(torch, np) -> None:
    """The card's serve path against the CPU's plain path on a small input:
    the grok and llama4 smoke configs (top-2 of 4 experts; top-1 with a
    shared expert every second layer), the same bf16 params (attention at
    its true fan-in and the embedding x 10, as tests/test_torch_moe.py
    holds the port to JAX), a 24-token prompt and 12 teacher-forced decode
    steps. Routing equal on every MoE call, logits and caches at the bf16
    bound, greedy tokens wherever the margin is clear, and the card's
    prefill and decode went through the kernel."""
    from repro_torch import configs
    from repro_torch.kernels.moe import kernel as gkernel
    from repro_torch.models import layers as L
    from repro_torch.models import registry, transformer
    from repro_torch.serve.engine import build_serve
    from repro_torch.sharding.params import init_tree, tree_map

    s, steps, tol = 24, 12, 6e-2
    for arch in ("grok_1_314b", "llama4_maverick_400b"):
        cfg = configs.smoke(arch)
        params = transformer.true_fan_in(
            init_tree(registry.decls(cfg), SEED, "cpu", dtype=torch.bfloat16),
            cfg)
        params["embed"] = params["embed"] * 10.0
        rng = np.random.default_rng(SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, s + steps)))
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda t: t.to(dev), params)
            sv = build_serve(cfg, 2, s + steps, prefill_len=s, device=dev)
            routes, real_route = [], L.route

            def recording_route(xt, router, top_k):
                probs, gates, eidx = real_route(xt, router, top_k)
                routes.append((probs.cpu(), eidx.cpu()))
                return probs, gates, eidx

            g0 = gkernel.launches
            with mock.patch.object(L, "route", recording_route):
                logits, cache = sv.prefill_fn(p, toks[:, :s])
                seq = [logits.float().cpu()]
                for t in range(steps):
                    logits, cache = sv.decode_fn(p, cache,
                                                 toks[:, s + t:s + t + 1])
                    seq.append(logits.float().cpu())
            out[dev] = (torch.stack(seq), cache, routes, gkernel.launches - g0)
        (want, wcache, wroutes, _), (got, gcache, groutes, launched) = (
            out["cpu"], out["cuda"])
        n_moe = sum(transformer._is_moe_layer(cfg, j)
                    for j in range(cfg.n_layers))
        assert launched == 3 * n_moe * (1 + steps), launched
        assert len(groutes) == len(wroutes) == n_moe * (1 + steps)
        k = cfg.moe_top_k
        margin = min((pr.sort(-1, descending=True).values[:, k - 1]
                      - pr.sort(-1, descending=True).values[:, k]).min().item()
                     for pr, _ in wroutes)
        same = all(torch.equal(g, w) for (_, g), (_, w) in zip(groutes, wroutes))
        assert same, "routing differs between the card and the CPU"
        err = close(got, want, tol)
        close(gcache.k.cpu(), wcache.k, tol)
        close(gcache.v.cpu(), wcache.v, tol)
        top2 = want.topk(2, dim=-1).values
        clear = top2[..., 0] - top2[..., 1] > 2 * tol * (1 + top2[..., 0].abs())
        agree = got.argmax(-1)[clear] == want.argmax(-1)[clear]
        assert bool(agree.all()) and int(clear.sum()) > 0, int(clear.sum())
        print(f"smoke {cfg.name} on the card (kernel: {launched} grouped "
              f"matmuls) vs the CPU's plain path: prefill of {s} tokens and "
              f"{steps} decode steps, routing equal on all {len(groutes)} MoE "
              f"calls (smallest top-{k} router margin {margin:.3e}), logits "
              f"max abs err {err:.3e} (tolerance {tol} + {tol} * |plain|), "
              f"KV caches within it; greedy tokens equal at all "
              f"{int(clear.sum())} of {clear.numel()} steps with a clear "
              f"margin", flush=True)


# ---------------------------------------------------------------------------
# The engine's lane backend
# ---------------------------------------------------------------------------

# the lane engine's trace at full width: 16 requests sharing a 32-token
# system prompt, 16 tokens of their own each, 16 greedy tokens each
LANE_SERVE = {"slots": 8, "page_size": 16, "prefill_chunk": 16,
              "system": 32, "own": 16, "new": 16, "requests": 16}


def lane_trace(np, vocab: int) -> list:
    """``(id, prompt, max_new_tokens)`` of the lane engine's trace."""
    rng = np.random.default_rng(SEED)
    s = LANE_SERVE
    system = [int(t) for t in rng.integers(1, vocab, s["system"])]
    return [(f"l{i}", system + [int(t) for t in rng.integers(1, vocab, s["own"])],
             s["new"]) for i in range(s["requests"])]


def lane_serve(torch, np, cfg, params, step_hook=None, mixed=False, **kw):
    """Serve :func:`lane_trace` through ``ContinuousBatchingEngine`` on its
    default backend (lanes for MoE, SSM and hybrid configs), metered unless
    ``metered=False``, greedy or with every second request sampled
    (``mixed``, :func:`mixed_sampling`); ``step_hook(engine)`` may run a
    step itself (and return True) instead of the loop. Returns the engine,
    the host ms of each decode-only step (every lane one token; a sync
    ``step()`` ends with the tokens on the host), the engine steps and the
    wall seconds."""
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    s = LANE_SERVE
    engine = ContinuousBatchingEngine(
        cfg, params, slots=s["slots"], device="cuda",
        max_len=s["system"] + s["own"] + s["new"], page_size=s["page_size"],
        prefill_chunk=s["prefill_chunk"], **kw)
    for i, (rid, prompt, n_new) in enumerate(lane_trace(np, cfg.vocab)):
        assert engine.submit(Request(
            rid, prompt, n_new, sampling=mixed_sampling(i) if mixed else None))
    decode_ms, steps = [], 0
    t0 = time.perf_counter()
    while True:
        before = engine.token_steps
        ts = time.perf_counter()
        if step_hook is not None and step_hook(engine):
            steps += 1
            continue
        if not engine.step():
            break
        dt = time.perf_counter() - ts
        steps += 1
        if engine.token_steps - before == 1:
            decode_ms.append(dt * 1e3)
    return engine, decode_ms, steps, time.perf_counter() - t0


def lane_checks(engine, cfg) -> dict:
    """The lane engine's run against its contract: every request complete
    with its tokens in the vocabulary, the shared prefix reused and copied
    into lanes (``note_cow``), the lane backend, one admit and one
    complete interrupt a request, and a conserving meter. Returns
    ``stats()``."""
    s = LANE_SERVE
    stats = engine.stats()
    done = engine.completed
    assert len(done) == s["requests"], f"{len(done)} requests completed"
    for r in done:
        assert len(r.tokens) == r.max_new_tokens, (r.id, len(r.tokens))
        assert all(0 <= t < cfg.vocab for t in r.tokens), r.id
    assert stats["backend"] == "lanes", stats["backend"]
    assert stats["prompt_tokens_reused"] > 0, stats
    assert stats["pages"]["cow_copies"] > 0, stats["pages"]
    irq = engine.platform.interrupts
    assert (irq.count("serve.admit"), irq.count("serve.complete")) == (
        s["requests"], s["requests"])
    meter_conserves(engine)
    return stats


def lane_snapshot_bytes(torch, cfg) -> int:
    """Bytes of one lane snapshot (a batch-1 cache at the engine's
    length): what each published prefix page holds on the card."""
    from repro_torch.models import registry

    s = LANE_SERVE
    one = registry.cache_init(cfg, 1, s["system"] + s["own"] + s["new"],
                              device="cuda")
    return registry.cache_bytes(one)


def grok_lane_phase(torch, np, gkernel, gref, cfg, params, card: str) -> dict:
    """Full-width grok-1 (the moe serve phase's 4 of 64 layers and their
    weights) served by ``ContinuousBatchingEngine`` on its lane backend: 8
    slots, 16-token pages, prefill chunk 16, metered, :func:`lane_trace`.
    Checks the run (:func:`lane_checks`), 12 grouped-matmul launches a
    one-token step (4 layers x gate, up, down: the lanes of a step packed
    into one call a weight), every one on the split-D route by the C
    entry's report; serves the trace again unmetered (equal completions)
    with every MoE routing recorded (no lane drops a slot; printed: the
    slots that routing the 8 lanes together would drop) and one
    decode-only step profiled; then teacher-forces one request in lane 0
    of an 8-lane cache and holds every grouped-matmul call to the plain
    version on its own inputs; times the kernel at the packed shapes.
    Returns the run's launch count, the time at the packed gate/up shape
    and the count of its route."""
    from repro_torch.kernels.moe import ops as moe_ops
    from repro_torch.models import layers as L
    from repro_torch.models import registry

    s = LANE_SERVE
    per_step = 3 * cfg.n_layers
    print(f"lane engine: grok-1-314b at {cfg.n_layers} layers, "
          f"ContinuousBatchingEngine(slots {s['slots']}, page_size "
          f"{s['page_size']}, prefill_chunk {s['prefill_chunk']}), "
          f"{s['requests']} requests of a {s['system']}-token shared prompt "
          f"+ {s['own']} own, {s['new']} greedy tokens each", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gkernel.launches = gkernel.launches_wgmma = gkernel.launches_splitd = 0
    engine, decode_ms, steps, wall = lane_serve(torch, np, cfg, params)
    launches, splitd = gkernel.launches, gkernel.launches_splitd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = lane_checks(engine, cfg)
    assert launches == per_step * stats["token_steps"], (launches, stats)
    assert splitd == launches and gkernel.launches_wgmma == 0, splitd
    snap = lane_snapshot_bytes(torch, cfg)
    print(f"lane engine on {card}: grok-1-314b, {steps} engine steps, "
          f"{stats['token_steps']} one-token steps, "
          f"{stats['tokens_generated']} tokens, "
          f"{stats['prompt_tokens_reused']} prompt tokens reused, "
          f"{stats['pages']['cow_copies']} snapshot pages copied into lanes; "
          f"decode step {statistics.median(decode_ms):.3f} ms (median of "
          f"{len(decode_ms)} decode-only steps), "
          f"{stats['tokens_generated'] / wall:.1f} tokens/s over {wall:.3f} "
          f"s; peak memory {peak_gb:.2f} GB; {stats['pages']['resident']} "
          f"snapshots resident in the table, {snap} bytes each; grouped-"
          f"matmul launches {launches} = {per_step} x "
          f"{stats['token_steps']} one-token steps, all {splitd} on the "
          f"split-D route", flush=True)

    # unmetered, with the routing recorded and one decode-only step profiled
    routes, real_route = [], L.route
    prof = {}

    def recording_route(xt, router, top_k):
        out = real_route(xt, router, top_k)
        routes.append(out[2])
        return out

    def profile_once(eng):
        if prof or eng.queue or any(sl is None or sl.prefilling
                                    for sl in eng.slots):
            return False
        prof["out"] = device_profile(torch, eng.step, 1)
        return True

    with mock.patch.object(L, "route", recording_route):
        plain, _, _, _ = lane_serve(torch, np, cfg, params,
                                    step_hook=profile_once, metered=False)
    want = {r.id: r.tokens for r in engine.completed}
    assert {r.id: r.tokens for r in plain.completed} == want
    assert "energy" not in plain.stats()
    # a lane routes alone at capacity 1: a slot drops where a lane picks
    # one expert twice
    lane_drops = sum(int((torch.nn.functional.one_hot(r, cfg.moe_experts)
                          .sum(1) - 1).clamp_min(0).sum()) for r in routes)
    assert lane_drops == 0 and len(routes) == cfg.n_layers * plain.token_steps
    wall_ms, busy_ms, n_launch, kernels = prof["out"]
    gmm_ms = sum(dev_us(e) for e in kernels if "gmm_" in e.key) / 1e3
    top = "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
                    for e in kernels[:4])
    print(f"lane engine: the unmetered engine's {len(want)} completions equal "
          f"the metered ones; {len(routes)} MoE routings of "
          f"{s['slots']} lanes, {lane_drops} slots dropped (a lane routes "
          f"alone at capacity 1). Profiled decode step on {card}: wall "
          f"{wall_ms:.3f} "
          f"ms (under the profiler), device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {n_launch:.0f} kernel "
          f"launches, grouped matmul {gmm_ms:.3f} ms; top device time: "
          f"{top}", flush=True)
    del plain

    # the mixed trace (every second request sampled), sync and async: the
    # same bits, 12 split-D grouped matmuls a one-token step
    mixed = {}
    for mode in ("sync", "async"):
        torch.cuda.synchronize()
        gkernel.launches = gkernel.launches_splitd = 0
        eng, ms, _, wall = lane_serve(torch, np, cfg, params, mixed=True,
                                      async_dispatch=mode == "async")
        st = lane_checks(eng, cfg)
        assert gkernel.launches == per_step * st["token_steps"], st
        assert gkernel.launches_splitd == gkernel.launches
        assert st["sampled_requests"] == s["requests"] // 2, st
        mixed[mode] = ({r.id: r.tokens for r in eng.completed},
                       gkernel.launches, statistics.median(ms), wall, st)
    assert mixed["async"][0] == mixed["sync"][0], "grok lanes: async != sync"
    greedy_ids = [rid for i, (rid, _, _) in enumerate(lane_trace(np, cfg.vocab))
                  if i % 2]
    assert all(mixed["sync"][0][rid] == want[rid] for rid in greedy_ids)
    print(f"lane engine on {card}: grok-1-314b, the mixed trace "
          f"({s['requests'] // 2} requests sampled): async tokens equal "
          f"sync's bit for bit, the greedy requests equal the greedy run's; "
          f"decode step sync {mixed['sync'][2]:.3f} ms, async "
          f"{mixed['async'][2]:.3f} ms (medians), "
          f"{mixed['sync'][4]['tokens_generated'] / mixed['sync'][3]:.1f} / "
          f"{mixed['async'][4]['tokens_generated'] / mixed['async'][3]:.1f} "
          f"tokens/s; grouped-matmul launches {mixed['sync'][1]} / "
          f"{mixed['async'][1]} = {per_step} x one-token steps, all split D",
          flush=True)

    # teacher-force the last request (it adopted the shared prefix) in lane
    # 0 of an 8-lane cache, the other lanes riding with the pad token as in
    # the engine; every grouped-matmul call against the plain version
    req = engine.completed[-1]
    seq = list(req.prompt) + req.tokens
    errs = []

    def checked(x, w):
        y = gkernel.grouped_matmul_cuda(x, w)
        errs.append(close_scaled(y, gref.grouped_matmul(x, w),
                                 GMM_TOL["bfloat16"], GMM_TOL["bfloat16"]))
        assert tuple(x.shape[:2]) == (cfg.moe_experts, s["slots"]), x.shape
        return y

    cache = registry.cache_init(cfg, s["slots"], len(seq), device="cuda",
                                lanes=True)
    toks = torch.zeros((s["slots"], 1), dtype=torch.long, device="cuda")
    forced = []
    with torch.inference_mode(), \
            mock.patch.object(moe_ops, "grouped_matmul", checked):
        for tok in seq[:-1]:
            toks[0, 0] = tok
            logits, _ = registry.decode_step(params, cfg, cache, toks)
            forced.append(logits[0].float())
    forced = torch.stack(forced)[len(req.prompt) - 1:]
    assert len(errs) == per_step * (len(seq) - 1), len(errs)
    assert bool(torch.isfinite(forced).all())
    top2 = forced.topk(2, dim=-1).values
    agree = (forced.argmax(-1).cpu() == torch.tensor(req.tokens))
    print(f"lane engine: teacher-forced {req.id} in lane 0 of {s['slots']} "
          f"({len(seq) - 1} one-token steps, {len(errs)} grouped-matmul "
          f"calls of x ({cfg.moe_experts}, {s['slots']}, ·)): every call "
          f"held to the plain version on its own inputs (bound "
          f"{GMM_TOL['bfloat16']} * scale + {GMM_TOL['bfloat16']} * |plain|), "
          f"max abs err {max(e for e, _ in errs):.3e}; greedy tokens equal "
          f"the engine's at {int(agree.sum())} of {len(req.tokens)} steps "
          f"(smallest top-2 margin {float((top2[:, 0] - top2[:, 1]).min()):.3e})",
          flush=True)
    del errs, cache, engine

    # the kernel at the packed shapes: (E, lanes, D) x (E, D, F)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    entry = {}
    for label, d, f in (("gate/up", cfg.d_model, cfg.d_ff),
                        ("down", cfg.d_ff, cfg.d_model)):
        e, c = cfg.moe_experts, s["slots"]
        x, w = gmm_inputs(torch, gen, e, c, d, f, torch.bfloat16)
        ms = time_ms(torch, lambda i: gkernel.grouped_matmul_cuda(x, w), 1,
                     inner=10, reps=11)
        bound, by, moved = gmm_bound_ms(e, c, d, f, 2, BF16_OPS_PER_S)
        print(f"lane engine: gmm at the packed {label} shape x ({e}, {c}, "
              f"{d}) w ({e}, {d}, {f}) bf16, route "
              f"{gkernel.plan(e, c, d, f, torch.bfloat16).route}: "
              f"{ms:.4f} ms a call, bound {bound:.4f} ms ({by})", flush=True)
        entry.setdefault("ms", ms)
        del x, w
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": entry["ms"],
            "mixed sync": mixed["sync"][1], "mixed async": mixed["async"][1]}


def recurrent_lane_phase(torch, np, card: str) -> None:
    """Full-width, full-depth mamba2-370m and recurrentgemma-2b (random
    bf16 weights from the seed) served by ``ContinuousBatchingEngine`` on
    lanes, :func:`lane_trace`: the run's contract (:func:`lane_checks`),
    decode-step time, peak memory and the bytes of one lane snapshot."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree

    for arch in ("mamba2_370m", "recurrentgemma_2b"):
        cfg = configs.get(arch)
        params = init_tree(registry.decls(cfg), SEED, "cuda",
                           dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine, decode_ms, steps, wall = lane_serve(torch, np, cfg, params)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        stats = lane_checks(engine, cfg)
        snap = lane_snapshot_bytes(torch, cfg)
        print(f"lane engine on {card}: {cfg.name}, {cfg.n_layers} layers, "
              f"{steps} engine steps, {stats['token_steps']} one-token "
              f"steps, {stats['tokens_generated']} tokens, "
              f"{stats['prompt_tokens_reused']} prompt tokens reused, "
              f"{stats['pages']['cow_copies']} snapshot pages copied into "
              f"lanes; decode step {statistics.median(decode_ms):.3f} ms "
              f"(median of {len(decode_ms)}), "
              f"{stats['tokens_generated'] / wall:.1f} tokens/s over "
              f"{wall:.3f} s; peak memory {peak_gb:.2f} GB; "
              f"{stats['pages']['resident']} snapshots resident, {snap} "
              f"bytes each; meter conserves", flush=True)
        del engine, params
        torch.cuda.empty_cache()


def small_lane_reference_phase(torch, np) -> None:
    """The lane engine on the card against the CPU's plain path on small
    inputs: the granite, grok, mamba2 and recurrentgemma smoke configs
    (bf16 params, the attention at its true fan-in and the embedding x 10),
    3 slots, 4-token pages, prefill chunk 4, six requests sharing a 9-token
    prefix. Each request's completion is teacher-forced on both devices;
    the card's completion equals the CPU's up to the first step whose
    top-2 margin is not above twice the step's largest logit difference
    plus a bf16 ulp. Granite's completions on lanes equal those on the
    paged backend on the card."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import griffin, registry, transformer
    from repro_torch.serve import sampling
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import init_tree, tree_map

    rng = np.random.default_rng(SEED)
    prefix = [int(t) for t in rng.integers(1, 256, 9)]
    reqs = [(f"r{i}", prefix + [int(t) for t in rng.integers(1, 256, 1 + i % 4)],
             4 + i % 3) for i in range(6)]

    def serve(cfg, params, dev, mixed=False, **kw):
        eng = ContinuousBatchingEngine(cfg, params, slots=3, max_len=32,
                                       page_size=4, prefill_chunk=4,
                                       device=dev, **kw)
        for i, r in enumerate(reqs):
            assert eng.submit(Request(
                *r, sampling=mixed_sampling(i) if mixed else None))
        eng.run_until_idle()
        return eng, {r.id: r.tokens for r in eng.completed}

    def clear_prefix(cfg, params, card_params, prompt, tokens, sp):
        """How many emitted steps, from the first, have a margin clear of
        the card's and the CPU's logit difference: greedy, the top-2 gap
        of the logits; sampled, that of the scores (filtered scaled logits
        plus the step's Gumbel noise), both devices' filters keeping the
        same tokens."""
        seq = list(prompt) + list(tokens)
        w = forced(cfg, params, seq, "cpu")[len(prompt) - 1:]
        g = forced(cfg, card_params, seq, "cuda")[len(prompt) - 1:]
        key = sampling.seed_key(sp.seed if sp else 0)[None]
        for t in range(len(tokens)):
            key, use = sampling.split_keys(key)
            zw, zg = w[t], g[t]
            if sp is not None:
                zw, zg = (sampling.scores(x[None], use, sp.temperature,
                                          sp.top_k, sp.top_p)[0]
                          for x in (zw, zg))
                if not torch.equal(zw.isfinite(), zg.isfinite()):
                    return t
            live = zw.isfinite()
            top2 = zw[live].topk(2).values
            gap = (zg - zw)[live].abs().max()
            ulp = 2.0 ** (torch.floor(torch.log2(top2[0].abs())) - 7)
            if not top2[0] - top2[1] > 2 * gap + ulp:
                return t
        return len(tokens)

    def forced(cfg, params, seq, dev):
        cache = registry.cache_init(cfg, 1, 32, device=dev, lanes=True)
        out = []
        with torch.inference_mode():
            for tok in seq[:-1]:
                logits, _ = registry.decode_step(
                    params, cfg, cache, torch.tensor([[tok]], device=dev))
                out.append(logits[0].float().cpu())
        return torch.stack(out)

    for arch in ("granite_3_2b", "grok_1_314b", "mamba2_370m",
                 "recurrentgemma_2b"):
        cfg = configs.smoke(arch)
        if arch == "granite_3_2b":
            # small_reference_phase's model, whose margins it checks clear
            cfg = dataclasses.replace(cfg, dtype="float32")
            params = init_tree(registry.decls(cfg), SEED, "cpu")
        else:
            params = init_tree(registry.decls(cfg), SEED, "cpu",
                               dtype=torch.bfloat16)
        if cfg.family == "hybrid":
            params = griffin.true_fan_in(params, cfg)
        elif cfg.family == "moe":
            params = transformer.true_fan_in(params, cfg)
        params["embed"] = params["embed"] * 10.0
        card_params = tree_map(lambda t: t.to("cuda"), params)
        eng, got = serve(cfg, card_params, "cuda", paged=False)
        assert eng.stats()["backend"] == "lanes"
        _, want = serve(cfg, params, "cpu", paged=False)
        clear_steps = emitted = 0
        for rid, prompt, n_new in reqs:
            seq = list(prompt) + want[rid]
            w = forced(cfg, params, seq, "cpu")[len(prompt) - 1:]
            g = forced(cfg, card_params, seq, "cuda")[len(prompt) - 1:]
            top2 = w.topk(2, dim=-1).values
            gap = (g - w).abs().amax(-1)
            ulp = 2.0 ** (torch.floor(torch.log2(top2[:, 0].abs())) - 7)
            clear = top2[:, 0] - top2[:, 1] > 2 * gap + ulp
            k = n_new if bool(clear.all()) else int(clear.int().argmin())
            assert got[rid][:k] == want[rid][:k], (arch, rid, k)
            clear_steps, emitted = clear_steps + k, emitted + n_new
        note = ""
        if arch == "granite_3_2b":
            paged, on_pages = serve(cfg, card_params, "cuda", paged=True)
            assert paged.stats()["backend"] == "paged"
            assert on_pages == got, "granite: lanes != paged on the card"
            note = "; equal to the paged backend's on the card"
            # the mixed trace: paged and lanes on the card bit for bit,
            # and the CPU's plain path where the margins are clear
            eng, paged_mixed = serve(cfg, card_params, "cuda", mixed=True,
                                     paged=True)
            _, lanes_mixed = serve(cfg, card_params, "cuda", mixed=True,
                                   paged=False)
            _, cpu_mixed = serve(cfg, params, "cpu", mixed=True)
            assert eng.stats()["stalls"] > 0 and eng.stats()["rematches"] > 0
            assert paged_mixed == lanes_mixed, "granite mixed: lanes != paged"
            mixed_clear = 0
            for i, (rid, prompt, n_new) in enumerate(reqs):
                k = clear_prefix(cfg, params, card_params, prompt,
                                 cpu_mixed[rid], mixed_sampling(i))
                assert paged_mixed[rid][:k] == cpu_mixed[rid][:k], (rid, k)
                mixed_clear += k
            assert mixed_clear >= emitted // 2, (mixed_clear, emitted)
            note += (f"; the mixed trace (3 of 6 sampled) equal on paged and "
                     f"lanes on the card, and to the CPU's plain path up to "
                     f"each request's first unclear margin ({mixed_clear} "
                     f"of {emitted} steps)")
        print(f"small lane reference, smoke {cfg.name}: the card's lane "
              f"engine vs the CPU's plain path, completions equal up to "
              f"each request's first unclear margin ({clear_steps} of "
              f"{emitted} emitted steps){note}", flush=True)


# h2o-danube3-4b's window and cluster phases. The engine's schedule (engine
# steps, one-token steps, stalls, re-matches, recycles, sheds, preemptions)
# depends on lengths, the clock and the fault plan's draws, never on token
# values, the model's width or the device, so each phase first serves its
# trace on the smoke config of the same family (its "twin", on the card:
# the window's 4271 one-token steps take the CPU's plain version about 90
# s) and holds the full-width run to those counts; ``tools/engine_dry_run.py``
# prints the same counts from the CPU.
DANUBE_LAYERS = 4          # of h2o-danube3-4b's 24 (see window_phase)
WINDOW_SERVE = {"slots": 4, "page_size": 16, "prefill_chunk": 16,
                "max_len": 4352, "page_capacity": 320}
WINDOW_TRACE = {"n": 4, "shared": 4160, "own": 16, "new": 96}
WINDOW_KEYS = ("steps", "token_steps", "stalls", "rematches",
               "rematched_tokens", "prompt_tokens_reused", "pages_recycled",
               "window", "table_entries_per_slot")
# the cluster phase: granite-3-2b as two same-namespace tenants (8 and 4
# slots, both 8 lanes wide so that a page one computes is the bits the
# other would compute) and h2o-danube3-4b at full depth (window 4096,
# clamped to its 512 positions, so nothing recycles)
CLUSTER = {"pool_pages": 640, "page_size": 16, "max_awake_banks": 5}
CLUSTER_ENGINES = (("granite-a", "granite_3_2b", {"slots": 8, "max_len": 256}),
                   ("granite-b", "granite_3_2b",
                    {"slots": 4, "lane_batch": 8, "max_len": 256}),
                   ("danube", "h2o_danube3_4b", {"slots": 8, "max_len": 512}))
CLUSTER_TRACE = {"n_requests": 96, "rate": 1.0, "seed": 0,
                 "process": "bursty", "burst": 8}
# deficit round-robin banks quantum x weight token credits a round; a head
# costs prompt + new tokens, at most 96 here, within every tenant's first
# round (a lone head dearer than that would stall a round with nothing
# else to run, which the cluster reports as a budget deadlock)
CLUSTER_POLICY = {"scheduler": "drr", "quantum": 32, "shed_busted": True,
                  "preempt_busted": True}
CLUSTER_CHAOS = {"seed": 1, "step_fail": 0.02, "alloc_fail": 0.01,
                 "token_corrupt": 0.02, "crash_at": 40}
CLUSTER_KEYS = ("steps", "power_stalls", "wrr_stalls", "sheds",
                "slo_preempts", "reclaims")
CLUSTER_ENGINE_KEYS = ("steps", "token_steps", "stalls", "admission_stalls",
                       "rematches", "prompt_tokens_reused", "shed",
                       "completed", "sampled_requests", "replays",
                       "pages_recycled")


def window_trace(np, vocab: int) -> list:
    """4 requests of one 4160-token prompt and 16 tokens of their own, 96
    greedy tokens each: 4272 positions, past the 4096-token window."""
    rng = np.random.default_rng(SEED)
    shared = [int(t) for t in rng.integers(1, vocab, WINDOW_TRACE["shared"])]
    return [(f"win{i}", shared + [int(t) for t in rng.integers(
        1, vocab, WINDOW_TRACE["own"])], WINDOW_TRACE["new"])
        for i in range(WINDOW_TRACE["n"])]


def window_serve(cfg, params, device, reqs, before=None):
    """Serve ``reqs`` (all submitted at once, prompts taken modulo the
    vocabulary) on a windowed engine with ``WINDOW_SERVE``; ``before(engine)``
    runs before every step. Returns the engine."""
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    eng = ContinuousBatchingEngine(cfg, params, device=device, **WINDOW_SERVE)
    for rid, prompt, n_new in reqs:
        assert eng.submit(Request(rid, [t % cfg.vocab for t in prompt], n_new))
    while True:
        if before is not None:
            before(eng)
        if not eng.step():
            return eng


def window_counts(eng) -> dict:
    st = eng.stats()
    return ({k: st[k] for k in WINDOW_KEYS}
            | {"pool_high_water": st["pool"]["high_water"]})


def smoke_twin(arch: str, device):
    """The smoke config of ``arch`` with the full config's window, and its
    params from ``SEED`` on ``device``: the schedule's twin of ``arch``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree

    smoke = dataclasses.replace(
        configs.smoke(arch), sliding_window=configs.get(arch).sliding_window)
    return smoke, init_tree(registry.decls(smoke), SEED, device)


def cluster_trace(load, metrics, SamplingParams):
    """``CLUSTER_TRACE``'s bursty open-loop arrivals over the three tenants
    (granite with a 64-token shared prefix, danube with a 32-token one),
    every second danube request sampled (temperature 0.8, top_k 50, top_p
    0.9, seed 100 + its danube index)."""
    slo_g = metrics.SLO(ttft=24.0, tpot=2.0)
    slo_d = metrics.SLO(ttft=32.0, tpot=2.5)
    tenants = [load.TenantSpec("granite-a", share=2.0, prompt_len=(66, 84),
                               new_tokens=(4, 12), prefix_len=64,
                               prefix_seed=1, slo=slo_g),
               load.TenantSpec("granite-b", share=1.0, prompt_len=(66, 84),
                               new_tokens=(4, 12), prefix_len=64,
                               prefix_seed=1, slo=slo_g),
               load.TenantSpec("danube", share=2.0, prompt_len=(34, 56),
                               new_tokens=(4, 16), prefix_len=32,
                               prefix_seed=2, slo=slo_d)]
    k = 0
    for arr in load.open_loop_trace(tenants, **CLUSTER_TRACE):
        if arr.engine == "danube":
            if k % 2:
                arr.request.sampling = SamplingParams(**{
                    **{x: MIXED[x] for x in ("temperature", "top_k",
                                             "top_p")}, "seed": 100 + k})
            k += 1
        yield arr


def cluster_serve(tenants: dict, device, *, faults: bool = False,
                  on_step=None):
    """Serve :func:`cluster_trace` on a ``ServeCluster`` (``CLUSTER``: one
    pool and table, 16-token pages, a power budget of 5 awake banks, the
    SLO-aware policy ``CLUSTER_POLICY``: deficit round-robin, TTFT shed,
    deadline preempt) with ``CLUSTER_ENGINES``, ``tenants`` mapping an arch
    to its (cfg, params), under ``ClusterSimulator`` on a fake clock.
    ``faults``: a ``FaultPlan`` from ``CLUSTER_CHAOS`` (step, alloc and
    token faults) and the danube engine crashed and rebuilt before cluster
    step ``crash_at``. ``on_step(cluster, n, step)`` wraps every cluster
    step ``n`` (it calls ``step()`` and returns its result). Returns the
    cluster, the report and the metrics' summary."""
    from repro_torch.serve import chaos, loadgen, metrics, sim
    from repro_torch.serve.cluster import PowerBudget, SchedPolicy, ServeCluster
    from repro_torch.serve.sampling import SamplingParams

    clock = sim.FakeClock()
    plan = None
    if faults:
        c = CLUSTER_CHAOS
        plan = chaos.FaultPlan(c["seed"], chaos.FaultSpec(
            step_fail=c["step_fail"], alloc_fail=c["alloc_fail"],
            token_corrupt=c["token_corrupt"]))
    cl = ServeCluster(
        pool_pages=CLUSTER["pool_pages"], page_size=CLUSTER["page_size"],
        clock=clock, device=device, chaos=plan,
        power_budget=PowerBudget(max_awake_banks=CLUSTER["max_awake_banks"]),
        policy=SchedPolicy(**CLUSTER_POLICY))
    for name, arch, kw in CLUSTER_ENGINES:
        cfg, params = tenants[arch]
        cl.add_engine(cfg, params, name=name, namespace=arch, **kw)
    real_step, n = cl.step, itertools.count(1)

    def step():
        i = next(n)
        if faults and i == CLUSTER_CHAOS["crash_at"]:
            cl.crash_engine("danube")
        return on_step(cl, i, real_step) if on_step else real_step()

    cl.step = step
    rep = sim.ClusterSimulator(cl, cluster_trace(loadgen, metrics,
                                                 SamplingParams), clock).run()
    m = metrics.ServeMetrics()
    for eng in cl.engines.values():
        m.observe_all(eng.completed)
    return cl, rep, m.summary(elapsed=rep.elapsed)


def cluster_counts(cl, rep, summary) -> dict:
    st = cl.stats()
    out = {k: st[k] for k in CLUSTER_KEYS}
    out["faults"] = {k: st["faults"][k] for k in (
        "step_faults", "alloc_faults", "token_faults", "replays",
        "crashes", "rebuilds")}
    out["engines"] = {n: {k: e[k] for k in CLUSTER_ENGINE_KEYS}
                      for n, e in st["engines"].items()}
    out["report"] = {"elapsed": rep.elapsed, "steps": rep.steps,
                     "tokens_generated": rep.tokens_generated,
                     "rejected": rep.rejected, "shed": rep.shed}
    out["metrics"] = {k: summary[k] for k in (
        "completed", "slo_attainment", "ttft_p50", "ttft_p99", "tpot_p50",
        "tpot_p99", "goodput")}
    out["pool_high_water"] = st["pool"]["high_water"]
    return out


def poison_free_pages(torch, eng) -> int:
    """Fill every page on ``eng``'s pool free list with NaN in every layer
    of its arena's K and V; returns how many."""
    free = eng._pool._free
    if free:
        idx = torch.tensor(free, dtype=torch.long, device=eng._arena.k.device)
        eng._arena.k[:, idx] = float("nan")
        eng._arena.v[:, idx] = float("nan")
    return len(free)


def checked_paged(torch, kernel, ref, errs: list):
    """A stand-in for the paged attention op (:func:`set_cuda`) that
    launches the kernel and holds each call to the plain version on its own
    inputs
    (``close_scaled`` at the bf16 bound), recording (head dim, window,
    error)."""
    def checked(q, k_pool, v_pool, tables, lengths, *, window=None):
        got = kernel.paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                          window=window)
        want = ref.paged_attention(q, k_pool, v_pool, tables, lengths,
                                   window=window)
        err, _ = close_scaled(got, want, TOL["bfloat16"], TOL["bfloat16"])
        assert bool(torch.isfinite(got).all())
        errs.append((q.shape[-1], window, err))
        return got
    return checked


def window_phase(torch, np, kernel, ref, card: str) -> int:
    """h2o-danube3-4b at full width (d_model 3840, 32/8 heads of dim 120,
    d_ff 10240, vocab 32000, window 4096), 4 of its 24 layers, random bf16
    weights from ``SEED``, on the paged backend with ring block tables
    (``WINDOW_SERVE``: 4 slots, 16-token pages, max_len 4352, so the window
    stays 4096 and a slot's ring holds 257 entries), serving
    :func:`window_trace`. Why 4 layers: recycling needs more than 4096
    positions and the paged prefill runs one-token steps, so the run takes
    about 4300 of them, which at 24 layers would cost about 90 s of host
    time. Checks: the schedule's counts equal the smoke twin's on the CPU
    (recycles, stalls, re-matches, table entries, the pool's high water),
    the high water within slots x 257 + the table's capacity, launches ==
    layers x one-token steps; then serves the trace again with every free
    page NaN before every step: the same tokens bit for bit, every live
    lane's logits finite, and every paged call of one prefill step and one
    decode step past the window held to the plain version. Returns the
    main run's launches."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.sharding.params import count_params, init_tree

    cfg = dataclasses.replace(configs.get("h2o_danube3_4b"),
                              n_layers=DANUBE_LAYERS)
    reqs = window_trace(np, cfg.vocab)
    t0 = time.perf_counter()
    want = window_counts(window_serve(*smoke_twin("h2o_danube3_4b", "cuda"),
                                      "cuda", reqs))
    smoke_s = time.perf_counter() - t0
    params = init_tree(registry.decls(cfg), SEED, "cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    ring = -(-cfg.sliding_window // WINDOW_SERVE["page_size"]) + 1
    print(f"window: h2o-danube3-4b at full width, {cfg.n_layers} of 24 "
          f"layers, {count_params(params)} parameters in bf16; the smoke "
          f"twin's schedule in {smoke_s:.1f} s: {want}", flush=True)

    def serve(before=None):
        """One run; returns the engine and (decode step?, seconds) a step."""
        times, last = [], {}

        def hook(eng):
            if before is not None:
                before(eng)
            now = time.perf_counter()
            if last:
                times.append((last["decode"], now - last["t"]))
            last.update(t=now, decode=not eng.queue and all(
                s is None or not s.prefilling for s in eng.slots))
        return window_serve(cfg, params, "cuda", reqs, hook), times

    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    eng, times = serve()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    got = window_counts(eng)
    st = eng.stats()
    assert got == want, (got, want)
    assert st["window"] == cfg.sliding_window and \
        st["table_entries_per_slot"] == ring, st
    cap = WINDOW_SERVE["slots"] * ring + WINDOW_SERVE["page_capacity"]
    assert got["pool_high_water"] <= cap, (got["pool_high_water"], cap)
    assert launches == cfg.n_layers * st["token_steps"], launches
    assert got["pages_recycled"] > 0 and len(eng.completed) == 4
    tokens = {r.id: r.tokens for r in eng.completed}
    for toks in tokens.values():
        assert len(toks) == WINDOW_TRACE["new"]
        assert all(0 <= t < cfg.vocab for t in toks)
    decode = [dt * 1e3 for is_decode, dt in times if is_decode]
    print(f"window on {card}: {st['steps']} engine steps, "
          f"{st['token_steps']} one-token steps, {st['stalls']} stalls, "
          f"{st['rematches']} re-matches, {st['prompt_tokens_reused']} "
          f"prompt tokens reused, {st['pages_recycled']} pages recycled, "
          f"{ring} table entries a slot, pool high water "
          f"{got['pool_high_water']} of {eng._pool.n_pages} pages (bound "
          f"{cap}); equal to the smoke twin's; kernel launches {launches} "
          f"= {cfg.n_layers} layers x {st['token_steps']} one-token steps; "
          f"{wall:.1f} s, decode step {statistics.median(decode):.3f} ms "
          f"(median of {len(decode)})", flush=True)

    # again, every free page NaN before every step; one prefill chunk step
    # and one decode step past the window held call by call
    errs, poisoned, checked_steps = [], [], []
    real = registry.decode_step_paged
    checker = checked_paged(torch, kernel, ref, errs)

    def finite(*args, **kw):
        logits, k, v = real(*args, **kw)
        live = kw["append_mask"].bool().to(logits.device)
        assert bool(torch.isfinite(logits[live]).all()), "NaN in a live lane"
        return logits, k, v

    def before(e):
        poisoned.append(poison_free_pages(torch, e))
        prefill = any(s is not None and s.prefilling for s in e.slots)
        kind = "prefill" if prefill else "decode"
        arm = (e.pages_recycled > 0 and kind not in checked_steps
               and any(s is not None for s in e.slots))
        set_cuda("paged_attention", checker if arm else real_paged)
        if arm:
            checked_steps.append(kind)

    real_paged = cuda_fn("paged_attention")
    try:
        with mock.patch.object(registry, "decode_step_paged", finite):
            again, _ = serve(before)
    finally:
        set_cuda("paged_attention", real_paged)
    assert {r.id: r.tokens for r in again.completed} == tokens, \
        "poisoned free pages changed a token"
    assert window_counts(again) == want
    assert sorted(checked_steps) == ["decode", "prefill"], checked_steps
    assert {(d, w) for d, w, _ in errs} == {(cfg.resolved_head_dim,
                                             cfg.sliding_window)}
    print(f"window, free pages poisoned with NaN before each of "
          f"{len(poisoned)} steps (up to {max(poisoned)} pages): tokens equal "
          f"bit for bit, every live lane's logits finite; {len(errs)} paged "
          f"calls (D 120, window {cfg.sliding_window}, a {ring}-entry ring) "
          f"of one prefill and one decode step past the window held to the "
          f"plain version: max abs err {max(e for _, _, e in errs):.3e} "
          f"(close_scaled, {TOL['bfloat16']})", flush=True)
    return launches


def cluster_phase(torch, np, kernel, ref, card: str) -> int:
    """The serving stack above the engine at full width and depth:
    granite-3-2b (40 layers, one parameter tree) as two same-namespace
    tenants and h2o-danube3-4b (24 layers) on one ``ServeCluster``
    (``CLUSTER``, :func:`cluster_serve`), random bf16 weights from
    ``SEED``, 96 bursty open-loop arrivals on a fake clock. Checks: the
    schedule's counts, report and metrics equal the smoke twins' on the
    CPU; awake banks never above the budget; after every cluster step the
    merge's counters zero and the pool conserved (``owners()`` sums to
    ``in_use``); launches == sum of layers x one-token steps; every paged
    call of one cluster step where every tenant launches held to the plain
    version; every completed request's tokens equal its engine's alone on
    the card; then the trace again under a seeded ``FaultPlan`` (step,
    alloc and token faults) with the danube engine crashed and rebuilt at
    cluster step 40: counts equal the smoke twins', every request completed
    in both runs has the same tokens, journals and pool reconciled, the
    rebuilt engine on the same arena and parameter tensors, device memory
    within 64 MiB of what it was before the crash. Prints wall ms a
    cluster step, launches a step and the device's busy share (three
    profiled steps). Returns the main run's launches."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import init_tree

    archs = {arch for _, arch, _ in CLUSTER_ENGINES}
    t0 = time.perf_counter()
    smoke = {a: smoke_twin(a, "cuda") for a in archs}
    want = cluster_counts(*cluster_serve(smoke, "cuda"))
    want_chaos = cluster_counts(*cluster_serve(smoke, "cuda", faults=True))
    smoke_s = time.perf_counter() - t0
    tenants = {}
    for arch in sorted(archs):
        cfg = configs.get(arch)
        tenants[arch] = (cfg, init_tree(registry.decls(cfg), SEED, "cuda",
                                        dtype=torch.bfloat16))
    torch.cuda.synchronize()
    print(f"cluster: the smoke twins' schedules in {smoke_s:.1f} s: {want}; "
          f"under faults: {want_chaos}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    layers = {name: tenants[arch][0].n_layers
              for name, arch, _ in CLUSTER_ENGINES}
    budget = CLUSTER["max_awake_banks"]
    errs, wall_ms, prof, high = [], [], [], [0]
    real_paged = cuda_fn("paged_attention")

    def on_step(cl, n, step):
        every = all(e.active for e in cl.engines.values())
        arm = not errs and every
        if arm:
            set_cuda("paged_attention", checked_paged(torch, kernel, ref, errs))
        ts = time.perf_counter()
        try:
            if len(prof) < 3 and every and errs and not arm:
                out = []
                prof.append(device_profile(torch, lambda: out.append(step()))
                            [:3])
                stepped = out[0]
            else:
                stepped = step()
                torch.cuda.synchronize()
                wall_ms.append((time.perf_counter() - ts) * 1e3)
        finally:
            set_cuda("paged_attention", real_paged)
        buf = kernel.counter_buffer(dev)
        assert buf is None or not bool(buf.any()), f"counters, step {n}"
        assert cl.awake_banks() <= budget, (n, cl.awake_banks())
        assert sum(cl.pool.owners().values()) == cl.pool.in_use, n
        high[0] = max(high[0], cl.awake_banks())
        return stepped

    torch.cuda.synchronize()
    kernel.launches = 0
    t0 = time.perf_counter()
    cl, rep, summary = cluster_serve(tenants, "cuda", on_step=on_step)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    got = cluster_counts(cl, rep, summary)
    assert got == want, (got, want)
    st = cl.stats()
    token_steps = {n: e["token_steps"] for n, e in st["engines"].items()}
    assert launches == sum(layers[n] * s for n, s in token_steps.items())
    assert {d for d, _, _ in errs} == {
        tenants[a][0].resolved_head_dim for a in archs}, errs
    assert got["power_stalls"] > 0 and got["sheds"] > 0, got
    served = {n: {r.id: r for r in e.completed}
              for n, e in cl.engines.items()}
    for eng in cl.engines.values():
        assert not eng.journal.incomplete()
    assert cl.pool.in_use == cl.table.resident

    # each engine alone on the card: its completed requests, all at once
    for name, arch, kw in CLUSTER_ENGINES:
        cfg, params = tenants[arch]
        alone = ContinuousBatchingEngine(cfg, params, device="cuda",
                                         page_size=CLUSTER["page_size"], **kw)
        for r in served[name].values():
            assert alone.submit(Request(r.id, r.prompt, r.max_new_tokens,
                                        sampling=r.sampling))
        alone.run_until_idle()
        for r in alone.completed:
            assert r.tokens == served[name][r.id].tokens, (name, r.id)
    del alone
    paged_per_step = launches / st["steps"]
    prof_wall = statistics.mean(p[0] for p in prof)
    prof_busy = statistics.mean(p[1] for p in prof)
    prof_launches = statistics.mean(p[2] for p in prof)
    print(f"cluster on {card}: {st['steps']} cluster steps, "
          f"{sum(len(v) for v in served.values())} of 96 requests served "
          f"({st['sheds']} shed, {st['slo_preempts']} SLO preemptions, "
          f"{st['power_stalls']} power stalls, awake banks at most "
          f"{high[0]} of budget {budget}), one-token steps {token_steps}, "
          f"equal to the smoke twins' counts, report and metrics "
          f"(TTFT p50/p99 {summary['ttft_p50']:.2f}/{summary['ttft_p99']:.2f},"
          f" attainment {summary['slo_attainment']:.4f}); paged launches "
          f"{launches} = sum of layers x one-token steps; every request's "
          f"tokens equal its engine's alone; {len(errs)} paged calls of one "
          f"step (D 64 and D 120) held to the plain version, max abs err "
          f"{max(e for _, _, e in errs):.3e}; counters zero and the pool "
          f"conserved after every step", flush=True)
    print(f"cluster step on {card}: {statistics.median(wall_ms):.3f} ms "
          f"(median of {len(wall_ms)}), {paged_per_step:.1f} paged launches a "
          f"step, {wall:.1f} s in all; 3 profiled steps with every tenant "
          f"busy: {prof_wall:.3f} ms a step, device busy {prof_busy:.3f} ms "
          f"({100 * prof_busy / prof_wall:.1f}%), {prof_launches:.0f} "
          f"launches a step", flush=True)

    # the same trace under faults, the danube engine crashed and rebuilt
    mem = {}

    def watch(cl, n, step):
        if n == CLUSTER_CHAOS["crash_at"] - 1:
            mem["engine"] = cl.engines["danube"]
        out = step()
        if n == CLUSTER_CHAOS["crash_at"] - 1:
            torch.cuda.synchronize()
            mem["before"] = torch.cuda.memory_allocated()
        if n == CLUSTER_CHAOS["crash_at"]:
            torch.cuda.synchronize()
            mem["after"] = torch.cuda.memory_allocated()
            new = cl.engines["danube"]
            assert new is not mem["engine"]
            assert new.params is mem["engine"].params
            assert new._arena is mem["engine"]._arena
        return out

    faulted, frep, fsum = cluster_serve(tenants, "cuda", faults=True,
                                        on_step=watch)
    fgot = cluster_counts(faulted, frep, fsum)
    assert fgot == want_chaos, (fgot, want_chaos)
    assert fgot["faults"]["crashes"] == fgot["faults"]["rebuilds"] == 1
    both = 0
    for name, eng in faulted.engines.items():
        assert not eng.journal.incomplete()
        ids = [r.id for r in eng.completed]
        assert len(ids) == len(set(ids))
        for r in eng.completed:
            if r.id in served[name]:
                assert r.tokens == served[name][r.id].tokens, (name, r.id)
                both += 1
    assert faulted.pool.in_use == faulted.table.resident
    assert sum(faulted.pool.owners().values()) == faulted.pool.in_use
    grew = mem["after"] - mem["before"]
    assert grew < 64 << 20, mem
    print(f"cluster under faults on {card}: {fgot['faults']}; {both} "
          f"requests completed in both runs, tokens equal bit for bit; "
          f"journals drained, the pool's references reconciled; the rebuilt "
          f"danube engine on the same arena and parameter tensors, device "
          f"memory {mem['before'] / 2**30:.3f} GiB before the crash, "
          f"{mem['after'] / 2**30:.3f} GiB after the rebuild's first step "
          f"({grew / 2**20:+.1f} MiB)", flush=True)
    del cl, faulted, tenants
    return launches


# ---------------------------------------------------------------------------
# Embeds inputs (the audio and VLM stubs), checkpoints and the dispatch
# ---------------------------------------------------------------------------

# musicgen-large's training recipe: a 30 s clip is 1500 EnCodec frames at
# 50 Hz, so seq 2048; global batch 8 in 2 microbatches of 4
MUSICGEN_TRAIN = {"global_batch": 8, "accum": 2, "seq": 2048, "steps": 4,
                  "lr": 3e-4}
MUSICGEN_TRAIN_ATTN = (4, 2048, 32, 32, 64)   # B, S, H, K, D: G 1
MUSICGEN_SERVE = {"batch": 8, "prompt_len": 512, "steps": 64}
MUSICGEN_PREFILL_ATTN = (8, 512, 32, 32, 64)
# internvl2-76b at full width on 8 of its 80 layers: 80 hold 141.1 GB of
# bf16 weights, more than the card; 8 hold 17.9 GB with the 2.1 GB
# embedding and the 2.1 GB head. 2048 embeddings: 8 image tiles of 256
# patches
VLM_LAYERS = 8
VLM_SERVE = {"batch": 8, "prompt_len": 2048, "steps": 64}
VLM_PREFILL_ATTN = (8, 2048, 64, 8, 128)       # G 8 at D 128
VLM_DECODE = (8, 64, 8, 128, 160, 16)          # B, H, K, D, max_len, ps
# the resume check: musicgen-large's width on 2 of its 48 layers
RESUME_LAYERS = 2
RESUME = {"steps": 6, "cut": 3}


def attention_flops(cfg, batch: int, seq: int) -> int:
    """The causal attention forward's FLOPs over the model (2 products, 2
    FLOPs a multiply-add, over the visible pairs), times 3 for a train step
    (forward, and twice that backward)."""
    return 3 * cfg.n_layers * batch * 4 * cfg.n_heads * \
        cfg.resolved_head_dim * (seq * (seq + 1) // 2)


def flash_shape(torch, fkernel, fref, gen, shape, backward: bool,
                label: str) -> dict:
    """The bf16 flash forward (and backward) at one causal shape of a path:
    kernel against the plain version (``flash_check``), two calls bit for
    bit, the forward on the tensor-core kernel; times kernel, plain version
    and SDPA against the bound. Returns ``{"fwd": {...}, "bwd": {...}}``
    with each kernel's JSON numbers."""
    b, s, h, kh, d = shape
    q, k, v, do = flash_inputs(torch, gen, b, s, h, kh, d, torch.bfloat16)
    errs = flash_check(torch, fkernel, fref, q, k, v, do, True, None,
                       "bfloat16")
    (o, lse), again = (fkernel.flash_attention_fwd_cuda(q, k, v, causal=True)
                       for _ in range(2))
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    del again
    pairs = s * (s + 1) // 2
    sdpa_fn = sdpa_gqa(torch, q, k, v)
    fwd = {"ms": time_ms(torch, lambda i: fkernel.flash_attention_fwd_cuda(
               q, k, v, causal=True), 1, inner=5, reps=7),
           "plain_ms": time_ms(torch, lambda i: grouped(
               torch, lambda *a: fref.flash_attention_ref(*a, causal=True),
               q, k, v, n_out=2), 1, inner=1, reps=3),
           "max_abs_err": max(errs["o"][0], errs["lse"][0])}
    with torch.no_grad():
        fwd["library_ms"] = time_ms(torch, lambda i: sdpa_fn(), 1, inner=10,
                                    reps=11)
    fwd["bound_ms"], fwd["bound_by"] = flash_bound_ms(b, s, h, kh, d, 2,
                                                      pairs, False)
    out = {"fwd": fwd}
    line = (f"forward kernel {fwd['ms']:.4f} ms "
            f"({4 * b * h * d * pairs / fwd['ms'] / 1e9:.1f} TFLOP/s), plain "
            f"{fwd['plain_ms']:.3f} ms, sdpa {fwd['library_ms']:.4f} ms, bound "
            f"{fwd['bound_ms']:.4f} ms ({fwd['bound_by']})")
    if backward:
        first, second = (fkernel.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal=True) for _ in range(2))
        assert all(torch.equal(x, y) for x, y in zip(first, second))
        del first, second
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        so = sdpa_gqa(torch, qs, ks, vs)()
        dos = do.transpose(1, 2)
        bwd = {"ms": time_ms(torch, lambda i: fkernel.flash_attention_bwd_cuda(
                   q, k, v, o, lse, do, causal=True), 1, inner=3, reps=5),
               "plain_ms": time_ms(torch, lambda i: grouped(
                   torch, lambda *a: fref.flash_attention_bwd_ref(
                       *a, causal=True), q, k, v, o, lse, do, n_out=3), 1,
                   inner=1, reps=3),
               "library_ms": time_ms(torch, lambda i: torch.autograd.grad(
                   so, (qs, ks, vs), dos, retain_graph=True), 1, inner=10,
                   reps=11),
               "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv"))}
        bwd["bound_ms"], bwd["bound_by"] = flash_bound_ms(b, s, h, kh, d, 2,
                                                          pairs, True)
        out["bwd"] = bwd
        line += (f"; backward kernel {bwd['ms']:.4f} ms "
                 f"({10 * b * h * d * pairs / bwd['ms'] / 1e9:.1f} TFLOP/s), "
                 f"plain {bwd['plain_ms']:.3f} ms, sdpa backward "
                 f"{bwd['library_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms "
                 f"({bwd['bound_by']})")
    print(f"flash at {label} B={b} S={s} H={h} K={kh} D={d} (G {h // kh}) "
          f"bf16 causal: max abs err {fmt_errs(errs)}; two calls bit for "
          f"bit; {line}", flush=True)
    return out


def train_profile_in_child(argv: list[str], fwd_per_step: int) -> None:
    """:func:`train_profile` of one step of ``launch.train.main(argv)``,
    after one step of warm-up, in a child process: there the profiler
    starts afresh, while in this process, after the earlier phases'
    profiles, one more profiled step makes it drop the device events of
    later phases' profiles (PERF.md §7). Prints the child's profile line;
    raises if the child fails."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "import torch; import chip_smoke as cs; "
            "from repro_torch.launch import train; "
            f"run = train.main({argv + ['--steps', '1']!r}); "
            "cs.train_profile(torch, run.train_step, run.params, "
            "run.opt_state, run.data.batch_at(1), cs.card_line(), "
            f"{fwd_per_step})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        raise AssertionError(f"profiled step in a child process failed:\n"
                             f"{out.stdout[-2000:]}\n{out.stderr[-4000:]}")
    print([line for line in out.stdout.splitlines()
           if line.startswith("train profile")][-1], flush=True)


def embeds_train_phase(torch, np, fkernel, fref, card: str) -> dict:
    """Full-width, full-depth musicgen-large (48 layers, MHA, 2.42e9
    parameters) trained on embeddings by the training entry point: AdamW,
    global batch 8 in 2 microbatches of 4, seq 2048, remat full, 4 steps.
    A control first: the gradient's norm at the embeddings on one
    microbatch at the reference's init (it blows up, as granite's
    overflows) and at the true fan-in, which the run takes. Checks finite, falling loss, the flash launch counts (every
    forward on the tensor-core kernel, D 64 at G 1), holds every attention
    call of one microbatch to the plain version, profiles one step (in a
    child process: :func:`train_profile_in_child`) and times the flash
    kernels at the microbatch's shape. Returns the forward
    and backward launches of the 4 steps and the timings."""
    import math

    from repro_torch import configs
    from repro_torch.data.lm import LMDataConfig, LMPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree
    from repro_torch.train.trainer import TrainConfig, make_loss_fn

    cfg = configs.get("musicgen_large")
    assert not registry.uses_token_inputs(cfg) and cfg.remat == "full"
    n_params = cfg.param_count()
    r = MUSICGEN_TRAIN
    mb = {k: v[0] for k, v in LMPipeline(LMDataConfig(
        vocab=cfg.vocab, seq=r["seq"], global_batch=r["global_batch"],
        accum=r["accum"], seed=SEED, embed_dim=cfg.d_model)).batch_at(0).items()}
    assert mb["embeds"].dtype == torch.bfloat16
    loss_fn = make_loss_fn(cfg, TrainConfig(lr=r["lr"], accum=r["accum"]))
    params = init_tree(registry.decls(cfg), SEED, "cuda",
                       dtype=torch.bfloat16)

    def embeds_grad_norm(p):
        x = mb["embeds"].to("cuda").requires_grad_()
        grad, = torch.autograd.grad(loss_fn(p, dict(mb, embeds=x))[0], [x])
        return torch.linalg.vector_norm(grad.float()).item()

    # control: at the reference's init (its fan-in of the 3-d attention
    # projections is a head count) the gradients of these 48 layers blow
    # up; the launcher trains at the true fan-in, as granite's phase does
    norms = {"reference": embeds_grad_norm(params)}
    params = registry.true_fan_in(params, cfg)
    norms["true-fan-in"] = embeds_grad_norm(params)
    assert math.isfinite(norms["true-fan-in"]) and \
        norms["true-fan-in"] < norms["reference"], norms
    print(f"embeds train control: the gradient norm at one microbatch's "
          f"embeddings is {norms['reference']:.4e} at the reference's init, "
          f"{norms['true-fan-in']:.4e} at the true fan-in: --init "
          f"true-fan-in")
    with torch.no_grad():
        loss_before = loss_fn(params, mb)[0].item()
    del params
    torch.cuda.empty_cache()

    argv = ["--arch", "musicgen-large", "--init", "true-fan-in", "--steps",
            str(r["steps"]), "--global-batch", str(r["global_batch"]),
            "--accum", str(r["accum"]), "--seq", str(r["seq"]), "--lr",
            str(r["lr"]), "--seed", str(SEED)]
    tokens = r["global_batch"] * r["seq"]
    step_flops = 6 * n_params * tokens + attention_flops(
        cfg, r["global_batch"], r["seq"])
    print(f"embeds train: python -m repro_torch.launch.train {' '.join(argv)} "
          f"(musicgen-large, {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.resolved_head_dim} ({cfg.n_kv_heads} "
          f"KV heads), {n_params} parameters in bf16, embeddings of "
          f"{cfg.d_model} in bf16)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    fkernel.launches_fwd = fkernel.launches_bwd = fkernel.launches_fwd_mma = 0
    run = launch_train.main(argv)
    launches = (fkernel.launches_fwd, fkernel.launches_bwd)
    assert fkernel.launches_fwd_mma == launches[0], fkernel.launches_fwd_mma
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses, times = run.losses, run.seconds
    assert len(losses) == r["steps"] and all(np.isfinite(losses)), losses
    assert all(np.isfinite(run.grad_norms)), run.grad_norms
    assert losses[-1] < losses[0], losses
    assert run.data.cfg.embed_dim == cfg.d_model
    want = (r["steps"] * cfg.n_layers * r["accum"] * 2,
            r["steps"] * cfg.n_layers * r["accum"])
    assert launches == want, (launches, want)
    steady = statistics.median(times[1:])
    print(f"embeds train on {card}: step {steady:.3f} s (median of steps "
          f"2-{r['steps']}; step 1 {times[0]:.3f} s), {tokens / steady:.0f} "
          f"tokens/s, mfu {step_flops / (steady * BF16_OPS_PER_S):.4f} "
          f"({step_flops:.4e} FLOPs a step: 6 N T {6 * n_params * tokens:.4e} "
          f"+ 3 x the causal attention forward), peak memory {peak_gb:.2f} "
          f"GB; flash launches {launches[0]} forward (all on the tensor-core "
          f"kernel) = {r['steps']} steps x {cfg.n_layers} layers x "
          f"{r['accum']} microbatches x 2, {launches[1]} backward; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{' '.join(f'{x:.4f}' for x in run.grad_norms)}", flush=True)
    loss = held_microbatch(torch, fref, loss_fn, run.params, mb, cfg.n_layers,
                           "embeds train")
    assert loss < loss_before, (loss, loss_before)
    print(f"embeds train: loss on the first microbatch {loss_before:.4f} "
          f"before the {r['steps']} steps, {loss:.4f} after")
    del run
    torch.cuda.empty_cache()
    train_profile_in_child(argv, launches[0] // r["steps"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    times = flash_shape(torch, fkernel, fref, gen, MUSICGEN_TRAIN_ATTN, True,
                        "musicgen-large's training microbatch")
    return {"launches": launches, "timing": times}


def held_prefill(torch, fref, run, n_layers: int, label: str) -> None:
    """Every flash forward of one prompt's prefill (the run's first batch
    row) against the plain version in float64 on that call's own inputs: o
    under ``close_scaled`` at the bf16 bound, lse at float32's; as the
    hybrid and moe serve phases hold them (random weights give large scores
    whose softmax hangs on near-ties)."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.models import registry

    errs, kernel_fwd = [], attn_ops._forward

    def checked_fwd(q, k, v, causal, window):
        o, lse = kernel_fwd(q, k, v, causal, window)
        eo, e64 = fref.flash_attention_ref(q.double(), k.double(), v.double(),
                                           causal=causal, window=window)
        errs.append((*close_scaled(o, eo.float(), TOL["bfloat16"],
                                   TOL["bfloat16"]),
                     close(lse, e64, TOL["float32"])))
        return o, lse

    prompt = run.prompt[:1]
    key = "tokens" if prompt.dim() == 2 else "embeds"
    with mock.patch.object(attn_ops, "_forward", checked_fwd), \
            torch.inference_mode():
        one, _ = registry.prefill(run.params, run.cfg, max_len=run.serve.max_len,
                                  **{key: prompt})
    assert bool(torch.isfinite(one.float()).all())
    assert len(errs) == n_layers, len(errs)
    print(f"{label}: every flash forward of one prompt's prefill held to the "
          f"plain version in float64 on its own inputs: {len(errs)} calls, o "
          f"max abs err {max(e[0] for e in errs):.3e}, scales "
          f"{min(e[1] for e in errs):.3e} to {max(e[1] for e in errs):.3e} "
          f"(bound {TOL['bfloat16']} * scale + {TOL['bfloat16']} * "
          f"|float64|); lse {max(e[2] for e in errs):.3e} (bound "
          f"{TOL['float32']} + {TOL['float32']} * |float64|)")


def embeds_serve_phase(torch, np, fkernel, fref, card: str):
    """The serve driver (``repro_torch.launch.serve.run``) prefilling from
    embeddings and decoding tokens, batch 8, 64 greedy steps: full-width,
    full-depth musicgen-large on a 512-frame prompt, then internvl2-76b at
    full width on 8 of its 80 layers on a 2048-embedding prompt. Checks the
    launch counts of every call (the prefill's flash forwards, all on the
    tensor-core kernel; none in a decode step), holds every flash call of
    one prompt's prefill to the plain version, and times the flash forward
    at both prefill shapes. Returns the flash launches by path, the two
    timings, and internvl2's config and weights for the engine phase."""
    from repro_torch import configs
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry

    launches, keep = {}, None
    for name, cfg, spec in (
            ("musicgen-large", configs.get("musicgen_large"), MUSICGEN_SERVE),
            (f"internvl2-76b ({VLM_LAYERS} of 80 layers)",
             dataclasses.replace(configs.get("internvl2_76b"),
                                 n_layers=VLM_LAYERS), VLM_SERVE)):
        assert not registry.uses_token_inputs(cfg)
        b, plen, steps = spec["batch"], spec["prompt_len"], spec["steps"]
        print(f"embeds serve: launch.serve.run({cfg.name}, {cfg.n_layers} "
              f"layers, batch {b}, {plen} embeddings, {steps} steps)",
              flush=True)
        fkernel.launches_fwd = fkernel.launches_fwd_mma = 0
        run, calls = counted_serve(
            launch_serve, lambda: launch_serve.run(cfg, b, plen, steps,
                                                   seed=SEED),
            lambda: (fkernel.launches_fwd, fkernel.launches_fwd_mma))
        L = cfg.n_layers
        assert calls[0] == ("prefill", L, L), calls[0]
        assert calls[1:] == [("decode", 0, 0)] * steps, calls[1:4]
        assert tuple(run.prompt.shape) == (b, plen, cfg.d_model)
        assert tuple(run.tokens.shape) == (b, steps)
        assert bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all())
        assert bool(torch.isfinite(run.logits.float()).all())
        assert int(run.cache.pos) == plen + steps
        launches[f"serve driver, {name}"] = fkernel.launches_fwd
        step_ms = statistics.median(run.decode_s) * 1e3
        print(f"embeds serve on {card}: {name}, {cfg.param_count()} "
              f"parameters in bf16; prefill {b} x {plen} embeddings "
              f"{run.prefill_s:.3f} s ({b * plen / run.prefill_s:.0f} "
              f"positions/s); decode step {step_ms:.3f} ms (median of {steps}; "
              f"first {run.decode_s[0] * 1e3:.3f} ms), "
              f"{b * steps / sum(run.decode_s):.1f} tokens/s; peak memory "
              f"{run.peak_bytes / 1e9:.2f} GB; {L} flash forwards (all on "
              f"the tensor-core kernel) in the prefill, 0 in each decode step",
              flush=True)
        held_prefill(torch, fref, run, L, f"embeds serve, {name}")
        if cfg.family == "vlm":
            keep = (cfg, run.params)
        del run
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    timings = {
        "musicgen": flash_shape(torch, fkernel, fref, gen,
                                MUSICGEN_PREFILL_ATTN, False,
                                "musicgen-large's prefill")["fwd"],
        "internvl2": flash_shape(torch, fkernel, fref, gen, VLM_PREFILL_ATTN,
                                 False, "internvl2-76b's prefill")["fwd"]}
    return launches, timings, keep


def vlm_engine_phase(torch, np, kernel, ref, cfg, params, card: str) -> dict:
    """internvl2-76b (8 of 80 layers, the serve phase's weights) served by
    ``ContinuousBatchingEngine`` on its paged backend by tokens, as the
    reference's engine serves every config: 8 slots, 16-token pages,
    prefill chunk 16, the serve phase's trace (16 requests of a shared
    64-token prompt, 32 greedy tokens each). Checks completions, prefix
    reuse and launches == layers x one-token steps, holds every paged call
    of one teacher-forced request to the plain version, and times the
    kernel at this decode shape (D 128, 64 query heads over 8 KV heads)
    from a CUDA graph against its bound and SDPA. Returns the launches and
    the timing."""
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request

    page_size = 16
    engine = ContinuousBatchingEngine(cfg, params, slots=8, max_len=160,
                                      device="cuda", page_size=page_size,
                                      prefill_chunk=16)
    assert engine.stats()["backend"] == "paged"
    for rid, prompt, n_new in serve_trace(np):
        assert engine.submit(Request(rid, prompt, n_new))
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    decode_ms, steps, t0 = [], 0, time.perf_counter()
    while True:
        before = engine.token_steps
        ts = time.perf_counter()
        if not engine.step():
            break
        steps += 1
        if engine.token_steps - before == 1:
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    launches = kernel.launches
    stats = engine.stats()
    assert len(engine.completed) == 16
    for r in engine.completed:
        assert len(r.tokens) == r.max_new_tokens, r.id
        assert all(0 <= t < cfg.vocab for t in r.tokens), r.id
    assert stats["prompt_tokens_reused"] > 0, stats
    assert launches == cfg.n_layers * stats["token_steps"], launches
    print(f"vlm engine on {card}: internvl2-76b ({cfg.n_layers} of 80 "
          f"layers), {steps} engine steps, {stats['token_steps']} one-token "
          f"steps, {stats['tokens_generated']} tokens, "
          f"{stats['prompt_tokens_reused']} prompt tokens reused; decode step "
          f"{statistics.median(decode_ms):.3f} ms (median of {len(decode_ms)} "
          f"decode-only steps), {stats['tokens_generated'] / wall:.1f} "
          f"tokens/s over {wall:.3f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; paged launches "
          f"{launches} = {cfg.n_layers} layers x {stats['token_steps']} steps",
          flush=True)
    req = engine.completed[-1]
    seq = list(req.prompt) + req.tokens
    errs = []
    with on_cuda("paged_attention", checked_paged(torch, kernel, ref, errs)):
        logits = teacher_force(torch, registry, cfg, params, seq, page_size,
                               "cuda")
    assert bool(torch.isfinite(logits).all())
    assert len(errs) == cfg.n_layers * (len(seq) - 1), len(errs)
    print(f"vlm engine: every paged call of teacher-forced {req.id} held to "
          f"the plain version on its own inputs: {len(errs)} calls (D 128, "
          f"G 8), max abs err {max(e for _, _, e in errs):.3e} (bound "
          f"{TOL['bfloat16']} * scale + {TOL['bfloat16']} * |plain|)")
    del engine
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    timed = timing(torch, gen, kernel, ref, *VLM_DECODE)
    return {"launches": launches, "timing": timed}


def resume_phase(torch, np, fref, card: str) -> None:
    """The train launcher's checkpoints: musicgen-large at full width on 2
    of its 48 layers, 6 steps straight against 3 steps, a checkpoint
    (``--ckpt-every 3``), a restore into a fresh launcher state
    (``--resume``) and 3 more; the losses, the params and the optimizer
    state equal bit for bit. Times a save and a restore of that state and
    holds every attention call of one microbatch to the plain version.
    Writes under a temporary directory that it removes."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.ckpt import checkpoint
    from repro_torch.data.lm import LMDataConfig, LMPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding.params import count_params, tree_leaves, tree_map
    from repro_torch.train.trainer import TrainConfig, make_loss_fn

    cfg = dataclasses.replace(configs.get("musicgen_large"),
                              n_layers=RESUME_LAYERS)
    r = MUSICGEN_TRAIN
    argv = ["--arch", "musicgen-large", "--init", "true-fan-in",
            "--global-batch", str(r["global_batch"]), "--accum",
            str(r["accum"]), "--seq", str(r["seq"]), "--lr", str(r["lr"]),
            "--seed", str(SEED), "--ckpt-every", str(RESUME["cut"])]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build"))
    try:
        with mock.patch.object(launch_train.configs, "get", lambda _: cfg):
            straight = launch_train.main(argv + ["--steps",
                                                 str(RESUME["steps"])])
            cut = launch_train.main(argv + ["--steps", str(RESUME["cut"]),
                                            "--ckpt", str(tmp / "run")])
            t0 = time.perf_counter()
            checkpoint.save(tmp / "timed", cut.params, step=RESUME["cut"])
            checkpoint.save(tmp / "timed" / "opt", cut.opt_state,
                            step=RESUME["cut"])
            save_s = time.perf_counter() - t0
            del cut
            torch.cuda.empty_cache()
            like = lambda tree: tree_map(   # noqa: E731
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
                if isinstance(t, torch.Tensor) else t, tree)
            t0 = time.perf_counter()
            p, _, _ = checkpoint.restore(tmp / "timed", like(straight.params),
                                         device="cuda")
            o, _, _ = checkpoint.restore(tmp / "timed" / "opt",
                                         like(straight.opt_state),
                                         device="cuda")
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            n_bytes = sum(t.numel() * t.element_size()
                          for t in tree_leaves(p) + tree_leaves(
                              {k: v for k, v in o.items() if k != "step"}))
            del p, o
            resumed = launch_train.main(argv + ["--steps",
                                                str(RESUME["steps"]),
                                                "--ckpt", str(tmp / "run"),
                                                "--resume"])
        assert resumed.start_step == RESUME["cut"]
        assert resumed.losses == straight.losses[RESUME["cut"]:], (
            resumed.losses, straight.losses)
        differ = [name for name, a, b in zip(
            ("params",) * len(tree_leaves(straight.params)),
            tree_leaves(straight.params), tree_leaves(resumed.params))
            if not torch.equal(a, b)]
        for key in ("master", "m", "v"):
            differ += [key for a, b in zip(
                tree_leaves(straight.opt_state[key]),
                tree_leaves(resumed.opt_state[key])) if not torch.equal(a, b)]
        assert not differ, f"resumed state differs from the straight run's: " \
                           f"{sorted(set(differ))}"
        assert resumed.opt_state["step"] == straight.opt_state["step"]
        n_params = count_params(straight.params)
        print(f"resume on {card}: musicgen-large's width on {cfg.n_layers} of "
              f"48 layers ({n_params} parameters), {RESUME['steps']} steps "
              f"straight against {RESUME['cut']}, a checkpoint, a restore "
              f"and {RESUME['steps'] - RESUME['cut']} more: losses, params "
              f"and AdamW's master, m and v bit for bit (losses "
              f"{' '.join(f'{x:.6f}' for x in straight.losses)}); a save of "
              f"params and optimizer state {n_bytes} bytes in {save_s:.3f} s "
              f"({n_bytes / save_s / 1e9:.2f} GB/s), a restore to the card "
              f"{restore_s:.3f} s ({n_bytes / restore_s / 1e9:.2f} GB/s)",
              flush=True)
        mb = {k: v[0] for k, v in LMPipeline(LMDataConfig(
            vocab=cfg.vocab, seq=r["seq"], global_batch=r["global_batch"],
            accum=r["accum"], seed=SEED,
            embed_dim=cfg.d_model)).batch_at(0).items()}
        held_microbatch(torch, fref, make_loss_fn(cfg, TrainConfig(
            lr=r["lr"], accum=r["accum"])), resumed.params, mb, cfg.n_layers,
            "resume")
    finally:
        shutil.rmtree(tmp)


def dispatch_phase(torch, np, kernel, card: str) -> None:
    """The XAIF promise on the card: a probe accelerator under a new impl
    key (``probe_accelerators``: it wraps the ``"cuda"`` one and counts its
    calls) is reached by a config whose ``attn_impl`` names it, with no
    edit to model code. The granite smoke config served by the engine's
    paged backend twice, ``"cuda"`` and the probe: the same tokens bit for
    bit, every paged call of the probe's run through the probe and on to
    the kernel."""
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import init_tree

    base = configs.smoke("granite_3_2b")
    params = init_tree(registry.decls(base), SEED, "cuda",
                       dtype=torch.bfloat16)

    def serve(cfg):
        eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=48,
                                       device="cuda", page_size=8)
        for i in range(3):
            eng.submit(Request(f"p{i}", [(11 * i + j) % cfg.vocab
                                         for j in range(10)], 8))
        eng.run_until_idle()
        return {r.id: r.tokens for r in eng.completed}, eng.token_steps

    with probe_accelerators("probe") as counts:
        want, _ = serve(base)
        assert not any(counts.values()), counts
        kernel.launches = 0
        got, steps = serve(dataclasses.replace(base, attn_impl="probe"))
    assert got == want and len(got) == 3, (got, want)
    assert counts["paged_attention"] == kernel.launches == \
        base.n_layers * steps > 0, (counts, kernel.launches, steps)
    print(f"dispatch on {card}: a probe accelerator under impl key 'probe' "
          f"received all {counts['paged_attention']} paged attention calls "
          f"({base.n_layers} layers x {steps} one-token steps) of the smoke "
          f"engine run with attn_impl='probe', each launching the kernel; "
          f"tokens bit for bit the 'cuda' run's")


def argmax_tie(torch) -> None:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((8, 49155), generator=gen, device="cuda").to(dt)
        first = torch.randint(0, 49155 // 2, (8,), generator=gen, device="cuda")
        second = first + 1000
        rows = torch.arange(8, device="cuda")
        x[rows, first] = 100.0
        x[rows, second] = 100.0
        assert torch.equal(torch.argmax(x, dim=-1), first), dt
    print("torch.argmax on the card takes the first maximal index")


def build_all(*modules) -> None:
    """Build every kernel at once, one ``nvcc`` each, and print the
    compiler's resource reports."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        libs = list(pool.map(lambda m: m.build(), modules))
    print(f"built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.attention import kernel as fkernel
    from repro_torch.kernels.attention import ref as fref
    from repro_torch.kernels.conv1d import kernel as ckernel
    from repro_torch.kernels.conv1d import ref as cref
    from repro_torch.kernels.moe import kernel as gkernel
    from repro_torch.kernels.moe import ref as gref
    from repro_torch.kernels.paged_attention import kernel, ref
    from repro_torch.kernels.rglru import kernel as rkernel
    from repro_torch.kernels.rglru import ref as rref
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.kernels.ssd import ref as sref

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    build_all(kernel, fkernel, rkernel, skernel, ckernel, gkernel)

    paged = kernel_phase(torch, kernel, ref)
    launched, greedy = serve_phase(torch, np, kernel, ref, card)
    small_reference_phase(torch, np)
    argmax_tie(torch)
    torch.cuda.empty_cache()
    fwd, bwd = flash_phase(torch, fkernel, fref)
    torch.cuda.empty_cache()
    granite_fwd, granite_bwd = train_phase(torch, np, fkernel, fref, card)
    torch.cuda.empty_cache()
    small_train_reference_phase(torch, np)
    torch.cuda.empty_cache()
    scan = rglru_phase(torch, rkernel, rref)
    torch.cuda.empty_cache()
    fwd256 = flash256_phase(torch, fkernel, fref)
    torch.cuda.empty_cache()
    scan["launches"], fwd256["launches"] = hybrid_serve_phase(
        torch, np, rkernel, rref, fkernel, fref, card)
    torch.cuda.empty_cache()
    small_hybrid_reference_phase(torch, np)
    torch.cuda.empty_cache()
    ssd = ssd_phase(torch, skernel, sref)
    torch.cuda.empty_cache()
    ssd["launches"] = mamba2_serve_phase(torch, np, skernel, sref, card)
    torch.cuda.empty_cache()
    small_mamba2_reference_phase(torch, np)
    torch.cuda.empty_cache()
    scan_bwd, bwd256, ssd_bwd = backward_phase(torch, rkernel, rref, fkernel,
                                               fref, skernel, sref)
    torch.cuda.empty_cache()
    kernels = (rkernel, rref, fkernel, fref, skernel, sref)
    rg = recurrent_train_phase(torch, np, RG_TRAIN, kernels, card)
    torch.cuda.empty_cache()
    m2 = recurrent_train_phase(torch, np, M2_TRAIN, kernels, card)
    torch.cuda.empty_cache()
    small_recurrent_train_reference_phase(torch, np)
    torch.cuda.empty_cache()
    # the recurrent kernels' two main paths: the serve driver and training
    for entry, train in ((scan, rg["scan"]), (fwd256, rg["flash_fwd"]),
                         (ssd, m2["ssd"])):
        entry["launches_by_path"] = {"serve driver": entry["launches"],
                                     "train": train}
        entry["launches"] += train
    scan_bwd["launches"] = rg["scan_bwd"]
    bwd256["launches"] = rg["flash_bwd_d256"]
    ssd_bwd["launches"] = m2["ssd_bwd"]
    conv = conv1d_phase(torch, ckernel, cref)
    conv["launches"] = healthcare_phase(torch, np, ckernel, cref, card)
    torch.cuda.empty_cache()
    gmm = gmm_phase(torch, gkernel, gref)
    torch.cuda.empty_cache()
    served, grok_cfg, grok_params = grok_serve_phase(
        torch, np, gkernel, gref, fkernel, fref, card)
    lanes = grok_lane_phase(torch, np, gkernel, gref, grok_cfg, grok_params,
                            card)
    del grok_params
    torch.cuda.empty_cache()
    # the grouped matmul's two main paths: the serve driver and the engine
    gmm["launches_by_path"] = {
        "serve driver": served, "lane engine": lanes["launches"],
        "lane engine, mixed sampling, sync": lanes["mixed sync"],
        "lane engine, mixed sampling, async": lanes["mixed async"]}
    gmm["launches"] = sum(gmm["launches_by_path"].values())
    gmm["lane_engine_ms"] = lanes["ms"]
    small_moe_reference_phase(torch, np)
    torch.cuda.empty_cache()
    recurrent_lane_phase(torch, np, card)
    small_lane_reference_phase(torch, np)
    torch.cuda.empty_cache()
    by_path = {"serve engine, greedy, sync": launched}
    by_path["window engine, h2o-danube3-4b (4 of 24 layers)"] = window_phase(
        torch, np, kernel, ref, card)
    torch.cuda.empty_cache()
    by_path["cluster, granite-3-2b x 2 + h2o-danube3-4b"] = cluster_phase(
        torch, np, kernel, ref, card)
    torch.cuda.empty_cache()
    by_path.update(sampled_engine_phase(torch, np, kernel, greedy, card))
    torch.cuda.empty_cache()
    # after every phase whose checks read the profiler: their launches make
    # the profiler drop the device events of later profiled windows
    emb_train = embeds_train_phase(torch, np, fkernel, fref, card)
    torch.cuda.empty_cache()
    resume_phase(torch, np, fref, card)
    torch.cuda.empty_cache()
    served, emb_flash, (vlm_cfg, vlm_params) = embeds_serve_phase(
        torch, np, fkernel, fref, card)
    vlm = vlm_engine_phase(torch, np, kernel, ref, vlm_cfg, vlm_params, card)
    del vlm_params
    torch.cuda.empty_cache()
    dispatch_phase(torch, np, kernel, card)
    # the D <= 128 flash kernels' main paths: training (tokens and
    # embeddings) and the serve driver's prefill from embeddings
    fwd["launches_by_path"] = {
        "train, granite-3-2b": granite_fwd,
        "train, musicgen-large (embeds)": emb_train["launches"][0], **served}
    bwd["launches_by_path"] = {
        "train, granite-3-2b": granite_bwd,
        "train, musicgen-large (embeds)": emb_train["launches"][1]}
    for entry in (fwd, bwd):
        entry["launches"] = sum(entry["launches_by_path"].values())
    fwd["by_shape"] = {
        "musicgen-large train microbatch (4, 2048, 32, 32, 64)":
            emb_train["timing"]["fwd"],
        "musicgen-large prefill (8, 512, 32, 32, 64)": emb_flash["musicgen"],
        "internvl2-76b prefill (8, 2048, 64, 8, 128)": emb_flash["internvl2"]}
    bwd["by_shape"] = {
        "musicgen-large train microbatch (4, 2048, 32, 32, 64)":
            emb_train["timing"]["bwd"]}
    by_path[f"vlm engine, internvl2-76b ({VLM_LAYERS} of 80 layers)"] = \
        vlm["launches"]
    paged["by_shape"] = {"internvl2-76b decode (8, 64, 8, 128), max_len 160":
                         {k: vlm["timing"][k] for k in (
                             "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms", "max_abs_err")}}
    paged["launches"] = sum(by_path.values())
    paged["launches_by_path"] = by_path
    torch.cuda.empty_cache()
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [paged, fwd, bwd, scan, fwd256, ssd, conv,
                                  gmm, scan_bwd, bwd256, ssd_bwd]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
