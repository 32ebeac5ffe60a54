#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA;
imports nothing of JAX or of the JAX package ``src/repro``. In order:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the paged-attention, flash-attention, RG-LRU scan and SSD
   chunk-scan kernels from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc``
   each, started together; reused when already built) and prints the
   compiler's resource reports;
3. kernel phase: holds the paged CUDA kernel against its plain PyTorch
   version on the card, on the reference's test cases in float32 and
   bfloat16 and at granite-3-2b's decode shape (8 slots, 32 query / 8 KV
   heads, head dim 64, 16-token pages, ragged lengths up to 1024, bf16 pool,
   with and without a ring-table window), then times kernel, plain version
   and ``scaled_dot_product_attention`` (the yardstick, never called by the
   port) with CUDA events;
4. serve phase: full-width, full-depth granite-3-2b with random weights
   made on the card from a seed, served by ``ContinuousBatchingEngine``
   (8 slots, 16-token pages, prefill chunk 16): 16 requests sharing a
   64-token system prompt, 32 greedy tokens each. Checks completions,
   prefix reuse, and that every attention call went through the kernel
   (launches == n_layers x one-token steps); then teacher-forces one request
   through the kernel path, holding every attention call to the plain
   version on that call's own inputs. (Full-width logits of the kernel path
   and the plain path are printed, not compared: this random-weight model
   at depth 40 turns a one-ulp difference into O(1) logit differences
   within a few steps, and a printed control shows the same for the plain
   path against itself perturbed by one bf16 ulp.)
5. small reference: the granite smoke config (3 layers, float32) served on
   the card and on the CPU's plain path gives equal completions, after a
   check that its greedy margins are clear, and its teacher-forced logits
   agree between the kernel path and the plain path on the card;
6. checks that ``torch.argmax`` on the card takes the first maximal index;
7. flash kernel phase: the CUDA flash forward (o and lse) and backward (dq,
   dk, dv) against their plain versions on the reference's attention cases
   in float32 and bfloat16, against float64 at one small shape, and at
   granite's training shape (B 2, S 4096, H 32, K 8, D 64, bf16, causal),
   each tensor at a bound scaled to its size (``close_scaled``); times
   kernels, plain versions and SDPA forward and backward there;
8. train phase: full-width, full-depth granite-3-2b, 4 AdamW steps (lr
   3e-4, global batch 4 in 2 microbatches, seq 4096, remat full) through
   the training entry point ``repro_torch.launch.train`` (``--init
   true-fan-in``) on ``LMPipeline`` batches. Checks finite and falling
   loss and grad norms, 160 forward and 80 backward flash launches per step
   (every attention call went through the kernels), holds every attention
   call of one microbatch to the plain version on its own inputs, prints
   step time, tokens/s, mfu and peak memory, and profiles one step;
9. small train reference: the granite smoke config in float32, 2 steps on
   the card through the kernels and on the CPU through the plain path from
   the same params and batches: losses, grad norms and params agree;
10. RG-LRU phase: the CUDA scan against its plain version on the
    reference's cases, a ragged S and W, against float64, and at
    recurrentgemma-2b's prefill shape (B 8, S 4096, W 2560), timed there;
11. flash D 256 phase: the flash forward at head dim 256 (MQA, a window)
    against its plain version on a small case, against float64, and at
    recurrentgemma-2b's prefill shape (B 8, S 4096, H 10, K 1, window 2048,
    bf16); timed there against the plain version and windowed SDPA;
12. hybrid serve phase: full-width recurrentgemma-2b through the serve
    driver ``repro_torch.launch.serve`` (batch 8, a 4096-token prompt, 64
    greedy steps). Checks 18 scan and 8 flash-forward launches in the
    prefill and none in a decode step, holds every scan and flash call of
    one prompt's prefill to the plain versions, prints prefill time,
    decode-step time, tokens/s and peak memory, and profiles a prefill and
    a decode step;
13. small hybrid reference: the recurrentgemma smoke config served on the
    card (through the kernels) and on the CPU's plain path: logits, caches
    and clear-margin greedy tokens agree;
14. SSD phase: the CUDA SSD chunk scan against its plain version on the
    reference's cases (float32 and bf16 x), ragged S, bf16 B and C shared
    by the heads with stride 0, against a float64 oracle, and at
    mamba2-370m's prefill shape (b 8, s 4096, 32 heads, p 64, n 128, chunk
    256), timed there;
15. mamba2 serve phase: full-width mamba2-370m through the serve driver
    ``repro_torch.launch.serve`` (batch 8, a 4096-token prompt, 64 greedy
    steps). Checks 48 SSD launches in the prefill and none in a decode
    step, holds every SSD call of one prompt's prefill to the plain
    version, prints prefill time, decode-step time, tokens/s and peak
    memory, profiles a prefill and a decode step, and counts the launches
    that the decode step's SiLU (rounded as XLA rounds it) takes;
16. small mamba2 reference: the mamba2 smoke config served on the card
    (through the kernel) and on the CPU's plain path: logits, caches and
    clear-margin greedy tokens agree.

Prints a ``{"kernels": [...]}`` JSON line, the card line again, and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the run
exits non-zero and prints no result; so does a machine without a card.
"""

from __future__ import annotations

import json
import pathlib
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
              copies=1, ring=False):
    """Random pools (``copies`` layers of them), shuffled disjoint page
    chains, ragged lengths in [1, max_len]; ``ring`` builds ring tables of
    ceil(window/ps)+1 entries holding each slot's newest blocks."""
    dev = "cuda"
    lengths = torch.randint(1, max_len + 1, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    np_slot = -(-window // ps) + 1 if ring else -(-max_len // ps)
    n_pages = b * np_slot + 1
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    tables = perm[:b * np_slot].reshape(b, np_slot).contiguous()
    shape = (copies, n_pages, ps, kh, d)
    kp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    vp = torch.randn(shape, generator=gen, device=dev).to(kv_dtype)
    q = torch.randn((b, h, d), generator=gen, device=dev).to(q_dtype)
    return q, kp, vp, tables, lengths


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

    # timed at the serve phase's shape (10-entry tables, max_len 160) and at
    # granite's decode shape with lengths up to 1024, which the JSON line
    # reports
    timing(torch, gen, kernel, ref, b, h, kh, d, 160, ps)
    return timing(torch, gen, kernel, ref, b, h, kh, d, max_len, ps)


def timing(torch, gen, kernel, ref, b, h, kh, d, max_len, ps) -> dict:
    """Kernel, plain version and SDPA times on one bf16 case, its bound, and
    the kernel's error against the plain version."""
    copies = 8
    q, kp, vp, tables, lengths = pool_case(
        torch, gen, b, h, kh, d, max_len, ps, None, torch.bfloat16,
        torch.bfloat16, copies=copies)
    got = kernel.paged_attention_cuda(q, kp[0], vp[0], tables, lengths)
    want = ref.paged_attention(q, kp[0], vp[0], tables, lengths)
    max_err = close(got, want, TOL["bfloat16"])
    ms = time_ms(torch, lambda i: kernel.paged_attention_cuda(
        q, kp[i], vp[i], tables, lengths), copies)
    plain_ms = time_ms(torch, lambda i: ref.paged_attention(
        q, kp[i], vp[i], tables, lengths), copies, inner=10, reps=11)
    # yardstick: SDPA on the same KV gathered contiguous (outside the timing)
    s = tables.shape[1] * ps
    kc = kp[:, tables.long()].reshape(copies, b, s, kh, d).transpose(2, 3).contiguous()
    vc = vp[:, tables.long()].reshape(copies, b, s, kh, d).transpose(2, 3).contiguous()
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])[:, None, None]
    qs = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) < (2, 5):
        # no enable_gqa before torch 2.5: give SDPA the KV heads repeated
        kc = kc.repeat_interleave(h // kh, dim=2)
        vc = vc.repeat_interleave(h // kh, dim=2)
        gqa = {}
    else:
        gqa = {"enable_gqa": True}
    library_ms = time_ms(torch, lambda i: sdpa(qs, kc[i], vc[i], attn_mask=mask,
                                               **gqa), copies)
    n_pos = int(lengths.sum())
    elt = 2                                     # bf16
    moved = (2 * n_pos * kh * d * elt           # k and v, each read once
             + 2 * b * h * d * elt              # q in, o out
             + tables.numel() * 4 + lengths.numel() * 4)
    ops = 4 * n_pos * h * d                     # q.k and p.v multiply-adds
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    print(f"paged attention at B={b} H={h} K={kh} D={d} ps={ps} "
          f"NP={tables.shape[1]}, {n_pos} positions: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{max(t_bytes, t_ops):.4f} ms ({moved} bytes), max abs err "
          f"{max_err:.3e}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:105",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


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


def serve_phase(torch, np, kernel, ref, card: str) -> int:
    from repro_torch import configs
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.sharding.params import cast_tree, count_params, init_tree

    cfg = configs.get("granite_3_2b")
    t0 = time.perf_counter()
    params = cast_tree(init_tree(registry.decls(cfg), SEED, "cuda"),
                       torch.bfloat16)
    torch.cuda.synchronize()
    print(f"granite-3-2b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{count_params(params)} parameters in bf16, made on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    page_size = 16
    engine = ContinuousBatchingEngine(cfg, params, slots=8, max_len=160,
                                      device="cuda", page_size=page_size,
                                      prefill_chunk=16)
    for rid, prompt, n_new in serve_trace(np):
        assert engine.submit(Request(rid, prompt, n_new))
    torch.cuda.reset_peak_memory_stats()
    decode_ms, steps = [], 0
    kernel.launches = 0
    t0 = time.perf_counter()
    while True:
        before = engine.token_steps
        ts = time.perf_counter()
        if not engine.step():
            break
        dt = time.perf_counter() - ts       # step() ends with the tokens on the host
        steps += 1
        if engine.token_steps - before == 1:
            decode_ms.append(dt * 1e3)
    wall = time.perf_counter() - t0
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

    with mock.patch.object(paged_ops, "paged_attention", checked):
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
    with mock.patch.object(paged_ops, "paged_attention", ref.paged_attention):
        plain = teacher_force(torch, registry, cfg, params, short, page_size,
                              "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def perturbed(*args, **kw):
        o = ref.paged_attention(*args, **kw).float()
        noise = torch.randn(o.shape, generator=gen, device=o.device)
        return (o * (1 + 2.0 ** -9 * noise)).to(args[0].dtype)

    with mock.patch.object(paged_ops, "paged_attention", perturbed):
        noisy = teacher_force(torch, registry, cfg, params, short, page_size,
                              "cuda")
    fmt = lambda d: " ".join(f"{x:.3f}" for x in d.abs().amax(-1).tolist())
    print(f"full-width teacher-forced logits, max abs diff per step: kernel "
          f"vs plain path: {fmt(logits[:16] - plain)}; plain vs plain with "
          f"its attention output perturbed by 2^-9: {fmt(noisy - plain)}")
    profile_phase(torch, np, cfg, params, card)
    return launches


def dev_us(event) -> float:
    """Device time (us) of a profiler event, across torch versions."""
    return (getattr(event, "self_device_time_total", None)
            or event.self_cuda_time_total)


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
    (8 lanes at 100 cached positions) under ``torch.profiler``."""
    from repro_torch.models import registry
    from repro_torch.serve.paged import paged_step_fn

    step = paged_step_fn(cfg)
    pool_k, pool_v = registry.paged_pool_init(cfg, 81, 16, device="cuda")
    args = (np.arange(80, dtype=np.int32).reshape(8, 10),
            np.full((8,), 100, np.int32), np.arange(8, dtype=np.int32),
            np.ones((8,), bool))
    for _ in range(3):
        step(params, pool_k, pool_v, *args).cpu()
    n = 3
    wall_ms, busy_ms, launches, kernels = device_profile(
        torch, lambda: step(params, pool_k, pool_v, *args).cpu(), n)
    paged = [e for e in kernels if "paged_attention_kernel" in e.key]
    top = "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3 / n:.3f} ms"
                    for e in kernels[:5])
    print(f"profile on {card}, one-token step, 8 lanes x 100 positions: "
          f"wall {wall_ms:.3f} ms (under the profiler), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches:.0f} kernel launches per step; paged attention "
          f"{dev_us(paged[0]) / paged[0].count:.2f} us per call x "
          f"{paged[0].count // n} calls; top device time: {top}")


def small_reference_phase(torch, np) -> None:
    """The card's path against the CPU's plain path on a small input: the
    granite smoke config (3 layers, float32 activations, bf16 pool), whose
    greedy margins are checked first. The engine's completions on the card
    equal those on the CPU, and teacher-forced logits agree."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.paged_attention import ops as paged_ops
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
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        eng = ContinuousBatchingEngine(cfg, p, slots=3, max_len=32, device=dev,
                                       page_size=4, prefill_chunk=4)
        for r in reqs:
            eng.submit(Request(*r))
        eng.run_until_idle()
        out[dev] = {r.id: r.tokens for r in eng.completed}
        assert eng.stats()["prompt_tokens_reused"] > 0
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
    with mock.patch.object(paged_ops, "paged_attention", ref.paged_attention):
        want = teacher_force(torch, registry, cfg, p, seq, 4, "cuda")
    err = close(got, want, TOL["bfloat16"])
    print(f"smoke granite on the card vs the CPU's plain path: {len(reqs)} "
          f"completions equal (greedy margin >= {margin:.3f}); teacher-forced "
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
GRANITE_TRAIN = (2, 4096, 32, 8, 64)      # B, S, H, K, D: granite's training shape
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


def flash_inputs(torch, gen, b, s, h, kh, d, dtype):
    mk = lambda n: torch.randn((b, s, n, d), generator=gen,
                               device="cuda").to(dtype)
    return mk(h), mk(kh), mk(kh), mk(h)      # q, k, v, do


def flash_check(torch, fkernel, fref, q, k, v, do, causal, window,
                dtype_name) -> dict:
    """Kernel forward and backward against the plain versions (grouped by
    KV head) on the same inputs, each tensor at :func:`close_scaled`'s
    bound; returns ``{name: (max abs err, scale)}`` for o, lse, dq, dk, dv."""
    o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=causal,
                                              window=window)
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
    o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True)
    ms_fwd = time_ms(torch, lambda i: fkernel.flash_attention_fwd_cuda(
        q, k, v, causal=True), 1, inner=3, reps=7)
    ms_bwd = time_ms(torch, lambda i: fkernel.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal=True), 1, inner=2, reps=5)
    plain_fwd = time_ms(torch, lambda i: grouped(
        torch, lambda *a: fref.flash_attention_ref(*a, causal=True), q, k, v,
        n_out=2), 1, inner=1, reps=3)
    plain_bwd = time_ms(torch, lambda i: grouped(
        torch, lambda *a: fref.flash_attention_bwd_ref(*a, causal=True), q, k, v, o,
        lse, do, n_out=3), 1, inner=1, reps=3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) < (2, 5):
        rep = h // kh
        sdpa_fn = lambda: sdpa(qs, ks.repeat_interleave(rep, 1),
                               vs.repeat_interleave(rep, 1), is_causal=True)
    else:
        sdpa_fn = lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
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
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import registry, transformer
    from repro_torch.sharding.params import cast_tree, count_params, init_tree
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
    params = cast_tree(init_tree(registry.decls(cfg), SEED, "cuda"),
                       torch.bfloat16)
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
    fkernel.launches_fwd = fkernel.launches_bwd = 0
    run = launch_train.main(argv)
    launches_fwd, launches_bwd = fkernel.launches_fwd, fkernel.launches_bwd
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
          f"{peak_gb:.2f} GB; flash launches {launches_fwd} forward = "
          f"{steps} steps x {cfg.n_layers} layers x {accum} microbatches x 2 "
          f"(forward and remat recompute), {launches_bwd} backward; losses "
          f"{' '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{' '.join(f'{x:.4f}' for x in run.grad_norms)}")

    # every attention call of one microbatch against the plain version on
    # that call's own inputs (one KV-head group at a time), at bounds scaled
    # to each tensor (close_scaled): the gradients of this mean loss are
    # orders of magnitude below 1
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

    embed = run.params["embed"].detach().requires_grad_()  # the gradient's way in
    with mock.patch.object(attn_ops, "_forward", checked_fwd), \
            mock.patch.object(attn_ops, "_backward", checked_bwd):
        loss, _ = loss_fn(dict(run.params, embed=embed), mb)
        torch.autograd.grad(loss, [embed])
    # the same microbatch before and after the 4 steps: a learning check
    # free of the batch-to-batch noise of the per-step losses
    assert loss.item() < loss_before, (loss.item(), loss_before)
    print(f"train: loss on the first microbatch {loss_before:.4f} before the "
          f"{steps} steps, {loss.item():.4f} after")
    assert len(errs["fwd"]) == 2 * cfg.n_layers, len(errs["fwd"])
    assert len(errs["bwd"]) == 3 * cfg.n_layers, len(errs["bwd"])
    span = lambda xs: (f"max abs err {max(e for e, _ in xs):.3e}, scales "
                       f"{min(s for _, s in xs):.3e} to "
                       f"{max(s for _, s in xs):.3e}")
    print(f"train: every attention call of one microbatch held to the plain "
          f"version on its own inputs: {len(errs['fwd'])} forward calls, o "
          f"{span(errs['fwd'])} (bound {TOL['bfloat16']} * scale + "
          f"{TOL['bfloat16']} * |plain|; lse {TOL['float32']} + "
          f"{TOL['float32']} * |plain|), {len(errs['bwd']) // 3} backward "
          f"calls, dq/dk/dv {span(errs['bwd'])} (bound "
          f"{GRAD_TOL['bfloat16'][0]} * scale + {GRAD_TOL['bfloat16'][1]} * "
          f"|plain|)")
    del errs
    train_profile(torch, run.train_step, run.params, run.opt_state,
                  run.data.batch_at(steps), card)
    return launches_fwd, launches_bwd


def train_profile(torch, train_step, params, state, batch, card: str) -> None:
    """One train step under ``torch.profiler``: the device's busy share and
    the top device kernels."""
    wall_ms, busy_ms, launches, kernels = device_profile(
        torch, lambda: train_step(params, state, batch))
    top = "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in kernels[:8])
    print(f"train profile on {card}, one step: wall {wall_ms:.1f} ms (under "
          f"the profiler), device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), {launches:.0f} kernel launches; "
          f"top device time: {top}")


def small_train_reference_phase(torch, np) -> None:
    """The card's training path against the CPU's plain path on a small
    input: the granite smoke config in float32, the same params and the
    same numpy batches (attention projections at their true fan-in, which
    keeps the gradients well conditioned in float32), 2 AdamW steps. Loss
    and grad norm agree to 1e-5; AdamW's first steps move each element by
    about lr whatever its gradient's size, so an element whose gradient is
    below float32 noise may step either way: params agree to 2e-6 in all
    but 0.1% of the elements and within 4 lr in every one."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import registry, transformer
    from repro_torch.sharding.params import init_tree, tree_leaves, tree_map
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = dataclasses.replace(configs.smoke("granite_3_2b"), dtype="float32",
                              remat="full")
    params = transformer.true_fan_in(
        init_tree(registry.decls(cfg), SEED, "cpu"), cfg)
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab, size=(2, 2, 2, 97))
    batches = [{"tokens": torch.from_numpy(t[..., :-1]),
                "labels": torch.from_numpy(t[..., 1:])} for t in toks]
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
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pg, pc)])
    # each AdamW step moves an element by at most about lr (|update| <= 1.3
    # lr in the first two steps), so two steps stay within 4 lr
    assert diffs.max().item() <= 4 * tc.lr, diffs.max().item()
    share = (diffs > 2e-6).float().mean().item()
    assert share < 1e-3, share
    print(f"small train reference (smoke granite, float32, 2 steps of 2 x 2 x "
          f"96 tokens) on the card vs the CPU's plain path: losses "
          f"{lg} vs {lc}, grad norms {gg} vs {gc}; params max abs diff "
          f"{diffs.max().item():.3e}, {100 * share:.3f}% of elements above "
          f"2e-6")


# ---------------------------------------------------------------------------
# RG-LRU scan and the hybrid family's serving (the serve driver's path)
# ---------------------------------------------------------------------------

# B, S, W (tests/test_kernels.py:110), then a ragged S and W and one step
RGLRU_CASES = [(2, 64, 32), (1, 128, 128), (3, 32, 64), (2, 200, 48), (1, 1, 3)]
RG_PREFILL = (8, 4096, 2560)              # B, S, W: recurrentgemma's prefill scans
RG_ATTN = (8, 4096, 10, 1, 256, 2048)     # B, S, H, K, D, window: its attention
RG_SERVE = {"batch": 8, "prompt_len": 4096, "steps": 64}


def rglru_inputs(torch, gen, b, s, w):
    """a in [0, 0.95) as a gate's decay, b ~ N(0, 0.5^2), float32."""
    a = torch.rand((b, s, w), generator=gen, device="cuda") * 0.95
    bb = torch.randn((b, s, w), generator=gen, device="cuda") * 0.5
    return a, bb


def rglru_phase(torch, rkernel, rref) -> dict:
    """The CUDA scan against its plain version on the reference's cases, a
    ragged S and W, one step, against float64, and at recurrentgemma-2b's
    prefill shape, each tensor at :func:`close_scaled`'s bound with the
    reference's atol 1e-5; then times kernel and plain version there.
    Returns the kernel's JSON entry (no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    tol = 1e-5                              # tests/test_kernels.py:118
    for case in RGLRU_CASES:
        a, bb = rglru_inputs(torch, gen, *case)
        y, h = rkernel.rglru_scan_cuda(a, bb)
        wy, wh = rref.rglru(a, bb)
        ey, eh = close_scaled(y, wy, tol, tol), close_scaled(h, wh, tol, tol)
        print(f"rglru case B,S,W={case}: max abs err y {ey[0]:.3e}, h_final "
              f"{eh[0]:.3e}; bitwise equal {torch.equal(y, wy)}")
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

    b, s, w = RG_PREFILL
    a, bb = rglru_inputs(torch, gen, b, s, w)
    y, h = rkernel.rglru_scan_cuda(a, bb)
    wy, wh = rref.rglru(a, bb)
    ey, eh = close_scaled(y, wy, tol, tol), close_scaled(h, wh, tol, tol)
    exact = torch.equal(y, wy) and torch.equal(h, wh)
    del wy, wh
    ms = time_ms(torch, lambda i: rkernel.rglru_scan_cuda(a, bb), 1, inner=10,
                 reps=11)
    plain_ms = time_ms(torch, lambda i: rref.rglru(a, bb), 1, inner=1, reps=3)
    moved = 3 * b * s * w * 4 + b * w * 4      # a, b in; y, h_final out
    ops = 2 * b * s * w                        # a multiply and an add a step
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    print(f"rglru at recurrentgemma's prefill shape B={b} S={s} W={w}: max "
          f"abs err y {ey[0]:.3e} (scale {ey[1]:.3e}), h_final {eh[0]:.3e}; "
          f"bitwise equal {exact}; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {max(t_bytes, t_ops):.4f} ms ({moved} bytes); no single "
          f"PyTorch call computes a linear recurrence")
    return {"name": "rglru_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru/kernel.py:46",
            "max_abs_err": max(ey[0], eh[0]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


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


def flash256_phase(torch, fkernel, fref) -> dict:
    """The CUDA flash forward at head dim 256 (MQA, a window) against its
    plain version on a small case in float32 and bfloat16, against float64,
    and at recurrentgemma-2b's prefill shape (B 8, S 4096, H 10, K 1, D 256,
    window 2048, bf16); times kernel, plain version and windowed SDPA
    there. Returns the JSON entry (no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        q, k, v, _ = flash_inputs(torch, gen, 2, 80, 4, 1, 256, dt)
        o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True, window=24)
        wo, wlse = fref.flash_attention_ref(q, k, v, causal=True, window=24)
        eo = close_scaled(o, wo, TOL[name], TOL[name])
        el = close(lse, wlse, TOL["float32"])
        print(f"flash D 256 case B 2, S 80, H 4, K 1, window 24, {name}: max "
              f"abs err o {eo[0]:.3e} (scale {eo[1]:.3e}), lse {el:.3e}")
    q, k, v, _ = flash_inputs(torch, gen, 1, 96, 4, 1, 256, torch.float32)
    o, _ = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True, window=40)
    po, _ = fref.flash_attention_ref(q, k, v, causal=True, window=40)
    eo, _ = fref.flash_attention_ref(q.double(), k.double(), v.double(),
                                     causal=True, window=40)
    e_kernel = (o.double() - eo).abs().max().item()
    e_plain = (po.double() - eo).abs().max().item()
    assert e_kernel <= TOL["float32"], e_kernel
    print(f"flash D 256 against float64 (B 1, S 96, H 4, K 1, window 40): max "
          f"abs err of o: kernel {e_kernel:.3e}, plain {e_plain:.3e}")

    b, s, h, kh, d, win = RG_ATTN
    q, k, v, _ = flash_inputs(torch, gen, b, s, h, kh, d, torch.bfloat16)
    o, lse = fkernel.flash_attention_fwd_cuda(q, k, v, causal=True, window=win)
    plain = lambda: per_row(torch, lambda *x: fref.flash_attention_ref(
        *x, causal=True, window=win), q, k, v)
    wo, wlse = plain()
    eo = close_scaled(o, wo, TOL["bfloat16"], TOL["bfloat16"])
    el = close(lse, wlse, TOL["float32"])
    del wo, wlse
    ms = time_ms(torch, lambda i: fkernel.flash_attention_fwd_cuda(
        q, k, v, causal=True, window=win), 1, inner=3, reps=5)
    plain_ms = time_ms(torch, lambda i: plain(), 1, inner=1, reps=3)
    sdpa_fn, backend = sdpa_windowed(torch, q, k, v, win)
    lib_ms = time_ms(torch, lambda i: sdpa_fn(), 1, inner=3, reps=5)
    pairs = window_pairs(s, win)
    bound, by = flash_bound_ms(b, s, h, kh, d, 2, pairs, False)
    print(f"flash D 256 at recurrentgemma's prefill shape B={b} S={s} H={h} "
          f"K={kh} D={d} window {win} bf16 ({pairs} visible pairs per head): "
          f"max abs err o {eo[0]:.3e} (scale {eo[1]:.3e}), lse {el:.3e}; "
          f"kernel {ms:.3f} ms ({4 * b * h * d * pairs / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.3f} ms (one batch row at a time), "
          f"sdpa with the window as a mask {lib_ms:.3f} ms (backend "
          f"{backend}), bound {bound:.4f} ms ({by})")
    return {"name": "flash_attention_fwd_d256", "route": "cuda",
            "source": "src/repro_torch/kernels/attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/attention/kernel.py:69",
            "max_abs_err": max(eo[0], el), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}


def counted_serve(launch_serve, argv, counts):
    """``launch_serve.main(argv)`` with each prefill and decode call
    recorded as ``(name, launches of each counter during the call)``;
    ``counts`` is a zero-argument function returning the counters."""
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
        run = launch_serve.main(argv)
    return run, calls


def hybrid_serve_phase(torch, np, rkernel, rref, fkernel, fref,
                       card: str) -> tuple[int, int]:
    """Full-width recurrentgemma-2b served by the serve driver
    (``repro_torch.launch.serve``): batch 8, a 4096-token prompt, 64 greedy
    steps, random bf16 weights from the seed. Checks the launch counts of
    every call (18 scans and 8 flash forwards in the prefill, none in a
    decode step), then holds every scan and flash call of one prompt's
    prefill to the plain versions on that call's own inputs, and profiles
    a prefill and a decode step. Returns the run's scan and flash-forward
    launch counts."""
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import griffin, registry

    argv = ["--arch", "recurrentgemma-2b", "--batch", str(RG_SERVE["batch"]),
            "--prompt-len", str(RG_SERVE["prompt_len"]),
            "--steps", str(RG_SERVE["steps"]), "--seed", str(SEED)]
    print(f"hybrid serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    rkernel.launches = fkernel.launches_fwd = 0
    run, calls = counted_serve(launch_serve, argv, lambda: (
        rkernel.launches, fkernel.launches_fwd))
    launches = (rkernel.launches, fkernel.launches_fwd)
    cfg = run.cfg
    n_rec = griffin._pattern(cfg).count("rec")
    n_attn = cfg.n_layers - n_rec
    assert (n_rec, n_attn) == (18, 8)
    assert cfg.param_count() == 2_682_191_360
    assert calls[0] == ("prefill", n_rec, n_attn), calls[0]
    assert calls[1:] == [("decode", 0, 0)] * RG_SERVE["steps"], calls[1:4]
    assert launches == (n_rec, n_attn), launches
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
          f"{launches[0]} scans and {launches[1]} flash forwards in the "
          f"prefill, 0 in each of the {steps} decode steps")

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

    def checked_fwd(q, k, v, causal, window):
        o, lse = kernel_fwd(q, k, v, causal, window)
        wo, wlse = fref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window)
        close(lse, wlse, TOL["float32"])
        errs["flash"].append(close_scaled(o, wo, TOL["bfloat16"],
                                          TOL["bfloat16"]))
        return o, lse

    with mock.patch.object(rglru_ops, "_scan", checked_scan), \
            mock.patch.object(attn_ops, "_forward", checked_fwd), \
            torch.inference_mode():
        one, _ = registry.prefill(run.params, cfg, run.prompt[:1],
                                  max_len=run.serve.max_len)
    assert bool(torch.isfinite(one.float()).all())
    assert (len(errs["scan"]), len(errs["flash"])) == (n_rec, n_attn)
    span = lambda xs: (f"max abs err {max(e for e, _ in xs):.3e}, scales "
                       f"{min(s for _, s in xs):.3e} to "
                       f"{max(s for _, s in xs):.3e}")
    print(f"hybrid serve: every call of one prompt's prefill held to the "
          f"plain version on its own inputs: {n_rec} scans, "
          f"{span(errs['scan'])} (bound 1e-5 * scale + 1e-5 * |plain|); "
          f"{n_attn} flash forwards, o {span(errs['flash'])} (bound "
          f"{TOL['bfloat16']} * scale + {TOL['bfloat16']} * |plain|; lse "
          f"{TOL['float32']} + {TOL['float32']} * |plain|)")
    del errs
    hybrid_profile(torch, run, card)
    return launches


def hybrid_profile(torch, run, card: str, label: str = "hybrid") -> None:
    """One batch-8 prefill and three decode steps of a serve-driver run
    under ``torch.profiler``: device busy share and the top device
    kernels."""
    sv, params = run.serve, run.params
    for name, fn, n in (
            ("prefill", lambda: sv.prefill_fn(params, run.prompt), 1),
            ("decode step", lambda: sv.decode_fn(
                params, run.cache, run.tokens[:, -1:]), 3)):
        fn()
        wall_ms, busy_ms, launches, kernels = device_profile(torch, fn, n)
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
    from repro_torch.sharding.params import cast_tree, init_tree, tree_map

    cfg = configs.smoke("recurrentgemma_2b")
    params = griffin.true_fan_in(
        cast_tree(init_tree(registry.decls(cfg), SEED, "cpu"), torch.bfloat16),
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
SSD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}      # tests/test_kernels.py:83
M2_PREFILL = (8, 4096, 32, 64, 128, 256)   # b, s, h, p, n, chunk: mamba2-370m
M2_SERVE = {"batch": 8, "prompt_len": 4096, "steps": 64}


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


def ssd_bound_ms(b, s, h, p, n, chunk, x_bytes, bc_bytes, bc_bf16, shared):
    """Least time for one call: the larger of its operations at the card's
    peak for their type and its bytes (x, dA, the stored B and C read
    once; y and the state written once) over the memory rate. Operations
    (2 a multiply-add), per chunk of L steps over its L (L + 1) / 2 pairs
    j <= i: the C.B^T scores, 2 n a pair, are products of B and C alone, so
    they run on the bf16 tensor cores when B and C are bf16 (float32
    accumulation, as the plain version computes them), and once for all
    heads when the heads share B and C (``shared``: stride 0); the rest is
    float32 on the CUDA cores per (b, h): the decayed scores' product with
    x (2 p a pair), the C.S^T term and the state update (4 L n p).
    Returns ``(ms, bound_by, float32 ops, score ops, bytes)``."""
    score = f32 = 0
    for t0 in range(0, s, chunk):
        length = min(chunk, s - t0)
        pairs = length * (length + 1) // 2
        score += 2 * pairs * n
        f32 += 2 * pairs * p + 4 * length * n * p
    score *= b * (1 if shared else h)
    f32 *= b * h
    moved = 2 * b * s * h * p * x_bytes + b * s * h * 4 + bc_bytes \
        + b * h * p * n * 4
    t_ops = (f32 / FP32_OPS_PER_S
             + score / (BF16_OPS_PER_S if bc_bf16 else FP32_OPS_PER_S)) * 1e3
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            f32, score, moved)


def ssd_phase(torch, skernel, sref) -> dict:
    """The CUDA SSD chunk scan against its plain version on the
    reference's cases (float32 and bfloat16 x), on ragged S, on B and C
    broadcast over the heads with stride 0, against a float64 oracle, and
    at mamba2-370m's prefill shape; then times kernel and plain version
    there. Returns the kernel's JSON entry (no launches)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for case in SSD_CASES + SSD_RAGGED:
        b, s, h, p, n, chunk = case
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[1]
            x, dA, B, C = ssd_inputs(torch, gen, b, s, h, p, n, x_dtype=dt)
            ey, es = ssd_check(torch, skernel, sref, x, dA, B, C, chunk,
                               SSD_TOL[name])
            print(f"ssd case b,s,h,p,n,chunk={case} x {name}: max abs err y "
                  f"{ey[0]:.3e} (scale {ey[1]:.3e}), state {es[0]:.3e}")
    # the model's inputs: float32 x, bf16 B and C shared by the heads
    x, dA, B, C = ssd_inputs(torch, gen, 2, 520, 8, 64, 128,
                             bc_dtype=torch.bfloat16, heads_share_bc=True)
    assert B.stride(2) == 0
    ey, es = ssd_check(torch, skernel, sref, x, dA, B, C, 256,
                       SSD_TOL["float32"])
    print(f"ssd with bf16 B and C expanded over 8 heads (stride 0), s 520, "
          f"chunk 256: max abs err y {ey[0]:.3e} (scale {ey[1]:.3e}), state "
          f"{es[0]:.3e}")

    # float64 yardstick at one small shape: both float32 versions against it
    x, dA, B, C = ssd_inputs(torch, gen, 2, 200, 4, 32, 64)
    y, st = skernel.ssd_cuda(x, dA, B, C, chunk=64)
    py, pst = sref.ssd_chunked(x, dA, B, C, chunk=64)
    ey, est = sref.ssd_ref(*(t.double() for t in (x, dA, B, C)))
    err = lambda a, b: max((a[0].double() - b[0]).abs().max().item(),
                           (a[1].double() - b[1]).abs().max().item())
    e_kernel, e_plain = err((y, st), (ey, est)), err((py, pst), (ey, est))
    assert e_kernel <= SSD_TOL["float32"], e_kernel
    print(f"ssd against float64 (b 2, s 200, h 4, p 32, n 64, chunk 64): max "
          f"abs err of y and state: kernel {e_kernel:.3e}, plain "
          f"{e_plain:.3e}")

    # mamba2-370m's prefill shape with the model's dtypes and dA of its size
    b, s, h, p, n, chunk = M2_PREFILL
    x, _, B, C = ssd_inputs(torch, gen, b, s, h, p, n,
                            bc_dtype=torch.bfloat16, heads_share_bc=True)
    # dt = softplus(N(0, 1)) and A = -1: the reference init's decay
    dA = -torch.nn.functional.softplus(torch.randn(
        (b, s, h), generator=gen, device="cuda"))
    ey, es = ssd_check(torch, skernel, sref, x, dA, B, C, chunk,
                       SSD_TOL["float32"], f64=True)
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
    bound, by, f32_ops, score_ops, moved = ssd_bound_ms(
        b, s, h, p, n, chunk, 4, bc_bytes, B.dtype == torch.bfloat16,
        B.stride(2) == 0)
    ops = f32_ops + score_ops
    print(f"ssd at mamba2-370m's prefill shape b={b} s={s} h={h} p={p} n={n} "
          f"chunk {chunk} (x float32, B and C bf16 shared by the heads): "
          f"against the plain version in float64, max abs err y {ey[0]:.3e} "
          f"(scale {ey[1]:.3e}), state {es[0]:.3e} (the float32 plain "
          f"version's y: {e_plain:.3e}); "
          f"kernel {ms:.3f} ms ({ops / ms / 1e9:.1f} TFLOP/s), plain "
          f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({by}; {f32_ops:.4e} "
          f"float32 operations at {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s, "
          f"{score_ops:.4e} bf16 C.B^T score operations, once for all heads, "
          f"at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s; {moved} bytes); no "
          f"single PyTorch call computes the SSD scan")
    return {"name": "ssd", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd/csrc/ssd_chunk_scan.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:67",
            "max_abs_err": max(ey[0], es[0]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def mamba2_serve_phase(torch, np, skernel, sref, card: str) -> int:
    """Full-width mamba2-370m served by the serve driver
    (``repro_torch.launch.serve``): batch 8, a 4096-token prompt, 64 greedy
    steps, random bf16 weights from the seed. Checks the launch counts of
    every call (48 SSD scans in the prefill, none in a decode step), then
    holds every SSD call of one prompt's prefill to the plain version on
    that call's own inputs, and profiles a prefill and a decode step.
    Returns the run's SSD launch count."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import registry

    argv = ["--arch", "mamba2-370m", "--batch", str(M2_SERVE["batch"]),
            "--prompt-len", str(M2_SERVE["prompt_len"]),
            "--steps", str(M2_SERVE["steps"]), "--seed", str(SEED)]
    print(f"mamba2 serve: python -m repro_torch.launch.serve {' '.join(argv)}",
          flush=True)
    skernel.launches = 0
    run, calls = counted_serve(launch_serve, argv, lambda: (skernel.launches,))
    launches = skernel.launches
    cfg = run.cfg
    b, steps = M2_SERVE["batch"], M2_SERVE["steps"]
    assert cfg.n_layers == 48 and cfg.param_count() == 368_227_840
    assert calls[0] == ("prefill", cfg.n_layers), calls[0]
    assert calls[1:] == [("decode", 0)] * steps, calls[1:4]
    assert launches == cfg.n_layers, launches
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
          f"tokens/s; peak memory {run.peak_bytes / 1e9:.2f} GB; launches "
          f"{launches} SSD scans in the prefill, 0 in each of the {steps} "
          f"decode steps")

    # every SSD call of one prompt's prefill against the plain version on
    # that call's own inputs, computed in float64 (see ssd_check); the
    # float32 plain version's own error is printed beside it
    errs, plain_errs, kernel_scan = [], [], ssd_ops._scan

    def checked_scan(x, dA, B, C, chunk):
        y, st = kernel_scan(x, dA, B, C, chunk)
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
          f"plain version in float64 on its own inputs: {len(errs)} calls, "
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
    from repro_torch.sharding.params import cast_tree, init_tree, tree_map

    cfg = configs.smoke("mamba2_370m")
    params = cast_tree(init_tree(registry.decls(cfg), SEED, "cpu"),
                       torch.bfloat16)
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
    build_all(kernel, fkernel, rkernel, skernel)

    paged = kernel_phase(torch, kernel, ref)
    paged["launches"] = serve_phase(torch, np, kernel, ref, card)
    small_reference_phase(torch, np)
    argmax_tie(torch)
    torch.cuda.empty_cache()
    fwd, bwd = flash_phase(torch, fkernel, fref)
    torch.cuda.empty_cache()
    fwd["launches"], bwd["launches"] = train_phase(torch, np, fkernel, fref,
                                                   card)
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
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [paged, fwd, bwd, scan, fwd256, ssd]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
