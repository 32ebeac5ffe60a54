#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for CUDA;
imports nothing of JAX or of the JAX package ``src/repro``. In order:

1. prints the card (``nvidia-smi`` name and power limit) and the versions;
2. builds the paged-attention kernel from ``src/repro_torch/kernels/
   paged_attention/csrc`` (reused when already built) and prints the
   compiler's resource report;
3. kernel phase: holds the CUDA kernel against its plain PyTorch version on
   the card, on the reference's test cases in float32 and bfloat16 and at
   granite-3-2b's decode shape (8 slots, 32 query / 8 KV heads, head dim 64,
   16-token pages, ragged lengths up to 1024, bf16 pool, with and without a
   ring-table window), then times kernel, plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
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
6. checks that ``torch.argmax`` on the card takes the first maximal index.

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


def close(got, want, tol: float) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        raise AssertionError(f"max abs err {err.max().item():.3e} over "
                             f"tolerance {tol} + {tol} * |want|")
    return err.max().item()


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


def profile_phase(torch, np, cfg, params, card: str) -> None:
    """Where a decode step's time goes: three engine-shaped one-token steps
    (8 lanes at 100 cached positions) under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(params, pool_k, pool_v, *args).cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    paged = [e for e in kernels if "paged_attention_kernel" in e.key]
    top = "; ".join(f"{e.key[:40]} {dev_us(e) / 1e3 / n:.3f} ms"
                    for e in kernels[:5])
    print(f"profile on {card}, one-token step, 8 lanes x 100 positions: "
          f"wall {wall_ms:.3f} ms (under the profiler), device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"{launches / n:.0f} kernel launches per step; paged attention "
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.paged_attention import kernel, ref

    torch.backends.cuda.matmul.allow_tf32 = False   # float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = kernel.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip())

    entry = kernel_phase(torch, kernel, ref)
    entry["launches"] = serve_phase(torch, np, kernel, ref, card)
    small_reference_phase(torch, np)
    argmax_tie(torch)
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
