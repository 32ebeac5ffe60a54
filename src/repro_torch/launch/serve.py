"""Serving entry point of the port: batched prefill, then greedy decode.

  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 8 \\
      --prompt-len 4096 --steps 64
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke \\
      --device cpu --batch 2 --prompt-len 32 --steps 8
  python -m repro_torch.launch.serve --arch mamba2-370m --batch 8 \\
      --prompt-len 4096 --steps 64

Port of ``src/repro/launch/serve.py`` on one device, through
:func:`repro_torch.serve.engine.build_serve`, for the families the serve
driver runs (hybrid and SSM). Runs on the card unless
``--device cpu`` is given; without a card and without ``--device`` it
raises. Random bf16 weights (``init_tree``) and a random prompt (a
``torch.Generator``), both from ``--seed`` and made on the device; greedy
decoding takes ``torch.argmax`` (the first maximal index). Prints the
prefill time, the decode tokens/s and the peak device memory. Not ported:
the reference's energy estimate (a model of a TPU's energy; energy comes
with the platform slice) and ``--production-mesh`` (the tensor-parallel
slice).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import Serve, build_serve
from repro_torch.sharding.params import cast_tree, init_tree


@dataclasses.dataclass
class ServeRun:
    """What a run leaves: the model, the prompt, the last logits and cache,
    the generated tokens ``(B, steps)``, the prefill's seconds and each
    decode step's, and the peak device memory (bytes; ``None`` on the
    CPU)."""
    cfg: ModelConfig
    params: Any
    serve: Serve
    prompt: torch.Tensor
    logits: torch.Tensor
    cache: Any
    tokens: torch.Tensor
    prefill_s: float
    decode_s: list[float]
    peak_bytes: int | None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    max_len = args.max_len or (args.prompt_len + args.steps)
    sv = build_serve(cfg, args.batch, max_len, prefill_len=args.prompt_len,
                     device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = cast_tree(init_tree(registry.decls(cfg), args.seed, dev),
                       torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)

    done = {"flag": False}

    def on_complete(_):
        done["flag"] = True   # XAIF-style completion interrupt

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = sv.prefill_fn(params, prompt)
    tok = torch.argmax(logits, -1)[:, None]
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    outs, decode_s = [], []
    for _ in range(args.steps):
        ts = time.perf_counter()
        outs.append(tok)
        logits, cache = sv.decode_fn(params, cache, tok)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)                   # each step's time ends on the device
        decode_s.append(time.perf_counter() - ts)
    on_complete(outs)
    tokens = (torch.cat(outs, dim=1) if outs
              else torch.zeros((args.batch, 0), dtype=torch.long, device=dev))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    toks, dt = args.batch * args.steps, sum(decode_s)
    rate = f"{toks / dt:.1f} tok/s" if dt > 0 else "no decode steps"
    mem = (f"peak device memory {peak / 1e9:.2f} GB" if peak is not None
           else "peak device memory not measured (cpu)")
    print(f"{cfg.name} on {dev}: prefill {args.batch} x {args.prompt_len} "
          f"tokens in {prefill_s:.3f}s; decoded {toks} tokens in {dt:.3f}s "
          f"({rate}); {mem}", flush=True)
    assert done["flag"], "completion interrupt not fired"
    return ServeRun(cfg, params, sv, prompt, logits, cache, tokens, prefill_s,
                    decode_s, peak)


if __name__ == "__main__":
    main()
