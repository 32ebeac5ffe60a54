"""Serving entry point of the port: batched prefill, then greedy decode.

  python -m repro_torch.launch.serve --arch recurrentgemma-2b --batch 8 \\
      --prompt-len 4096 --steps 64
  python -m repro_torch.launch.serve --arch recurrentgemma-2b --smoke \\
      --device cpu --batch 2 --prompt-len 32 --steps 8
  python -m repro_torch.launch.serve --arch mamba2-370m --batch 8 \\
      --prompt-len 4096 --steps 64
  python -m repro_torch.launch.serve --arch granite-3-2b --batch 8 \\
      --prompt-len 1024 --steps 64
  python -m repro_torch.launch.serve --arch grok-1-314b --smoke \\
      --device cpu --batch 2 --prompt-len 16 --steps 4
  python -m repro_torch.launch.serve --arch musicgen-large --batch 8 \\
      --prompt-len 512 --steps 64

Port of ``src/repro/launch/serve.py`` on one device, through
:func:`repro_torch.serve.engine.build_serve`, for the families the serve
driver runs (every family). Runs on the card unless ``--device cpu`` is
given; without a card and without ``--device`` it raises. Random weights
drawn straight in bf16 (``init_tree``) and a random prompt (a
``torch.Generator``), both from ``--seed`` and made on the device: tokens,
or for the audio and VLM stubs (musicgen-large, internvl2-76b), whose
inputs are embeddings, standard-normal bf16 embeddings ``(batch,
prompt_len, d_model)``, as the reference draws them
(``src/repro/launch/serve.py:53-59``); decode runs on tokens. Greedy
decoding takes ``torch.argmax`` (the first maximal index).
Prints the prefill time, the decode tokens/s and the peak device memory.
:func:`run` is the same driver for a config object (full-width grok-1 does
not fit one card at its 64 layers; ``chip_smoke.py`` serves it at 4 with
``dataclasses.replace``). Not ported: the reference's energy estimate (a
model of a TPU's energy) and ``--production-mesh`` (the tensor-parallel
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
from repro_torch.sharding.params import init_tree


@dataclasses.dataclass
class ServeRun:
    """What a run leaves: the model, the prompt (tokens, or embeddings for
    the audio and VLM stubs), the last logits and cache, the generated
    tokens ``(B, steps)``, the prefill's seconds and each
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


def run(cfg: ModelConfig, batch: int, prompt_len: int, steps: int,
        seed: int = 0, max_len: int | None = None, device=None) -> ServeRun:
    """Serve ``cfg`` once: draw its weights and a prompt of ``(batch,
    prompt_len)`` tokens (or embeddings of ``d_model``) from ``seed``,
    prefill, then ``steps`` greedy
    decode steps; print one line and return the :class:`ServeRun`.
    ``max_len`` defaults to ``prompt_len + steps``; ``device=None`` is the
    card (raises without one)."""
    dev = device_mod.resolve(device)
    max_len = max_len or (prompt_len + steps)
    sv = build_serve(cfg, batch, max_len, prefill_len=prompt_len, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_tree(registry.decls(cfg), seed, dev, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if registry.uses_token_inputs(cfg):
        prompt = torch.randint(0, cfg.vocab, (batch, prompt_len),
                               generator=gen, device=dev)
    else:
        prompt = torch.randn((batch, prompt_len, cfg.d_model), generator=gen,
                             device=dev).to(torch.bfloat16)

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
    for _ in range(steps):
        ts = time.perf_counter()
        outs.append(tok)
        logits, cache = sv.decode_fn(params, cache, tok)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)                   # each step's time ends on the device
        decode_s.append(time.perf_counter() - ts)
    on_complete(outs)
    tokens = (torch.cat(outs, dim=1) if outs
              else torch.zeros((batch, 0), dtype=torch.long, device=dev))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    toks, dt = batch * steps, sum(decode_s)
    rate = f"{toks / dt:.1f} tok/s" if dt > 0 else "no decode steps"
    mem = (f"peak device memory {peak / 1e9:.2f} GB" if peak is not None
           else "peak device memory not measured (cpu)")
    what = "tokens" if registry.uses_token_inputs(cfg) else "embeddings"
    print(f"{cfg.name} on {dev}: prefill {batch} x {prompt_len} "
          f"{what} in {prefill_s:.3f}s; decoded {toks} tokens in {dt:.3f}s "
          f"({rate}); {mem}", flush=True)
    assert done["flag"], "completion interrupt not fired"
    return ServeRun(cfg, params, sv, prompt, logits, cache, tokens, prefill_s,
                    decode_s, peak)


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

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    return run(cfg, args.batch, args.prompt_len, args.steps, seed=args.seed,
               max_len=args.max_len, device=args.device)


if __name__ == "__main__":
    main()
