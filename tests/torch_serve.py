"""Shared set-up of the port's serving-stack tests against the JAX package.

``tests/test_torch_window.py``, ``tests/test_torch_cluster.py`` and
``tests/test_torch_chaos.py`` serve the same traces on the JAX package's
engines (sync dispatch) and on the port's, on the smoke configs in float32
with the JAX package's weights carried across and the embedding x 10 (as
``tests/test_torch_engine.py`` sets them up: logits of O(1), so greedy
margins are well above rounding).

Schedules (steps, stalls, sheds, preemptions, recycles, simulated times)
depend on lengths and the clock, never on token values, so the tests hold
them equal exactly. Tokens are held equal up to each request's first step
whose greedy margin (sampled: the margin of the sampler's scores under the
request's key) is not clear of the two packages' difference, teacher-forced
through both packages' lane decode (:func:`clear_prefix`), and at least
half of all emitted steps must get there.

Nothing here imports torch or the port when it is imported: pytest's
workers collect every test file, and a worker that has loaded torch runs
the JAX package's async-dispatch tests under other thread timing. The
functions import them when they run.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.sharding import params as JP

_WEIGHTS: dict = {}
_JSTEPS: dict = {}


def weights(arch: str = "granite_3_2b", *, seed: int = 0,
            window: int | None = None):
    """(jax cfg, jax params, port cfg, port params) of ``arch``'s smoke
    config in float32, the JAX package's init from key ``seed`` with the
    embedding x 10, the port's params on the CPU. ``window`` replaces the
    config's ``sliding_window`` (and its name); the weights do not change,
    since a window changes attention masking, never parameter shapes."""
    key = (arch, seed, window)
    if key not in _WEIGHTS:
        from repro_torch import configs
        from repro_torch.bridge import params_from_numpy

        jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype="float32")
        cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
        if window is not None:
            name = f"{jcfg.name}-swa{window}"
            jcfg = dataclasses.replace(jcfg, sliding_window=window, name=name)
            cfg = dataclasses.replace(cfg, sliding_window=window, name=name)
        base = weights(arch, seed=seed)[1] if window is not None else None
        if base is None:
            base = JP.init_tree(jreg.decls(jcfg), jax.random.key(seed))
            base["embed"] = base["embed"] * 10.0
        _WEIGHTS[key] = (jcfg, base, cfg,
                         params_from_numpy(jax.tree.map(np.asarray, base),
                                           "cpu"))
    return _WEIGHTS[key]


def tokens_of(eng_or_report) -> dict:
    """``{request_id: token tuple}`` over ``completed`` of an engine or a
    ``SimReport``."""
    return {r.id: tuple(r.tokens) for r in eng_or_report.completed}


def forced_logits(model, seq, max_len: int):
    """(steps, vocab) logits of ``seq`` teacher-forced through a batch-1
    lane cache of ``max_len`` positions in each package (JAX's, the
    port's); step t predicts ``seq[t + 1]``. A windowed config's lane cache
    is the ring its paged engine equals bit for bit."""
    import torch
    from repro_torch.models import registry

    jcfg, jparams, cfg, params = model
    if jcfg not in _JSTEPS:
        _JSTEPS[jcfg] = jax.jit(
            lambda p, c, t: jreg.decode_step(p, jcfg, c, t))
    jstep = _JSTEPS[jcfg]
    jcache = jreg.cache_init(jcfg, 1, max_len)
    cache = registry.cache_init(cfg, 1, max_len, device="cpu", lanes=True)
    want, got = [], []
    for tok in seq[:-1]:
        jl, jcache = jstep(jparams, jcache, jnp.asarray([[tok]], jnp.int32))
        want.append(np.asarray(jl[0], np.float32))
        with torch.inference_mode():
            logits, _ = registry.decode_step(params, cfg, cache,
                                             torch.tensor([[tok]]))
        got.append(logits[0].float().numpy())
    return np.stack(want), np.stack(got)


def clear_prefix(model, prompt, tokens, sampling, max_len: int) -> int:
    """How many of a request's emitted steps, from the first, have a margin
    clear of the two packages' difference: the top-2 gap of the logits
    (greedy) or of the sampler's scores under the request's key chain
    (``sampling`` = (temperature, top_k, top_p, seed)) above twice the
    step's largest difference plus an ulp, the filters keeping the same
    tokens in both packages."""
    import torch
    from repro_torch.serve import sampling as S

    w, g = forced_logits(model, list(prompt) + list(tokens), max_len)
    w, g = w[len(prompt) - 1:], g[len(prompt) - 1:]
    key = S.seed_key(sampling[3] if sampling else 0)[None]
    for t in range(len(tokens)):
        carry, use = S.split_keys(key)
        key = carry
        if sampling is None:
            zw, zg = w[t], g[t]
        else:
            zw, zg = (S.scores(torch.from_numpy(x[None]), use, *sampling[:3])
                      [0].numpy() for x in (w[t], g[t]))
            if not (np.isfinite(zw) == np.isfinite(zg)).all():
                return t
        live = np.isfinite(zw)
        top2 = np.sort(zw[live])[-2:]
        gap = np.abs(zg[live] - zw[live]).max()
        ulp = np.spacing(np.float32(max(abs(top2[1]), 1.0)))
        if not top2[1] - top2[0] > 2 * gap + ulp:
            return t
    return len(tokens)


def hold_tokens(model, want_engine, got: dict, max_len: int) -> None:
    """Every request the JAX engine ``want_engine`` completed is in ``got``
    (``{id: tokens}``) with equal tokens up to its first step whose margin
    is not clear (:func:`clear_prefix`), and at least half of all emitted
    steps are clear."""
    clear = emitted = 0
    for req in want_engine.completed:
        sp = req.sampling.astuple() if req.sampling is not None else None
        want = tuple(req.tokens)
        k = clear_prefix(model, req.prompt, want, sp, max_len)
        assert got[req.id][:k] == want[:k], (req.id, k, got[req.id], want)
        clear, emitted = clear + k, emitted + len(want)
    assert clear >= emitted // 2, (clear, emitted)
