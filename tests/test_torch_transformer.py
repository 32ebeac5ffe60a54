"""Teacher-forced paged decode: the port against ``repro.models.registry``.

The same weights (made by the JAX package, bridged with
``repro_torch.bridge``) and the same token stream go through both packages'
``decode_step_paged`` for 8 steps, on three lanes with ragged lengths: the
lanes join at steps 0, 2 and 5 and ride the batch idle (append masked,
logits ignored) before that. Logits of the active lanes are compared at
every step, on four smoke configs: granite (GQA), stablelm (MHA), nemotron
(squared ReLU) and musicgen (sinusoidal positions, tanh-gelu).

Tolerances: float32 (float32 pool) 2e-5: the frameworks differ only in
summation order, which through a few layers and the LM head stays well
inside it. bfloat16 (bf16 pool, the serving setting) 6e-2: each framework
rounds its bf16 intermediates at other places (XLA keeps fused elementwise
chains in float32), so the residual stream drifts by a few bf16 ulps; the
logits are O(1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.sharding import params as JP

torch = configs = params_from_numpy = registry = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, params_from_numpy, registry
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import registry
    torch.set_num_threads(1)


TOL = {"float32": 2e-5, "bfloat16": 6e-2}
ARCHS = ["granite_3_2b", "stablelm_3b", "nemotron_4_15b", "musicgen_large"]
STEPS, PS, JOIN = 8, 4, (0, 2, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_match_jax(arch, dtype):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    jparams = JP.init_tree(jreg.decls(jcfg), jax.random.key(1))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    rng = np.random.default_rng(7)
    b = len(JOIN)
    n_pages = -(-STEPS // PS)
    tables = rng.permutation(b * n_pages).reshape(b, n_pages).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, size=(STEPS, b)).astype(np.int32)
    shape = (cfg.n_layers, b * n_pages + 1, PS, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    pool_dtype = {"float32": (jnp.float32, torch.float32),
                  "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jk = jv = jnp.zeros(shape, pool_dtype[0])
    tk, tv = (torch.zeros(shape, dtype=pool_dtype[1]) for _ in range(2))
    step = jax.jit(lambda p, pk, pv, t, ln, tok, m: jreg.decode_step_paged(
        p, jcfg, pk, pv, t, ln, tok, append_mask=m))

    for t in range(STEPS):
        mask = np.array([t >= j for j in JOIN])
        lengths = np.array([max(0, t - j) for j in JOIN], np.int32)
        want, jk, jv = step(jparams, jk, jv, tables, lengths, tokens[t], mask)
        got, tk2, tv2 = registry.decode_step_paged(
            params, cfg, tk, tv, torch.from_numpy(tables),
            torch.from_numpy(lengths), torch.from_numpy(tokens[t]),
            append_mask=torch.from_numpy(mask))
        assert tk2 is tk and tv2 is tv              # the pool is written in place
        assert got.shape == (b, cfg.padded_vocab)
        np.testing.assert_allclose(
            got.float().numpy()[mask], np.asarray(want, np.float32)[mask],
            atol=TOL[dtype], rtol=TOL[dtype], err_msg=f"{arch} step {t}")


def test_unported_families_raise():
    for arch in ("mamba2_370m", "grok_1_314b", "internvl2_76b"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            registry.decls(configs.smoke(arch))


def test_full_width_granite_param_count():
    cfg = configs.get("granite_3_2b")
    assert cfg.param_count() == 2_533_531_648
    assert cfg.param_count() == jconfigs.get("granite_3_2b").param_count()
