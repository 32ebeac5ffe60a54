"""The models reach their kernels through the XAIF registry.

Every kernel call of a model path dispatches by op name and impl key
(``REGISTRY.dispatch``), the key coming from the config's ``attn_impl``,
``scan_impl`` or ``moe_impl`` (``repro_torch.models.layers.impl_key``), as
the reference's models dispatch. A probe accelerator
(``chip_smoke.probe_accelerators``) registered under a new key, wrapping the
``"cuda"`` one and counting its calls, receives every attention,
``moe_ffn``, ``rglru``, ``ssd`` and paged-attention call of one smoke
step of each family, with outputs bit for bit those of ``"cuda"``, and no
model code names it. An unregistered key raises the registry's
``KeyError``; the reference's backend names are the port's one backend.
Runs on the CPU (the ``"cuda"`` accelerators' plain versions), no JAX.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = configs = registry = L = init_tree = trainer = cs = None
REGISTRY = tree_map = tree_leaves = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, registry, L, init_tree, trainer, cs, REGISTRY
    global tree_map, tree_leaves
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.core.xaif import REGISTRY
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.sharding.params import init_tree, tree_leaves, tree_map
    from repro_torch.train import trainer
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.set_num_threads(1)


def _cfg(arch, impl):
    return dataclasses.replace(configs.smoke(arch), dtype="float32",
                               attn_impl=impl, scan_impl=impl, moe_impl=impl)


def _params(arch):
    return init_tree(registry.decls(configs.smoke(arch)), 0, "cpu")


def _tokens(cfg, shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape))


def _train_step(arch, impl, params):
    """One AdamW step of 2 microbatches; returns the loss, the grad norm and
    the updated params."""
    cfg = _cfg(arch, impl)
    params = tree_map(torch.clone, params)      # the step writes in place
    tc = trainer.TrainConfig(accum=2)
    step, opt = trainer.make_train_step(cfg, tc)
    toks = _tokens(cfg, (2, 2, 17), seed=1)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    params, _, m = step(params, opt.init(params), batch)
    return m["loss"], m["grad_norm"], params


def _leaves_equal(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


# (arch, expected calls of one step of 2 microbatches: each layer's op once
# a microbatch, the backward inside the op's autograd function; the smoke
# configs: granite 3 layers, recurrentgemma 5 (rec rec attn rec rec),
# mamba2 2)
TRAIN = [("granite_3_2b", {"attention": 2 * 3}),
         ("recurrentgemma_2b", {"attention": 2 * 1, "rglru": 2 * 4}),
         ("mamba2_370m", {"ssd": 2 * 2})]


@pytest.mark.parametrize("arch,want", TRAIN, ids=[a for a, _ in TRAIN])
def test_probe_receives_every_call_of_a_train_step(arch, want):
    cfg = configs.smoke(arch)
    assert cfg.n_layers == {"granite_3_2b": 3, "recurrentgemma_2b": 5,
                            "mamba2_370m": 2}[arch]
    params = _params(arch)
    base = _train_step(arch, "cuda", params)
    with cs.probe_accelerators("probe") as counts:
        got = _train_step(arch, "probe", params)
    assert {op: n for op, n in counts.items() if n} == want
    assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
    assert _leaves_equal(got[2], base[2])


def test_probe_receives_every_moe_and_attention_call_of_a_prefill():
    """grok-smoke's prefill and decode steps on the serve driver: every
    layer's attention and expert FFN; llama4-smoke's MoE layers on lanes
    (``moe_lanes``) and the dense oracle (``moe_dense_ref``)."""
    params = _params("grok_1_314b")
    out = {}
    for impl in ("cuda", "probe2"):
        cfg = _cfg("grok_1_314b", impl)
        toks = _tokens(cfg, (2, 8))
        with cs.probe_accelerators("probe2") as counts:
            logits, cache = registry.prefill(params, cfg, toks, max_len=10)
            step, _ = registry.decode_step(params, cfg, cache, toks[:, :1])
        out[impl] = (logits, step, dict(counts))
    n = configs.smoke("grok_1_314b").n_layers
    assert out["probe2"][2] == {"attention": n, "moe_ffn": 2 * n, "rglru": 0,
                                "ssd": 0, "paged_attention": 0}
    assert out["cuda"][2] == dict.fromkeys(cs.XAIF_OPS, 0)
    assert torch.equal(out["cuda"][0], out["probe2"][0])
    assert torch.equal(out["cuda"][1], out["probe2"][1])
    cfg = _cfg("llama4_maverick_400b", "probe3")
    params = _params("llama4_maverick_400b")
    x = torch.randn(3, 1, cfg.d_model)
    lp = params["blocks"]["l1"]["moe"]
    lp = {k: (v[0] if isinstance(v, torch.Tensor) else
              {kk: vv[0] for kk, vv in v.items()}) for k, v in lp.items()}
    with cs.probe_accelerators("probe3", ("moe_ffn",)) as counts:
        a = L.moe_lanes(x, lp, n_exp=cfg.moe_experts, top_k=cfg.moe_top_k,
                        kind=cfg.mlp_type, impl="probe3")
        b = L.moe_dense_ref(x, lp, n_exp=cfg.moe_experts, top_k=cfg.moe_top_k,
                            kind=cfg.mlp_type, impl="probe3")
    assert counts == {"moe_ffn": 2}
    assert torch.equal(a, L.moe_lanes(x, lp, n_exp=cfg.moe_experts,
                                      top_k=cfg.moe_top_k, kind=cfg.mlp_type))
    assert torch.equal(b, L.moe_dense_ref(x, lp, n_exp=cfg.moe_experts,
                                          top_k=cfg.moe_top_k,
                                          kind=cfg.mlp_type))


def test_probe_receives_every_paged_call_of_the_engine():
    """The engine's paged backend: one paged-attention call a layer and
    one-token step, tokens bit for bit the ``"cuda"`` run's."""
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    out = {}
    for impl in ("cuda", "probe4"):
        cfg = _cfg("internvl2_76b", impl)
        params = _params("internvl2_76b")
        with cs.probe_accelerators("probe4") as counts:
            eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=24,
                                           device="cpu")
            for i in range(3):
                eng.submit(Request(f"r{i}", [(5 * i + j) % cfg.vocab
                                             for j in range(6)], 4))
            eng.run_until_idle()
        out[impl] = ({r.id: r.tokens for r in eng.completed}, dict(counts),
                     eng.stats()["token_steps"])
    toks, counts, steps = out["probe4"]
    assert toks == out["cuda"][0] and len(toks) == 3
    assert counts["paged_attention"] == steps * cfg.n_layers > 0
    assert sum(counts.values()) == counts["paged_attention"]


def test_unregistered_key_raises_and_reference_names_are_cuda():
    for impl in ("ref", "chunked", "pallas", "cuda"):
        assert L.impl_key(impl) == "cuda"
    assert L.impl_key("my_accelerator") == "my_accelerator"
    params = _params("granite_3_2b")
    toks = _tokens(configs.smoke("granite_3_2b"), (1, 6))
    want, _ = registry.forward(params, _cfg("granite_3_2b", "cuda"), toks)
    for impl in ("ref", "chunked", "pallas"):
        got, _ = registry.forward(params, _cfg("granite_3_2b", impl), toks)
        assert torch.equal(got, want)
    with pytest.raises(KeyError, match="no accelerator for op='attention'"):
        registry.forward(params, _cfg("granite_3_2b", "nowhere"), toks)
    m2 = _params("mamba2_370m")
    with pytest.raises(KeyError, match="op='ssd'"):
        registry.forward(m2, _cfg("mamba2_370m", "nowhere"),
                         _tokens(configs.smoke("mamba2_370m"), (1, 6)))


def test_probe_unplugs_cleanly():
    with cs.probe_accelerators("probe5"):
        assert all("probe5" in REGISTRY.impls(op) for op in cs.XAIF_OPS)
    assert all(REGISTRY.impls(op) == ["cuda"] for op in cs.XAIF_OPS)
    with pytest.raises(KeyError):
        REGISTRY.unregister("attention", "probe5")
