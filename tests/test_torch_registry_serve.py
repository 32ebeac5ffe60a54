"""Registry-wide serving on the port: every config admits and completes.

Port of ``tests/test_registry_serve.py`` on the port's
``ContinuousBatchingEngine`` and ``Simulator`` (fake clock), on the CPU:
every architecture of :mod:`repro_torch.configs` (dense transformers,
SWA, the modality stubs MusicGen and InternVL2, which the engine serves by
tokens, MoE, Mamba-2 and Griffin) at smoke shapes, on the backend
:func:`repro_torch.models.registry.supports_paged` selects for it:

* admission and completion on the default backend, greedy and sampled,
  with the journal closing every record;
* paged and lanes bit for bit for every paged-capable config;
* same-seed determinism on the lane backends (SSM, hybrid, MoE).

The reference's ``1 <= tok <= vocab`` is wrong at both ends (a token is
an index into the vocabulary, and token 0 is a valid draw; llama4's smoke
config fails it in the JAX package's own run). Here every emitted token
must lie in ``[0, vocab)``. The prompts are ``(7 i + j) % vocab``, inside
every smoke vocabulary (the reference's ``% 251 + 1`` passes MusicGen's
vocabulary of 64, which JAX's gather clamps and PyTorch's refuses).

The split of ``tests/test_registry_serve.py`` is kept: one architecture a
family (and MoE) in the fast tier, the long tail marked ``slow``, which
the full tier runs.
"""

import pytest

torch = configs = registry = init_tree = None
ContinuousBatchingEngine = Request = SamplingParams = None
FakeClock = Simulator = burst_trace = None  # bound by _port

ARCHS = ("h2o_danube3_4b", "stablelm_3b", "granite_3_2b", "nemotron_4_15b",
         "musicgen_large", "internvl2_76b", "grok_1_314b",
         "llama4_maverick_400b", "mamba2_370m", "recurrentgemma_2b")
# one arch a family (+MoE) in the fast tier, as the reference's
_FAST = {"granite_3_2b", "mamba2_370m", "recurrentgemma_2b", "grok_1_314b",
         "internvl2_76b"}
# whether supports_paged is True, per arch (the reference's selection)
_PAGED = {"h2o_danube3_4b", "stablelm_3b", "granite_3_2b", "nemotron_4_15b",
          "musicgen_large", "internvl2_76b"}


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, configs, registry, init_tree, ContinuousBatchingEngine
    global Request, SamplingParams, FakeClock, Simulator, burst_trace
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.serve.engine import ContinuousBatchingEngine, Request
    from repro_torch.serve.sampling import SamplingParams
    from repro_torch.serve.sim import FakeClock, Simulator, burst_trace
    from repro_torch.sharding.params import init_tree
    torch.set_num_threads(1)


def _tiered(names):
    return [a if a in _FAST else pytest.param(a, marks=pytest.mark.slow)
            for a in names]


_PARAMS: dict = {}


def _model(arch):
    if arch not in _PARAMS:
        cfg = configs.smoke(arch)
        _PARAMS[arch] = (cfg, init_tree(registry.decls(cfg), 0, "cpu"))
    return _PARAMS[arch]


def _reqs(vocab):
    """Two tiny requests: one greedy, one sampled."""
    reqs = [Request(id=f"r{i}", prompt=[(7 * i + j) % vocab for j in range(4)],
                    max_new_tokens=3) for i in range(2)]
    reqs[1].sampling = SamplingParams(temperature=0.8, top_p=0.9, seed=7)
    return reqs


def _serve(arch, **engine_kwargs):
    cfg, params = _model(arch)
    clock = FakeClock()
    eng = ContinuousBatchingEngine(cfg, params, slots=2, max_len=24,
                                   clock=clock, device="cpu", **engine_kwargs)
    Simulator(eng, burst_trace(_reqs(cfg.vocab)), clock).run()
    return eng


def _tokens(eng):
    return {r.id: tuple(r.tokens) for r in eng.completed}


def test_the_paged_selection_is_the_references():
    assert {a for a in ARCHS
            if registry.supports_paged(configs.smoke(a))} == _PAGED
    assert set(configs.names()) == set(ARCHS)


@pytest.mark.parametrize("arch", _tiered(ARCHS))
def test_every_config_admits_and_completes(arch):
    """The engine serves the config on its registry-selected backend: every
    request admits, decodes its full budget and closes its journal
    record."""
    cfg = configs.smoke(arch)
    eng = _serve(arch)
    assert eng.stats()["backend"] == ("paged" if arch in _PAGED else "lanes")
    toks = _tokens(eng)
    assert set(toks) == {"r0", "r1"}
    assert all(len(t) == 3 for t in toks.values())
    assert all(0 <= int(tok) < cfg.vocab for t in toks.values() for tok in t)
    for rid in toks:
        assert eng.journal.get(rid).completed
    assert eng.stats()["sampled_requests"] == 1


@pytest.mark.parametrize("arch", _tiered(a for a in ARCHS if a in _PAGED))
def test_paged_and_lane_backends_agree(arch):
    """Paged-capable configs emit the same greedy and sampled streams on
    both backends."""
    assert _tokens(_serve(arch)) == _tokens(_serve(arch, paged=False))


@pytest.mark.parametrize("arch", _tiered(a for a in ARCHS
                                         if a not in _PAGED))
def test_lane_fallbacks_are_seed_deterministic(arch):
    """Mamba-2, Griffin and MoE have no paged path: two fresh engines with
    the same per-request seeds give the same sampled streams."""
    a, b = _tokens(_serve(arch)), _tokens(_serve(arch))
    assert a == b
    assert len(a["r1"]) == 3
