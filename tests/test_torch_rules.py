"""The port's sharding rules and meshes against the JAX package's.

``repro_torch.sharding.rules`` is a copy of ``repro.sharding.rules``: the
cases of ``tests/test_sharding.py`` and ``tests/test_serve_tp_rules.py``
run here on the port's copies, and on random shapes, logical axes and mesh
sizes ``spec_for``, ``shard_bytes`` and every config's
``serve_param_specs`` equal the reference's as tuples. Meshes are stand-ins
with ``axis_names`` and ``devices.shape`` (as the reference's tests use)
and the port's own :class:`repro_torch.launch.mesh.Mesh` over ``"cpu"``
entries, which may repeat.
"""

import dataclasses
import random

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import registry as jreg
from repro.sharding import axes as jlx
from repro.sharding import rules as JR
from repro.sharding.params import axes_tree as j_axes_tree
from repro.sharding.params import is_axes as j_is_axes

torch = R = lx = P = Axes = mesh_mod = configs = registry = None  # by _port
params_mod = None


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file (see ``tests/test_torch_engine.py``)."""
    global torch, R, lx, P, Axes, mesh_mod, configs, registry, params_mod
    torch = pytest.importorskip("torch")
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import registry
    from repro_torch.sharding import axes as lx
    from repro_torch.sharding import params as params_mod
    from repro_torch.sharding import rules as R
    from repro_torch.sharding.params import Axes
    P = R.PartitionSpec
    torch.set_num_threads(1)


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes (no devices needed)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)

        class _Dev:
            shape = tuple(sizes.values())

        self.devices = _Dev()


PROD = {"data": 16, "model": 16}
POD = {"pod": 2, "data": 16, "model": 16}
PAGED = [a for a in jconfigs.names()
         if jreg.supports_paged(jconfigs.smoke(a))]
UNPAGED = [a for a in jconfigs.names()
           if not jreg.supports_paged(jconfigs.smoke(a))]
LOGICAL = [jlx.BATCH, jlx.SEQ, jlx.EMBED, jlx.MLP, jlx.HEADS, jlx.KV_HEADS,
           jlx.VOCAB, jlx.EXPERT, jlx.HEAD_DIM, jlx.CACHE_SEQ, jlx.LAYERS,
           jlx.RNN_WIDTH, jlx.FSDP, None]


def spec_tuple(spec) -> tuple:
    """A spec of either package as a plain tuple of its entries."""
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e
                 for e in spec)


def test_axis_vocabulary_is_the_reference_one():
    names = [n for n in dir(jlx) if n.isupper()]
    assert {n: getattr(lx, n) for n in names} == {
        n: getattr(jlx, n) for n in names}


# -- the cases of tests/test_sharding.py ------------------------------------


def test_divisibility_fallback():
    mesh = FakeMesh(PROD)
    rules = R.fully_connected(mesh)
    assert R.spec_for((2048, 8, 64), (lx.EMBED, lx.KV_HEADS, lx.HEAD_DIM),
                      rules, mesh) == P("data")
    assert R.spec_for((2048, 32, 64), (lx.EMBED, lx.HEADS, lx.HEAD_DIM),
                      rules, mesh) == P("data", "model")
    assert R.spec_for((49155, 64), (lx.VOCAB, lx.HEAD_DIM), rules,
                      mesh) == P()


def test_no_duplicate_mesh_axes():
    mesh = FakeMesh(POD)
    spec = R.spec_for((256, 4096, 2048), (lx.BATCH, lx.SEQ, lx.EMBED),
                      R.fully_connected(mesh), mesh)
    flat = [a for e in spec
            for a in ((e,) if isinstance(e, str) else (e or ()))]
    assert len(flat) == len(set(flat))
    assert spec[0] == ("pod", "data")


def test_one_at_a_time_is_pure_dp():
    mesh = FakeMesh(PROD)
    assert R.spec_for((1024, 1024), (lx.EMBED, lx.MLP),
                      R.one_at_a_time(mesh), mesh) == P()


def test_shard_bytes():
    mesh = FakeMesh(PROD)
    spec = R.spec_for((1024, 4096), (lx.EMBED, lx.MLP),
                      R.fully_connected(mesh), mesh)
    assert spec == P("data", "model")
    assert R.shard_bytes((1024, 4096), spec, mesh, 2) == \
        1024 * 4096 * 2 // (16 * 16)


def test_rules_lookup_and_override():
    rules = R.fully_connected(FakeMesh(PROD))
    assert rules.lookup(None) == () and rules.lookup("unknown") == ()
    over = rules.override(name="x", **{lx.SEQ: "data", lx.MLP: None})
    assert over.name == "x" and over.lookup(lx.SEQ) == ("data",)
    assert over.lookup(lx.MLP) == () and rules.lookup(lx.MLP) == ("model",)
    assert set(R.PRESETS) == set(JR.PRESETS)


@pytest.mark.parametrize("seed", range(4))
def test_spec_property_valid_and_divisible(seed):
    """``tests/test_sharding.py``'s property on the port: every sharded
    dim divides exactly and no mesh axis is used twice."""
    rng = random.Random(seed)
    for _ in range(100):
        mesh = FakeMesh(POD if rng.random() < 0.5 else PROD)
        dims = [rng.choice(LOGICAL) for _ in range(rng.randint(1, 5))]
        shape = tuple(rng.randint(1, 4096) for _ in dims)
        spec = R.spec_for(shape, tuple(dims), R.fully_connected(mesh), mesh)
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        used = []
        for size, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
            names = (entry,) if isinstance(entry, str) else (entry or ())
            prod = 1
            for nm in names:
                used.append(nm)
                prod *= sizes[nm]
            assert size % prod == 0
        assert len(used) == len(set(used))


def test_stack_tree_prepends_layer_axis_and_axes_tree():
    decl = params_mod.ParamDecl((8, 16), Axes(lx.EMBED, lx.MLP),
                                init="fan_in")
    stacked = params_mod.stack_tree({"w": decl}, 3, lx.LAYERS)
    assert stacked["w"].shape == (3, 8, 16)
    axes = params_mod.axes_tree(stacked)
    assert params_mod.is_axes(axes["w"]) and not params_mod.is_axes(decl)
    assert tuple(axes["w"]) == (lx.LAYERS, lx.EMBED, lx.MLP)


# -- against the reference, on random inputs --------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_spec_for_and_shard_bytes_equal_the_reference(seed):
    """Random shapes, logical axes and mesh sizes (with and without a pod
    axis, both presets, interleaved overrides): the same spec and the
    same per-device bytes as ``repro.sharding.rules``."""
    rng = random.Random(100 + seed)
    for _ in range(200):
        sizes = {"data": rng.choice([1, 2, 4, 8, 16]),
                 "model": rng.choice([1, 2, 3, 4, 8, 16])}
        if rng.random() < 0.3:
            sizes = {"pod": rng.choice([1, 2]), **sizes}
        mesh = FakeMesh(sizes)
        preset = rng.choice(sorted(R.PRESETS))
        rules, jrules = R.PRESETS[preset](mesh), JR.PRESETS[preset](mesh)
        if rng.random() < 0.3:
            rules = rules.override(**{lx.SEQ: ("data",)})
            jrules = jrules.override(**{jlx.SEQ: ("data",)})
        dims = tuple(rng.choice(LOGICAL) for _ in range(rng.randint(1, 5)))
        shape = tuple(rng.choice([1, 2, 3, 6, 8, 12, 16, 48, 64, 256, 2048,
                                  49155]) for _ in dims)
        got = R.spec_for(shape, dims, rules, mesh)
        want = JR.spec_for(shape, dims, jrules, mesh)
        assert spec_tuple(got) == spec_tuple(want), (shape, dims, sizes)
        assert R.shard_bytes(shape, got, mesh, 2) == \
            JR.shard_bytes(shape, want, mesh, 2)


@pytest.mark.parametrize("arch", jconfigs.names())
def test_tree_specs_equal_the_reference(arch):
    """Every config's parameter tree under both presets on the production
    mesh: ``tree_specs`` leaf for leaf as the reference's."""
    import jax

    mesh = FakeMesh(PROD)
    decls = registry.decls(configs.smoke(arch))
    jdecls = jreg.decls(jconfigs.smoke(arch))
    for preset in sorted(R.PRESETS):
        got = params_mod.tree_leaves(R.tree_specs(
            decls, params_mod.axes_tree(decls), R.PRESETS[preset](mesh),
            mesh))
        want = jax.tree.leaves(
            JR.tree_specs(jax.tree.map(lambda d: d.abstract(), jdecls,
                                       is_leaf=lambda x: hasattr(x, "axes")),
                          j_axes_tree(jdecls), JR.PRESETS[preset](mesh),
                          mesh),
            is_leaf=lambda x: isinstance(x, JR.PartitionSpec))
        assert [spec_tuple(s) for s in got] == [spec_tuple(s) for s in want]


# -- the serving rules (tests/test_serve_tp_rules.py) -----------------------


@pytest.mark.parametrize("arch", jconfigs.names())
def test_serve_param_specs_equal_the_reference(arch):
    """Leaf for leaf, in the reference's leaf order, under two axis
    names."""
    import jax

    for axis in ("model", "tp"):
        got = params_mod.tree_leaves(
            R.serve_param_specs(configs.smoke(arch), axis))
        want = jax.tree.leaves(
            JR.serve_param_specs(jconfigs.smoke(arch), axis),
            is_leaf=lambda x: isinstance(x, JR.PartitionSpec))
        assert [spec_tuple(s) for s in got] == [spec_tuple(s) for s in want]


@pytest.mark.parametrize("arch", PAGED)
def test_paged_configs_resolve_head_sharding(arch):
    cfg = configs.smoke(arch)
    for tp in (1, 2, cfg.n_kv_heads):
        if cfg.n_kv_heads % tp == 0:
            R.validate_serve_tp(cfg, tp)
    axes = params_mod.tree_leaves(params_mod.axes_tree(registry.decls(cfg)))
    specs = params_mod.tree_leaves(R.serve_param_specs(cfg))
    assert len(axes) == len(specs)
    sharded = 0
    for ax, spec in zip(axes, specs):
        dims = tuple(ax)
        if "model" in spec:
            sharded += 1
            assert dims[-1] == lx.HEAD_DIM
            assert dims[spec.index("model")] in (lx.HEADS, lx.KV_HEADS)
            assert spec.count("model") == 1
        elif dims and dims[-1] == lx.HEAD_DIM:
            assert not ({lx.HEADS, lx.KV_HEADS} & set(dims)), (dims, spec)
        if lx.HEADS in dims and dims[-1] != lx.HEAD_DIM:
            assert spec == P()             # wo stays replicated
    assert sharded == 3                    # wq, wk, wv


@pytest.mark.parametrize("arch", PAGED)
def test_gqa_indivisible_tp_rejected(arch):
    cfg = configs.smoke(arch)
    bad = cfg.n_kv_heads * 2 - 1 if cfg.n_kv_heads > 1 else 2
    with pytest.raises(ValueError, match=r"n_kv_heads \d+ % tp") as got:
        R.validate_serve_tp(cfg, bad)
    with pytest.raises(ValueError) as want:
        JR.validate_serve_tp(jconfigs.smoke(arch), bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("arch", UNPAGED)
def test_lane_fallback_families_rejected(arch):
    for tp in (1, 2):
        with pytest.raises(ValueError,
                           match="cannot serve tensor-parallel") as got:
            R.validate_serve_tp(configs.smoke(arch), tp)
        with pytest.raises(ValueError) as want:
            JR.validate_serve_tp(jconfigs.smoke(arch), tp)
        assert str(got.value) == str(want.value)


def test_mqa_and_tp_below_one_rejected():
    cfg = dataclasses.replace(configs.smoke("granite_3_2b"), n_kv_heads=1,
                              n_heads=4)
    R.validate_serve_tp(cfg, 1)
    with pytest.raises(ValueError, match="MQA has a single shared KV head"):
        R.validate_serve_tp(cfg, 2)
    with pytest.raises(ValueError, match="tp must be >= 1"):
        R.validate_serve_tp(configs.smoke("granite_3_2b"), 0)


def test_serve_param_spec_head_dim_suffix_rule():
    assert R.serve_param_spec(Axes(lx.EMBED, lx.HEADS, lx.HEAD_DIM)) == \
        P(None, "model")
    assert R.serve_param_spec(Axes(lx.KV_HEADS, lx.HEAD_DIM)) == P("model")
    assert R.serve_param_spec(Axes(lx.HEADS, lx.HEAD_DIM, lx.EMBED)) == P()
    assert R.serve_param_spec(Axes(lx.EMBED, lx.HEAD_DIM)) == P()
    assert R.serve_param_spec(Axes(lx.EMBED, lx.MLP)) == P()
    assert R.serve_param_spec(Axes()) == P()
    assert R.serve_param_spec(Axes(lx.EMBED, lx.HEADS, lx.HEAD_DIM),
                              tp_axis="tp") == P(None, "tp")


def test_pool_spec_and_shard_bytes():
    mesh = FakeMesh({"model": 2})
    spec = R.serve_pool_spec()
    assert spec == P(None, None, None, "model")
    assert spec_tuple(spec) == spec_tuple(JR.serve_pool_spec())
    full = R.shard_bytes((4, 8, 8, 2, 16), P(), mesh, 4)
    assert full == 4 * 8 * 8 * 2 * 16 * 4
    assert R.shard_bytes((4, 8, 8, 2, 16), spec, mesh, 4) * 2 == full


def test_partition_spec_is_a_tuple():
    spec = P(None, ["pod", "data"], "model")
    assert spec == (None, ("pod", "data"), "model")
    assert repr(spec) == "PartitionSpec(None, ('pod', 'data'), 'model')"
    assert P() == () and isinstance(P(), tuple)


# -- Platform.rules ---------------------------------------------------------


@pytest.mark.parametrize("bus", ["one_at_a_time", "fully_connected"])
@pytest.mark.parametrize("addressing", ["contiguous", "interleaved"])
@pytest.mark.parametrize("sizes", [PROD, POD, {"data": 1, "model": 1}])
def test_platform_rules_equal_the_reference(bus, addressing, sizes):
    from repro.core.platform import Platform as JPlatform
    from repro.core.platform import XHeepConfig as JConfig
    from repro_torch.core.platform import Platform, XHeepConfig

    mesh = FakeMesh(sizes)
    got = Platform(XHeepConfig(bus=bus, addressing=addressing)).rules(mesh)
    want = JPlatform(JConfig(bus=bus, addressing=addressing)).rules(mesh)
    assert (got.name, dict(got.table)) == (want.name, dict(want.table))


# -- meshes -----------------------------------------------------------------


def test_meshes_over_repeated_devices():
    m = mesh_mod.serve_tp_mesh(2, ["cpu"] * 2)
    assert m.axis_names == ("model",) and m.shape == {"model": 2}
    assert list(m.devices.flat) == [torch.device("cpu")] * 2
    assert m == mesh_mod.serve_tp_mesh(2, ["cpu", "cpu", "cpu"])
    assert hash(m) == hash(mesh_mod.make_mesh((2,), ("model",), ["cpu"] * 2))
    assert m != mesh_mod.make_mesh((2,), ("tp",), ["cpu"] * 2)
    reps = mesh_mod.replica_meshes(2, 2, ["cpu"] * 4)
    assert [r.shape for r in reps] == [{"model": 2}] * 2
    grid = mesh_mod.make_mesh((2, 3), ("data", "model"), ["cpu"] * 6)
    assert grid.shape == {"data": 2, "model": 3} and grid.size == 6
    assert grid.devices.shape == (2, 3)
    host = mesh_mod.make_host_mesh(["cpu"])
    assert host.shape == {"data": 1, "model": 1}
    assert mesh_mod.make_host_mesh(["cpu"] * 3).shape == {"data": 3,
                                                            "model": 1}
    prod = mesh_mod.make_production_mesh(devices=["cpu"] * 256)
    assert prod.shape == {"data": 16, "model": 16}
    pods = mesh_mod.make_production_mesh(multi_pod=True,
                                         devices=["cpu"] * 512)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    # the rules read the port's mesh as they read the reference's
    assert R.spec_for((2048, 32, 64), (lx.EMBED, lx.HEADS, lx.HEAD_DIM),
                      R.fully_connected(prod), prod) == P("data", "model")


def test_meshes_with_too_few_devices_raise():
    with pytest.raises(ValueError, match=r"need 4 devices for tp=4, have 2"):
        mesh_mod.serve_tp_mesh(4, ["cpu"] * 2)
    with pytest.raises(ValueError, match="2 replicas at tp=2, have 3"):
        mesh_mod.replica_meshes(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError, match="devices="):
        mesh_mod.make_production_mesh(devices=["cpu"] * 255)
    with pytest.raises(ValueError, match="axis names"):
        mesh_mod.Mesh(np.asarray(["cpu"] * 2, dtype=object), ("a", "b"))
    if not torch.cuda.is_available():
        # the default list is every CUDA device: none here
        with pytest.raises(ValueError, match=r"\['cpu'\] \* 2"):
            mesh_mod.serve_tp_mesh(2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_mod.serve_tp_mesh(1, ["cuda"])
