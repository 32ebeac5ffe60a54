"""The port's X-HEEP platform model against the reference's.

* ``core/energy``, ``core/power`` and ``core/hw`` are copies: every public
  function and constant they carry equals the reference's (``==`` on the
  same arguments), the paper's anchors (``tests/test_energy.py``) hold, and
  the port carries no public name the reference lacks (the TPU figures are
  left out on purpose);
* ``XaifRegistry``, ``InterruptController`` and ``Platform`` behave as
  ``tests/test_platform.py`` holds the reference's, case for case, with the
  processing core's impl key ``"cuda"`` in place of ``"pallas"``, and
  ``Platform.rules`` giving the reference's preset for every bus and
  addressing mode;
* importing ``repro_torch.kernels`` registers ``attention``,
  ``paged_attention``, ``rglru``, ``ssd`` and ``conv1d`` under ``"cuda"``,
  with the reference's ports and power domains, and builds nothing.
"""

import dataclasses
import random

import pytest

import repro.kernels  # noqa: F401  (XAIF registration of "pallas")
from repro.core import energy as JE
from repro.core import hw as JHW
from repro.core import power as JPW
from repro.core.xaif import REGISTRY as JREGISTRY

torch = E = PW = HW = xaif = platform_mod = Axes = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, E, PW, HW, xaif, platform_mod, Axes
    torch = pytest.importorskip("torch")
    from repro_torch.core import energy as E
    from repro_torch.core import hw as HW
    from repro_torch.core import platform as platform_mod
    from repro_torch.core import power as PW
    from repro_torch.core import xaif
    from repro_torch.sharding.params import Axes
    torch.set_num_threads(1)


def _public(mod):
    """Public names a module defines itself (not its imports)."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and getattr(v, "__module__", mod.__name__)
            in (mod.__name__, None) and not isinstance(v, type(dataclasses))
            and n != "annotations"}


def _domain(d):
    return dataclasses.astuple(d)


def _pm(pm):
    return ({n: _domain(d) for n, d in pm.domains.items()},
            {n: s.value for n, s in pm.states.items()})


# ---------------------------------------------------------------------------
# core/energy, core/power, core/hw: copies of the reference
# ---------------------------------------------------------------------------

TPU_ONLY = {"TPU_PJ_PER_FLOP_BF16", "TPU_PJ_PER_HBM_BYTE", "TPU_IDLE_W",
            "TPU_PEAK_W", "tpu_step_energy_j", "TPU_V5E"}


@pytest.mark.parametrize("name", ["energy", "power", "hw"])
def test_public_names_are_the_references_less_the_tpu_figures(name):
    port = {"energy": E, "power": PW, "hw": HW}[name]
    ref = {"energy": JE, "power": JPW, "hw": JHW}[name]
    assert _public(port) == _public(ref) - TPU_ONLY
    assert not _public(port) & TPU_ONLY


CONSTANTS = ["V_NOM", "DYN_VOLT_EXP", "LEAK_VOLT_EXP", "CPU_ACTIVE_DYN",
             "IO_PADS_ACQ_DYN", "CGRA_ACTIVE_DYN", "N_BANKS",
             "CPU_CYCLES_PER_MAC", "CGRA_CYCLES_PER_MAC", "HEARTBEAT_ACQ_S",
             "HEARTBEAT_PROC_CYCLES", "SEIZURE_ACQ_S", "SEIZURE_PROC_CYCLES",
             "CYCLES_PER_DECODE_TOKEN", "CYCLES_PER_PREFILL_TOKEN"]


@pytest.mark.parametrize("name", CONSTANTS)
def test_energy_constants_equal(name):
    assert getattr(E, name) == getattr(JE, name)


SCENARIOS = [
    ("power_sleep_32khz", ()), ("power_max_470mhz_1v2", ()),
    ("power_processing", (False,)), ("power_processing", (True,)),
    ("power_acquisition", (0,)), ("power_acquisition", (1,)),
    ("power_acquisition", (2,)), ("power_cgra_cnn", ()), ("dvfs_ratios", ()),
    ("conv_energy_uj", (True,)), ("conv_energy_uj", (False,)),
    ("conv_energy_uj", (True, 32, 5)), ("conv_energy_uj", (False, 8, 1)),
    ("cgra_benefit", ()), ("leak_scale", (1.2,)), ("dyn_scale", (0.9,)),
    ("leak_scale", (0.8,)), ("dyn_scale", (1.05,)),
]


@pytest.mark.parametrize("fn,args", SCENARIOS,
                         ids=[f"{f}{a}" for f, a in SCENARIOS])
def test_energy_functions_equal(fn, args):
    assert getattr(E, fn)(*args) == getattr(JE, fn)(*args)


def test_heepocrates_power_manager_and_power_uw_equal():
    pm, jpm = E.build_heepocrates_pm(), JE.build_heepocrates_pm()
    assert _pm(pm) == _pm(jpm)
    act = {"cpu": 0.4, "bank3": 1.0, "cgra_logic": 0.7, "io_pads": 0.2}
    for p, jp in ((pm, jpm), (PW.PowerManager(list(pm.domains.values())),
                              JPW.PowerManager(list(jpm.domains.values())))):
        p.set_states({"bank5": PW.PowerState.RETENTION,
                      "imc": PW.PowerState.OFF,
                      "cpu": PW.PowerState.CLOCK_GATED})
        jp.set_states({"bank5": JPW.PowerState.RETENTION,
                       "imc": JPW.PowerState.OFF,
                       "cpu": JPW.PowerState.CLOCK_GATED})
        assert E.power_uw(p, 170.0, 0.8, act) == JE.power_uw(jp, 170.0, 0.8, act)
        assert p.leakage_uw(1.3) == jp.leakage_uw(1.3)


@pytest.mark.parametrize("trim", [False, True])
def test_mcu_models_and_app_energy_equal(trim):
    got, want = E.mcu_models(trim), JE.mcu_models(trim)
    assert sorted(got) == sorted(want)
    for k in got:
        assert dataclasses.astuple(got[k]) == dataclasses.astuple(want[k])
        for app, japp in ((E.HEARTBEAT, JE.HEARTBEAT), (E.SEIZURE, JE.SEIZURE)):
            assert dataclasses.astuple(app) == dataclasses.astuple(japp)
            assert got[k].app_energy_mj(app) == want[k].app_energy_mj(japp)
    assert E.gp_trim_saving(E.HEARTBEAT) == JE.gp_trim_saving(JE.HEARTBEAT)
    assert E.gp_trim_saving(E.SEIZURE) == JE.gp_trim_saving(JE.SEIZURE)


def test_operating_points_equal():
    assert sorted(E.OPERATING_POINTS) == sorted(JE.OPERATING_POINTS)
    for name, pt in E.OPERATING_POINTS.items():
        jpt = JE.operating_point(name)
        assert E.operating_point(name) is pt
        assert (pt.name, pt.freq_mhz, pt.voltage, pt.leak_scale,
                pt.dyn_scale) == (jpt.name, jpt.freq_mhz, jpt.voltage,
                                  jpt.leak_scale, jpt.dyn_scale)
    with pytest.raises(ValueError, match="unknown operating point"):
        E.operating_point("turbo")


# the paper's anchors (tests/test_energy.py), on the port's copy
def _approx(value, target, tol=0.025):
    assert abs(value - target) / target < tol, (value, target)


ANCHORS = {
    "sleep_270uw": lambda: _approx(E.power_sleep_32khz(), 270.0, 0.02),
    "max_corner_48mw": lambda: _approx(E.power_max_470mhz_1v2() / 1000, 48.0, 0.02),
    "processing_8_17mw": lambda: _approx(E.power_processing(False) / 1000, 8.17, 0.02),
    "processing_7_68mw": lambda: _approx(E.power_processing(True) / 1000, 7.68, 0.02),
    "acquisition_384uw": lambda: _approx(E.power_acquisition(0), 384.0, 0.02),
    "acquisition_310uw": lambda: _approx(E.power_acquisition(1), 310.0, 0.02),
    "acquisition_286uw": lambda: _approx(E.power_acquisition(2), 286.0, 0.02),
    "cgra_cnn_4mw": lambda: _approx(E.power_cgra_cnn() / 1000, 4.01, 0.02),
    "dvfs_5_9x_2_8x_2_1x": lambda: [
        _approx(r, t, tol) for r, t, tol in
        zip(E.dvfs_ratios(), (5.9, 2.8, 2.1), (0.02, 0.02, 0.03))],
    "cgra_benefit_4_9x": lambda: _approx(E.cgra_benefit(), 4.9, 0.02),
    "gp_trim_27_3": lambda: [
        _assert(abs(E.gp_trim_saving(E.HEARTBEAT) - 0.27) < 0.015),
        _assert(abs(E.gp_trim_saving(E.SEIZURE) - 0.03) < 0.015)],
}


def _assert(cond):
    assert cond


@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_paper_anchors_hold_on_the_port(anchor):
    ANCHORS[anchor]()


def test_fig5_orderings_and_leakage_split():
    m = E.mcu_models()
    hb = {k: sum(v.app_energy_mj(E.HEARTBEAT)) for k, v in m.items()}
    sz = {k: sum(v.app_energy_mj(E.SEIZURE)) for k, v in m.items()}
    assert hb["apollo3_blue"] < hb["heepocrates"] < hb["gap9"]
    assert sz["gap9"] < sz["heepocrates"] < sz["apollo3_blue"]
    pm = E.build_heepocrates_pm()
    ess, gp = pm.domains["ao_essential"].leak_uw, pm.domains["ao_gp_periph"].leak_uw
    _approx(ess / (ess + gp), 0.35, 0.02)


def test_power_domain_equals_reference_on_random_scenarios():
    rng = random.Random(0)
    states = list(zip(PW.PowerState, JPW.PowerState))
    assert [(a.name, a.value) for a, _ in states] == \
        [(b.name, b.value) for _, b in states]
    assert PW.RETENTION_LEAK_FACTOR == JPW.RETENTION_LEAK_FACTOR
    for _ in range(200):
        kw = {"leak_uw": rng.uniform(0.1, 100), "idle_dyn_uw_mhz": rng.uniform(0, 10),
              "active_dyn_uw_mhz": rng.uniform(0, 100), "retainable": True}
        d, jd = PW.PowerDomain("x", **kw), JPW.PowerDomain("x", **kw)
        args = (rng.uniform(0, 1), rng.uniform(0.01, 500), rng.uniform(0.5, 3),
                rng.uniform(0.5, 3))
        for st, jst in states:
            assert d.power_uw(st, *args) == jd.power_uw(jst, *args)


def test_power_manager_semantics_match():
    for mod in (PW, JPW):
        pm = mod.PowerManager([mod.PowerDomain("cpu", leak_uw=1.0),
                               mod.PowerDomain("bank", leak_uw=2.0,
                                               retainable=True)])
        with pytest.raises(ValueError):
            pm.set_state("cpu", mod.PowerState.RETENTION)
        with pytest.raises(ValueError, match="duplicate"):
            pm.add_domain(mod.PowerDomain("cpu", leak_uw=3.0))
        with pytest.raises(KeyError):
            pm.state("nope")
        pm.set_state("bank", mod.PowerState.RETENTION)
        assert pm.leakage_uw() == pytest.approx(1.0 + 2.0 * 0.575)
        pm.remove_domain("bank")
        assert pm.is_active("cpu") and list(pm.states) == ["cpu"]


def test_hw_copies_equal():
    assert sorted(HW.HEEPOCRATES_POINTS) == sorted(JHW.HEEPOCRATES_POINTS)
    for k, pt in HW.HEEPOCRATES_POINTS.items():
        assert dataclasses.astuple(pt) == dataclasses.astuple(JHW.HEEPOCRATES_POINTS[k])
    assert [f.name for f in dataclasses.fields(HW.ChipSpec)] == \
        [f.name for f in dataclasses.fields(JHW.ChipSpec)]
    for shape, elt in (((2, 3, 4), 2), ((), 4), ((7,), 1)):
        assert HW.bytes_of(shape, elt) == JHW.bytes_of(shape, elt)
    assert not hasattr(HW, "TPU_V5E")


# ---------------------------------------------------------------------------
# XAIF registry, interrupts, platform (tests/test_platform.py, case for case)
# ---------------------------------------------------------------------------


def test_config_validation():
    for kw in ({"core": "cortex-m4"}, {"bus": "token-ring"},
               {"addressing": "random"}, {"n_banks": 0}):
        with pytest.raises(ValueError):
            platform_mod.XHeepConfig(**kw)


def test_core_selects_backend():
    assert platform_mod.CORE_BACKEND == {"cv32e20": "ref",
                                         "cv32e40x": "chunked",
                                         "cv32e40p": "cuda"}


def test_registry_dispatch_and_override():
    reg = xaif.XaifRegistry()
    spec = xaif.AcceleratorSpec(name="x", op="myop", impl="ref",
                                fn=lambda a: a + 1)
    reg.register(spec)
    assert reg.dispatch("myop", "ref", 41) == 42
    with pytest.raises(ValueError):
        reg.register(spec)                      # duplicate
    reg.register(spec, allow_override=True)     # explicit override ok
    with pytest.raises(KeyError):
        reg.get("myop", "cuda")


def test_platform_attach_joins_power_manager():
    p = platform_mod.Platform(platform_mod.XHeepConfig(),
                              registry=xaif.XaifRegistry())
    spec = xaif.AcceleratorSpec(
        name="keccak", op="hash", impl="cuda", fn=lambda x: x,
        master_ports=(xaif.PortSpec("data", Axes(None)),),
        power_domain=PW.PowerDomain("keccak", leak_uw=3.0))
    p.attach(spec)
    assert "keccak" in p.power.domains
    assert p.accelerators[0].bus_width_bits == 32
    p.power.set_state("keccak", PW.PowerState.OFF)
    assert not p.power.is_active("keccak")


def test_impl_for_prefers_override_then_core_then_ref():
    reg = xaif.XaifRegistry()
    reg.register(xaif.AcceleratorSpec(name="a", op="attention", impl="cuda",
                                      fn=lambda: None))
    cfg = platform_mod.XHeepConfig
    assert platform_mod.Platform(cfg(core="cv32e40p"), registry=reg) \
        .impl_for("attention") == "cuda"
    assert platform_mod.Platform(cfg(core="cv32e20"), registry=reg) \
        .impl_for("attention") == "ref"
    assert platform_mod.Platform(
        cfg(core="cv32e20", op_impls={"attention": "cuda"}), registry=reg
    ).impl_for("attention") == "cuda"


def test_cgra_port_structure_matches_paper():
    """Paper §IV-A2: CGRA = 2 slave ports + 4 master ports = 128 bit/cycle."""
    import repro_torch.kernels  # noqa: F401

    cgra = xaif.REGISTRY.get("conv1d", "cuda")
    assert len(cgra.slave_ports) == 2 and len(cgra.master_ports) == 4
    assert cgra.bus_width_bits == 128
    assert cgra.power_domain.name == "cgra"


def test_registry_duplicate_registration_rejected_per_op_impl():
    reg = xaif.XaifRegistry()
    spec = xaif.AcceleratorSpec
    reg.register(spec(name="a", op="op1", impl="ref", fn=lambda: 1))
    reg.register(spec(name="b", op="op1", impl="cuda", fn=lambda: 2))
    reg.register(spec(name="c", op="op2", impl="ref", fn=lambda: 3))
    with pytest.raises(ValueError, match="already registered"):
        reg.register(spec(name="d", op="op1", impl="ref", fn=lambda: 4))
    assert reg.impls("op1") == ["cuda", "ref"]
    assert reg.ops() == ["op1", "op2"]


def test_impl_for_falls_back_to_ref_when_core_backend_missing():
    """cv32e40p wants cuda; an op with only ref/chunked must fall back."""
    reg = xaif.XaifRegistry()
    reg.register(xaif.AcceleratorSpec(name="r", op="rglru", impl="ref",
                                      fn=lambda x: x))
    reg.register(xaif.AcceleratorSpec(name="c", op="rglru", impl="chunked",
                                      fn=lambda x: x * 2))
    cfg, Platform = platform_mod.XHeepConfig, platform_mod.Platform
    assert Platform(cfg(core="cv32e40p"), registry=reg).impl_for("rglru") == "ref"
    p2 = Platform(cfg(core="cv32e40x"), registry=reg)
    assert p2.impl_for("rglru") == "chunked"
    assert p2.dispatch("rglru", 21) == 42
    p3 = Platform(cfg(core="cv32e40x", op_impls={"rglru": "ref"}), registry=reg)
    assert p3.impl_for("rglru") == "ref"


def test_attach_joins_power_manager_exactly_once():
    p = platform_mod.Platform(platform_mod.XHeepConfig(),
                              registry=xaif.XaifRegistry())
    dom = PW.PowerDomain("accel", leak_uw=5.0)
    p.attach(xaif.AcceleratorSpec(name="v1", op="myop", impl="cuda",
                                  fn=lambda x: x, power_domain=dom))
    leak_once = p.power.leakage_uw()
    p.attach(xaif.AcceleratorSpec(name="v2", op="myop", impl="cuda",
                                  fn=lambda x: x + 1, power_domain=dom))
    assert p.power.leakage_uw() == leak_once
    assert [s.name for s in p.accelerators] == ["v2"]
    assert p.registry.get("myop", "cuda").fn(1) == 2


def test_reattach_with_new_domain_drops_the_orphan():
    p = platform_mod.Platform(platform_mod.XHeepConfig(),
                              registry=xaif.XaifRegistry())
    p.attach(xaif.AcceleratorSpec(name="v1", op="myop", impl="cuda",
                                  fn=lambda x: x,
                                  power_domain=PW.PowerDomain("a", leak_uw=5.0)))
    base = p.power.leakage_uw() - 5.0
    p.attach(xaif.AcceleratorSpec(name="v2", op="myop", impl="cuda",
                                  fn=lambda x: x,
                                  power_domain=PW.PowerDomain("b", leak_uw=7.0)))
    assert "a" not in p.power.domains
    assert p.power.leakage_uw() == pytest.approx(base + 7.0)


def test_reattach_never_removes_platform_builtin_domains():
    p = platform_mod.Platform(platform_mod.XHeepConfig(),
                              registry=xaif.XaifRegistry())
    bank0 = p.power.domains["bank0"]
    p.attach(xaif.AcceleratorSpec(name="v1", op="myop", impl="cuda",
                                  fn=lambda x: x, power_domain=bank0))
    p.attach(xaif.AcceleratorSpec(name="v2", op="myop", impl="cuda",
                                  fn=lambda x: x,
                                  power_domain=PW.PowerDomain("fresh",
                                                              leak_uw=1.0)))
    assert "bank0" in p.power.domains
    p.power.clock_gate("bank0")


def test_bank_refcounts_shared_across_holders():
    p = platform_mod.Platform(platform_mod.XHeepConfig(),
                              registry=xaif.XaifRegistry())
    p.power.clock_gate("bank0")
    p.bank_acquire("bank0")
    p.bank_acquire("bank0")
    assert p.power.state("bank0") is PW.PowerState.ON
    p.bank_release("bank0")
    assert p.power.state("bank0") is PW.PowerState.ON    # one holder left
    p.bank_release("bank0")
    assert p.power.state("bank0") is PW.PowerState.CLOCK_GATED
    with pytest.raises(ValueError, match="released more than acquired"):
        p.bank_release("bank0")


def test_interrupt_controller_counts_and_handlers():
    irq = xaif.InterruptController()
    got = []
    irq.connect("acc.done", got.append)
    assert irq.fire("acc.done", 7) == 1
    assert got == [7]
    assert irq.fire("other", None) == 0          # counted, not an error
    assert irq.count("other") == 1 and irq.count("acc.done") == 1
    irq.disconnect("acc.done", got.append)
    irq.fire("acc.done")
    assert got == [7] and irq.count("acc.done") == 2
    assert irq.lines() == ["acc.done", "other"]


def test_platform_has_interrupt_fabric():
    p = platform_mod.Platform(platform_mod.XHeepConfig(),
                              registry=xaif.XaifRegistry())
    seen = []
    p.interrupts.connect("serve.complete", seen.append)
    p.interrupts.fire("serve.complete", "req")
    assert seen == ["req"]


def test_port_direction_is_validated():
    with pytest.raises(ValueError, match="bad port direction"):
        xaif.PortSpec("p", Axes(None), direction="sideways")


def test_rules_waits_for_the_tensor_parallelism_slice():
    """Ported with tensor parallelism: the rules equal the reference's
    for both buses and both addressing modes, on a one-device mesh."""
    from jax.sharding import Mesh as JMesh
    import jax
    import numpy as np
    from repro.core.platform import Platform as JPlatform
    from repro.core.platform import XHeepConfig as JConfig
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(["cpu"])
    jmesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    for bus in ("one_at_a_time", "fully_connected"):
        for addressing in ("contiguous", "interleaved"):
            p = platform_mod.Platform(platform_mod.XHeepConfig(
                bus=bus, addressing=addressing))
            want = JPlatform(JConfig(bus=bus, addressing=addressing)).rules(
                jmesh)
            got = p.rules(mesh)
            assert (got.name, dict(got.table)) == (want.name,
                                                   dict(want.table))


# ---------------------------------------------------------------------------
# The six ported kernels register under "cuda"
# ---------------------------------------------------------------------------

OPS = ["attention", "paged_attention", "rglru", "ssd", "conv1d", "moe_ffn"]
PACKAGE = {"moe_ffn": "moe"}      # the op's kernel package, where not its name


def _ports(ports):
    return [(p.name, tuple(p.axes), p.direction, p.dtype) for p in ports]


@pytest.mark.parametrize("op", OPS)
def test_kernels_register_under_cuda_with_the_references_contracts(op):
    import importlib

    import repro_torch.kernels  # noqa: F401

    spec = xaif.REGISTRY.get(op, "cuda")
    want = JREGISTRY.get(op, "pallas")
    assert (spec.op, spec.impl, spec.interrupt) == (op, "cuda", want.interrupt)
    assert spec.name == want.name.replace("pallas", "cuda")
    assert _ports(spec.slave_ports) == _ports(want.slave_ports)
    assert _ports(spec.master_ports) == _ports(want.master_ports)
    assert spec.bus_width_bits == want.bus_width_bits
    assert _domain(spec.power_domain) == _domain(want.power_domain)
    # fn is the port's device-dispatching wrapper, and registering built
    # and loaded nothing
    pkg = importlib.import_module(
        f"repro_torch.kernels.{PACKAGE.get(op, op)}")
    ops = importlib.import_module(f"{pkg.__name__}.ops")
    assert spec is ops.SPEC and spec.fn.__module__ == ops.__name__
    assert importlib.import_module(f"{pkg.__name__}.kernel")._lib is None


def test_registry_holds_exactly_the_five_ops():
    # the name dates from before the grouped matmul: the registry now holds
    # six ops, one for each CUDA kernel package (``OPS``)
    import repro_torch.kernels  # noqa: F401

    assert xaif.REGISTRY.ops() == sorted(OPS)
    assert all(xaif.REGISTRY.impls(op) == ["cuda"] for op in OPS)
