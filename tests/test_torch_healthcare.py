"""The port's healthcare pipeline against ``repro.apps.healthcare``.

The paper's two applications at their own sizes (Table 2, §V-B): the
heartbeat classifier over a 3-lead, 3840-sample ECG window (17 beats) and
the seizure CNN over a 23-lead, 1024-sample EEG window (23 -> 32 -> 32 ->
16 channels, kernel 4, hidden 64). Random weights cannot be drawn alike
(JAX's threefry against ``torch.Generator``), so the JAX package's
projection and CNN parameters are carried across (``params_from_numpy``):

* ``data/biosignal`` is a copy: every window equals the reference's bit for
  bit;
* ``morphological_filter`` within 1e-6, the heartbeat flags equal on seeds
  0-4 and on a shorter window with an even beat count, where ``jnp.median``
  averages the two middle values (``median`` is held to it);
* ``SeizureCNN.apply`` on the host path and through the CGRA (the conv1d
  op dispatched through the port's XAIF registry, 87 calls an ``apply``)
  equal to JAX's host path at 1e-5; JAX's CGRA path (the Pallas kernel in
  interpret mode, about 5 s) runs once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.apps import healthcare as JH
from repro.data import biosignal as JB

torch = H = B = params_from_numpy = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, H, B, params_from_numpy
    torch = pytest.importorskip("torch")
    from repro_torch.apps import healthcare as H
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data import biosignal as B
    torch.set_num_threads(1)


SEEDS = range(5)
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module")
def projection():
    return np.asarray(JH.HeartbeatModel().projection(192))


@pytest.fixture(scope="module")
def cnn_params():
    """The JAX CNN's parameters: numpy, and on the port's CPU path."""
    jp = jax.tree.map(np.asarray, JH.SeizureCNN().init())
    return jp, params_from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def jax_host_logits():
    """JAX's host-path logits per seed (computed once, 1-2 s each)."""
    cache = {}

    def get(seed):
        if seed not in cache:
            cache[seed] = JH.run_seizure(seed, "host")[0]
        return cache[seed]
    return get


# ---------------------------------------------------------------------------
# data/biosignal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_biosignal_windows_equal_bit_for_bit(seed):
    for spec, jspec in ((B.HEARTBEAT_ECG, JB.HEARTBEAT_ECG),
                        (B.SEIZURE_EEG, JB.SEIZURE_EEG)):
        assert (spec.name, spec.leads, spec.window_s, spec.bits_per_sample,
                spec.samples_per_window, spec.window_bytes,
                spec.banks_needed) == (
            jspec.name, jspec.leads, jspec.window_s, jspec.bits_per_sample,
            jspec.samples_per_window, jspec.window_bytes, jspec.banks_needed)
        sim, jsim = B.AcquisitionSim(spec, seed=seed), JB.AcquisitionSim(jspec, seed=seed)
        assert sim.bank_states() == jsim.bank_states()
        for idx in (0, 1, 5):
            got, want = sim.window(idx), jsim.window(idx)
            assert got.dtype == want.dtype == np.int16
            np.testing.assert_array_equal(got, want)
    for abnormal in (True, False):
        np.testing.assert_array_equal(
            B.ecg_window(B.HEARTBEAT_ECG, seed, abnormal),
            JB.ecg_window(JB.HEARTBEAT_ECG, seed, abnormal))
    for seizure in (True, False):
        np.testing.assert_array_equal(
            B.eeg_window(B.SEIZURE_EEG, seed, seizure),
            JB.eeg_window(JB.SEIZURE_EEG, seed, seizure))


# ---------------------------------------------------------------------------
# Heartbeat classifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_morphological_filter_matches(seed):
    ecg = JB.ecg_window(JB.HEARTBEAT_ECG, seed) / np.float32(16384.0)
    want = JH.morphological_filter(jnp.asarray(ecg, jnp.float32))
    got = H.morphological_filter(torch.from_numpy(ecg.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("width", [3, 4, 13])
def test_erode_and_dilate_pad_as_the_reference(width):
    x = np.random.default_rng(width).normal(size=(3, 50)).astype(np.float32)
    for port, ref in ((H._erode, JH._erode), (H._dilate, JH._dilate)):
        np.testing.assert_array_equal(port(torch.from_numpy(x), width).numpy(),
                                      np.asarray(ref(jnp.asarray(x), width)))


@pytest.mark.parametrize("seed", SEEDS)
def test_heartbeat_flags_match(seed, projection):
    want, want_macs = JH.run_heartbeat(seed)
    got, macs = H.run_heartbeat(seed, device="cpu", projection=projection)
    assert got.dtype == bool and got.shape == want.shape == (17,)
    np.testing.assert_array_equal(got, want)
    assert macs == want_macs


def test_heartbeat_flags_match_at_an_even_beat_count(projection):
    """3627 samples: int(3627 / 213.3) - 1 = 16 beats, so the median
    template averages the two middle beats."""
    ecg = JB.ecg_window(JB.HEARTBEAT_ECG, 3)[:, :3627]
    want = np.asarray(JH.HeartbeatModel().classify(jnp.asarray(ecg)))
    got = H.HeartbeatModel().classify(ecg, projection=projection,
                                      device="cpu").numpy()
    assert want.shape == (16,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [16, 17, 2, 1])
def test_median_is_jnp_median(n):
    f = np.random.default_rng(n).normal(size=(n, 32)).astype(np.float32)
    np.testing.assert_array_equal(H.median(torch.from_numpy(f), 0).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(f), axis=0)))


def test_std_divides_by_n():
    s = np.random.default_rng(0).normal(size=17).astype(np.float32)
    np.testing.assert_allclose(H._std(torch.from_numpy(s)).item(),
                               float(jnp.asarray(s).std()), rtol=1e-6)


# ---------------------------------------------------------------------------
# Seizure CNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", ["host", "cgra"])
def test_seizure_cnn_matches_jax_host(seed, impl, cnn_params, jax_host_logits):
    _, params = cnn_params
    want = jax_host_logits(seed)
    got, macs = H.run_seizure(seed, impl, device="cpu", params=params)
    assert got.shape == (2,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert macs == JH.SeizureCNN().mac_count()


def test_jax_cgra_path_agrees_with_the_ports(cnn_params, jax_host_logits):
    """JAX's CGRA path (87 Pallas calls in interpret mode) once, against
    the port's CGRA path on the same params."""
    _, params = cnn_params
    want = np.asarray(JH.run_seizure(0, "cgra")[0])
    np.testing.assert_allclose(want, jax_host_logits(0), atol=1e-4)
    got = H.run_seizure(0, "cgra", device="cpu", params=params)[0]
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_cgra_path_dispatches_87_convs_through_the_registry(cnn_params):
    import dataclasses

    from repro_torch.core.xaif import REGISTRY

    spec = REGISTRY.get("conv1d", "cuda")
    shapes = []

    def counted(x, w):
        shapes.append((tuple(x.shape), x.stride(2), tuple(w.shape)))
        return spec.fn(x, w)

    REGISTRY.register(dataclasses.replace(spec, fn=counted), allow_override=True)
    try:
        H.run_seizure(0, "cgra", device="cpu", params=cnn_params[1])
    finally:
        REGISTRY.register(spec, allow_override=True)
    assert len(shapes) == 23 + 32 + 32
    assert shapes[0] == ((1, 1024, 32), 0, (4, 32))     # stride-0 broadcast
    assert shapes[23] == ((1, 512, 32), 0, (4, 32))
    assert shapes[-1] == ((1, 256, 16), 0, (4, 16))


def test_seeded_weights_are_the_references_shapes_and_scales():
    p = H.SeizureCNN().init("cpu")
    jp = JH.SeizureCNN().init()
    assert sorted(p) == sorted(jp)
    for k in p:
        assert tuple(p[k].shape) == jp[k].shape and p[k].dtype == torch.float32
        np.testing.assert_allclose(p[k].std().item(), float(jnp.std(jp[k])),
                                   rtol=0.2, atol=1e-6)
    again = H.SeizureCNN().init("cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)
    proj = H.HeartbeatModel().projection(192, "cpu")
    assert tuple(proj.shape) == (192, 32)
    logits, _ = H.run_seizure(0, "host", device="cpu")
    cgra, _ = H.run_seizure(0, "cgra", device="cpu")
    np.testing.assert_allclose(logits, cgra, atol=1e-4)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card's machine runs them on the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.run_seizure(0, "cgra")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.run_heartbeat(0)
