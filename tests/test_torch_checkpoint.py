"""The port's checkpoints (``repro_torch.ckpt.checkpoint``): the cases of
``tests/test_checkpoint.py`` but elastic resharding (the port has no mesh
yet), run on the port's trees; the on-disk format against the JAX
package's ``repro.ckpt.checkpoint`` both ways, bit for bit on the same
bridged params, bf16 leaves included; an async save that an in-place
AdamW step follows; and ``launch.train.main`` resumed from a checkpoint
against the uninterrupted run, bit for bit, on tokens (granite-smoke) and
on embeddings (musicgen-smoke).
"""

import json
import pathlib

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.models import registry as jreg
from repro.sharding import params as JP

torch = ckpt = params_from_numpy = tree_leaves = None
optim = train_main = None  # bound by _port


@pytest.fixture(scope="module", autouse=True)
def _port():
    """Import torch and the port when these tests run, not when pytest
    collects this file: every xdist worker collects every test file, and a
    worker that has loaded torch (and its OpenMP thread pool) runs the JAX
    package's async-dispatch engine tests under other thread timing."""
    global torch, ckpt, params_from_numpy, tree_leaves, optim
    global train_main
    torch = pytest.importorskip("torch")
    from repro_torch.bridge import params_from_numpy
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.train import main as train_main
    from repro_torch.sharding.params import tree_leaves
    from repro_torch.train import optim
    torch.set_num_threads(1)


def tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((4, 8), generator=gen),
        "nested": {"b": torch.randn((3,), generator=gen).to(torch.bfloat16),
                   "c": torch.arange(5, dtype=torch.int32)},
    }


def assert_tree_equal(x, y):
    for a, b in zip(tree_leaves(x), tree_leaves(y), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    t = tree()
    ckpt.save(tmp_path, t, step=7)
    got, step, meta = ckpt.restore(tmp_path, t)
    assert step == 7
    assert_tree_equal(t, got)
    assert got["nested"]["b"].dtype == torch.bfloat16


def test_latest_step_and_multiple(tmp_path):
    t = tree()
    assert ckpt.latest_step(tmp_path / "none") is None
    ckpt.save(tmp_path, t, step=1)
    ckpt.save(tmp_path, t, step=5)
    assert ckpt.latest_step(tmp_path) == 5


def test_async_save(tmp_path):
    t = tree()
    h = ckpt.save(tmp_path, t, step=3, async_=True)
    h.join()
    got, step, _ = ckpt.restore(tmp_path, t)
    assert step == 3
    assert_tree_equal(t, got)


def test_structure_mismatch_raises(tmp_path):
    ckpt.save(tmp_path, tree(), step=1)
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(tmp_path, {"different": torch.zeros(3)})


def test_no_partial_checkpoint_visible(tmp_path):
    # a crash mid-save leaves a .tmp dir: it must not count as a checkpoint
    t = tree()
    ckpt.save(tmp_path, t, step=2)
    (tmp_path / ".tmp_step_000000009").mkdir()
    assert ckpt.latest_step(tmp_path) == 2


def test_metadata_roundtrip(tmp_path):
    ckpt.save(tmp_path, tree(), step=1, metadata={"arch": "granite"})
    _, _, meta = ckpt.restore(tmp_path, tree())
    assert meta["arch"] == "granite"


def _leaf_file(tmp_path, step, name):
    return tmp_path / f"step_{step:09d}" / f"{name}.npy"


def test_truncated_leaf_detected(tmp_path):
    t = tree()
    ckpt.save(tmp_path, t, step=1)
    f = _leaf_file(tmp_path, 1, "a")
    f.write_bytes(f.read_bytes()[:-40])    # torn write: tail lost
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.restore(tmp_path, t)


def test_flipped_bytes_detected_by_crc(tmp_path):
    t = tree()
    ckpt.save(tmp_path, t, step=1)
    f = _leaf_file(tmp_path, 1, "nested__c")
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF                        # same size and shape, wrong bits
    f.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC mismatch"):
        ckpt.restore(tmp_path, t)


def test_missing_leaf_file_detected(tmp_path):
    t = tree()
    ckpt.save(tmp_path, t, step=1)
    _leaf_file(tmp_path, 1, "nested__b").unlink()
    with pytest.raises(ValueError, match="partial write"):
        ckpt.restore(tmp_path, t)


def test_manifest_backcompat_without_integrity_fields(tmp_path):
    """A manifest without nbytes / crc32 still restores; the shape check
    runs whatever the fields."""
    t = tree()
    ckpt.save(tmp_path, t, step=1)
    mf = tmp_path / "step_000000001" / "manifest.json"
    manifest = json.loads(mf.read_text())
    for ent in manifest["leaves"]:
        del ent["nbytes"], ent["crc32"]
    mf.write_text(json.dumps(manifest))
    got, step, _ = ckpt.restore(tmp_path, t)
    assert step == 1
    assert_tree_equal(t, got)
    np.save(_leaf_file(tmp_path, 1, "a"), np.zeros((9, 9), np.float32))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(tmp_path, t)


def test_overwrite_same_step_is_atomic(tmp_path):
    """Saving a step again swaps through a rename aside: the second tree
    restores, and nothing of the swap is left behind."""
    t1, t2 = tree(seed=0), tree(seed=1)
    ckpt.save(tmp_path, t1, step=4)
    ckpt.save(tmp_path, t2, step=4)
    got, step, _ = ckpt.restore(tmp_path, t1)
    assert step == 4
    assert_tree_equal(t2, got)
    assert not list(tmp_path.glob(".old_step_*"))
    assert not list(tmp_path.glob(".tmp_step_*"))
    # a stale rename-aside from a crashed earlier swap is cleaned up too
    (tmp_path / ".old_step_000000004").mkdir()
    ckpt.save(tmp_path, t1, step=4)
    assert not list(tmp_path.glob(".old_step_*"))
    got, _, _ = ckpt.restore(tmp_path, t1)
    assert_tree_equal(t1, got)


# ---------------------------------------------------------------------------
# The JAX package's checkpoints, both ways
# ---------------------------------------------------------------------------


def _jax_params(arch="internvl2_76b", dtype="bfloat16"):
    cfg = jconfigs.smoke(arch)
    p = JP.init_tree(jreg.decls(cfg), jax.random.key(2))
    if dtype == "bfloat16":
        p = JP.cast_tree(p, jax.numpy.bfloat16)
    return jax.tree.map(np.asarray, p)


def _bits(a):
    """A leaf's bytes, whatever its package."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    """A params checkpoint written by ``repro.ckpt.checkpoint.save``
    restores in the port equal to ``bridge.params_from_numpy`` of the same
    tree, bit for bit, with its metadata."""
    jp = _jax_params(dtype=dtype)
    jckpt.save(tmp_path, jp, step=3, metadata={"arch": "internvl2-smoke"})
    want = params_from_numpy(jp, "cpu")
    like = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), jp)
    got, step, meta = ckpt.restore(tmp_path, like, device="cpu")
    assert step == 3 and meta == {"arch": "internvl2-smoke"}
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        assert g.dtype == w.dtype and _bits(g) == _bits(w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    jp = _jax_params(dtype=dtype)
    ckpt.save(tmp_path, params_from_numpy(jp, "cpu"), step=5,
              metadata={"arch": "x"})
    got, step, meta = jckpt.restore(tmp_path, jp)
    assert step == 5 and meta == {"arch": "x"}
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jp), strict=True):
        assert np.asarray(g).dtype == w.dtype and _bits(g) == _bits(w)
    # and the two packages write the same manifest
    jckpt.save(tmp_path / "ref", jp, step=5, metadata={"arch": "x"})
    mine = json.loads((tmp_path / "step_000000005" /
                       "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_000000005" /
                      "manifest.json").read_text())
    assert mine == ref


def test_async_save_survives_an_in_place_adamw_step(tmp_path):
    """An async save copies every leaf to the host before it returns: the
    in-place AdamW update right after it does not reach the checkpoint,
    which restores the pre-step params and state."""
    params = {"w": torch.randn(64, 32), "b": torch.randn(32).to(torch.bfloat16)}
    opt = optim.get("adamw")
    state = opt.init(params)
    grads = {"w": torch.ones(64, 32), "b": torch.ones(32, dtype=torch.bfloat16)}
    opt.update(grads, state, params, 1e-2)          # state["step"] == 1
    before = {k: v.clone() for k, v in params.items()}
    master = state["master"]["w"].clone()
    h = ckpt.save(tmp_path, params, step=1, async_=True)
    hs = ckpt.save(tmp_path / "opt", state, step=1, async_=True)
    opt.update(grads, state, params, 1e-2)          # in place
    h.join()
    hs.join()
    assert not torch.equal(params["w"], before["w"])
    got, _, _ = ckpt.restore(tmp_path, params)
    assert_tree_equal(before, got)
    got_state, _, _ = ckpt.restore(tmp_path / "opt", opt.init(params))
    assert got_state["step"] == 1 and isinstance(got_state["step"], int)
    assert torch.equal(got_state["master"]["w"], master)


# ---------------------------------------------------------------------------
# The train launcher: --ckpt, --ckpt-every, --resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "musicgen-large"])
def test_resumed_launcher_run_equals_the_uninterrupted_run(tmp_path, arch):
    """Six steps straight, against three steps with ``--ckpt-every 2`` (a
    checkpoint at step 2), then ``--resume`` to six: the resumed run starts
    from step 2 and its losses, params and optimizer state equal the
    uninterrupted run's bit for bit; the checkpoint of step 6 too."""
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--global-batch",
            "4", "--seq", "16", "--lr", "1e-2"]
    straight = train_main(base + ["--steps", "6", "--ckpt",
                                  str(tmp_path / "a"), "--ckpt-every", "2"])
    d = str(tmp_path / "b")
    cut = train_main(base + ["--steps", "3", "--ckpt", d, "--ckpt-every",
                             "2"])
    assert ckpt.latest_step(d) == 2 and ckpt.latest_step(d + "/opt") == 2
    resumed = train_main(base + ["--steps", "6", "--ckpt", d,
                                 "--ckpt-every", "2", "--resume"])
    assert resumed.start_step == 2 and len(resumed.losses) == 4
    assert cut.losses == straight.losses[:3]
    assert resumed.losses == straight.losses[2:]
    assert_tree_equal(straight.params, resumed.params)
    assert_tree_equal({k: v for k, v in straight.opt_state.items()
                       if k != "step"},
                      {k: v for k, v in resumed.opt_state.items()
                       if k != "step"})
    assert resumed.opt_state["step"] == straight.opt_state["step"] == 6
    like = straight.params
    a, _, _ = ckpt.restore(tmp_path / "a", like)
    b, _, meta = ckpt.restore(d, like)
    assert_tree_equal(a, b)
    assert meta["arch"] == straight.cfg.name
    ft = resumed.ft
    assert ft is not None and len(ft.workers[0].step_times) == 4
    assert ft.healthy_workers() == [0]
    assert not list(pathlib.Path(d).glob(".tmp_step_*"))
