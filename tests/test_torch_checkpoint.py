"""The port's checkpoint store against the JAX package's on the CPU.

The statements of the reference store tests (``tests/test_fault_tolerance.py``
and ``tests/test_substrate.py``) held against ``repro_torch.checkpoint``,
then the two packages reading each other's ``{u, v, h}`` checkpoints, and
``tree_health`` equal to the JAX package's to rtol 1e-9 (the bound both
readers apply to the L2).
"""

import json
import threading

import numpy as np
import pytest
import torch

import repro.checkpoint as jax_ckpt
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    tree_health,
)
from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

FIELDS = ("u", "v", "h")


def _save_small(root):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.float32)}
    save_checkpoint(root, 5, tree, {"note": "t"})
    return tree


def _restore(root, tree, **kwargs):
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    return restore_checkpoint(root, 5, like, **kwargs)


def _rewrite(root, edit):
    d = root / "step_00000005"
    with np.load(d / "arrays.npz") as z:
        arrays = {k: z[k] for k in z.files}
    edit(arrays)
    np.savez(d / "arrays.npz", **arrays)


# -- the reference's corrupted-checkpoint statements -------------------------------


def test_restore_rejects_wrong_leaf_shape(tmp_path):
    tree = _save_small(tmp_path)
    _rewrite(tmp_path, lambda a: a.update(a0=a["a0"][:1]))
    with pytest.raises(ValueError, match=r"leaf a0.*corrupt"):
        _restore(tmp_path, tree)


def test_restore_rejects_wrong_leaf_dtype(tmp_path):
    tree = _save_small(tmp_path)
    _rewrite(tmp_path, lambda a: a.update(a1=a["a1"].astype(np.float64)))
    with pytest.raises(ValueError, match=r"leaf a1.*dtype"):
        _restore(tmp_path, tree)


def test_restore_rejects_missing_leaf(tmp_path):
    tree = _save_small(tmp_path)
    _rewrite(tmp_path, lambda a: a.pop("a1"))
    with pytest.raises(ValueError, match=r"missing leaves \['a1'\]"):
        _restore(tmp_path, tree)


def test_restore_verifies_health_snapshot(tmp_path):
    tree = _save_small(tmp_path)
    _rewrite(tmp_path, lambda a: a.update(a1=a["a1"] * 2.0))
    with pytest.raises(ValueError, match="health snapshot mismatch"):
        _restore(tmp_path, tree)
    state, extra = _restore(tmp_path, tree, verify_health=False)
    assert extra == {"note": "t"}

    def nan(a):
        a["a1"] = np.ones((2, 3), dtype=np.float32)
        a["a1"][0, 0] = np.nan
    _rewrite(tmp_path, nan)
    with pytest.raises(ValueError, match="health snapshot mismatch"):
        _restore(tmp_path, tree)


def test_save_records_health_snapshot_and_clean_restore_passes(tmp_path):
    tree = _save_small(tmp_path)
    meta = json.loads((tmp_path / "step_00000005" / "meta.json").read_text())
    h = meta["health"]
    assert h["n_elements"] == 10 and h["nan_count"] == 0 and h["inf_count"] == 0
    want_l2 = float(np.sqrt(sum((v.double() ** 2).sum().item() for v in tree.values())))
    assert np.isclose(h["l2"], want_l2, rtol=1e-12)
    state, _ = _restore(tmp_path, tree)
    assert torch.equal(state["w"], tree["w"])


def test_checkpoint_roundtrip_complex_leaves(tmp_path):
    c = (np.arange(6) + 1j * np.arange(6, 0, -1)).astype(np.complex64).reshape(2, 3)
    c[0, 0] = np.nan + 0j
    tree = {"c": torch.from_numpy(c), "w": torch.ones(3)}
    save_checkpoint(tmp_path, 5, tree)
    h = json.loads((tmp_path / "step_00000005" / "meta.json").read_text())["health"]
    assert h["nan_count"] == 1
    finite = c[np.isfinite(c)]
    want_l2 = float(np.sqrt((np.abs(finite).astype(np.float64) ** 2).sum() + 3.0))
    assert np.isclose(h["l2"], want_l2, rtol=1e-12)
    state, _ = _restore(tmp_path, tree)
    np.testing.assert_array_equal(state["c"].numpy(), c)


# -- the reference's substrate statements ------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "s": torch.tensor(7, dtype=torch.int32)}
    save_checkpoint(tmp_path, 3, tree, {"step": 3})
    assert latest_step(tmp_path) == 3
    restored, extra = restore_checkpoint(tmp_path, None, tree)
    assert torch.equal(restored["w"], tree["w"])
    assert restored["s"].shape == () and int(restored["s"]) == 7
    assert restored["s"].dtype == torch.int32
    assert extra["step"] == 3


def test_checkpoint_ignores_uncommitted(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(2)})
    (tmp_path / "step_00000002").mkdir()  # a torn save at step 2
    assert latest_step(tmp_path) == 1
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        restore_checkpoint(tmp_path, 2, {"w": torch.ones(2)})


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 0, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, 0, {"w": torch.ones((3, 3))})
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(tmp_path, 0, {"w": torch.ones((2, 2)), "x": torch.ones(1)})


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"w": torch.full((2,), float(s))})
    mgr.wait()
    assert latest_step(tmp_path) == 4
    kept = sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]


# -- what the port adds: trees, snapshots, errors, device placement ---------------------


def test_tree_flatten_orders_leaves_as_jax_does():
    import jax

    tree = {"b": [np.ones(1), (np.zeros(2), None)], "a": {"y": np.ones(3), "x": np.ones(4)}}
    leaves, treedef = tree_flatten(tree)
    want = jax.tree.leaves(tree)
    assert [x.shape for x in leaves] == [x.shape for x in want]
    assert tree_unflatten(treedef, leaves)["b"][1][1] is None
    st = AdamWState(torch.tensor(1), {"w": torch.ones(2)}, {"w": torch.zeros(2)})
    back = tree_map(lambda t: t + 1, st)
    assert isinstance(back, AdamWState) and int(back.step) == 2
    assert "AdamWState(step=*" in str(tree_flatten(st)[1])


def test_save_async_snapshots_before_the_caller_updates_in_place(tmp_path):
    w = torch.zeros(1000)
    mgr = CheckpointManager(tmp_path)
    gate = threading.Event()
    orig = CheckpointManager._gc

    def slow_gc(self):
        gate.wait(10)
        orig(self)
    mgr._gc = slow_gc.__get__(mgr)
    mgr.save_async(1, {"w": w})
    w += 5.0  # the train step's in-place update, while the write is in flight
    gate.set()
    mgr.wait()
    state, _ = restore_checkpoint(tmp_path, 1, {"w": w})
    assert torch.equal(state["w"], torch.zeros(1000))


def test_save_async_raises_the_threads_error_at_wait(tmp_path):
    mgr = CheckpointManager(tmp_path / "file")
    (tmp_path / "file").write_text("not a directory")
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # reported once


def test_bfloat16_leaf_raises_naming_it(tmp_path):
    with pytest.raises(TypeError, match=r"\['mu'\]\['w'\].*bfloat16"):
        save_checkpoint(tmp_path, 0, {"mu": {"w": torch.ones(2, dtype=torch.bfloat16)}})
    assert latest_step(tmp_path) is None


def test_restore_places_leaves_and_takes_the_target_dtype(tmp_path):
    state = AdafactorState(torch.tensor(4, dtype=torch.int32), {"w": torch.ones(2, 3)},
                           {"w": torch.ones(3)})
    save_checkpoint(tmp_path, 4, state)
    like = AdafactorState(torch.tensor(0, dtype=torch.int32),
                          {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}, {"w": np.zeros(3)})
    got, _ = restore_checkpoint(tmp_path, 4, like)
    assert isinstance(got, AdafactorState) and int(got.step) == 4
    assert got.vr["w"].dtype == torch.bfloat16 and got.vc["w"].dtype == torch.float64
    meta = got.vr["w"].device
    got, _ = restore_checkpoint(tmp_path, 4, like, device="meta")
    assert got.vr["w"].device.type == "meta" and meta.type == "cpu"


# -- the two packages read each other's {u, v, h} checkpoints -------------------------


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal((4, 24, 24)).astype(np.float32) for f in FIELDS}


def test_port_checkpoint_restores_through_the_jax_package(tmp_path):
    host = _fields(1)
    save_checkpoint(tmp_path, 6, {f: torch.from_numpy(a) for f, a in host.items()},
                    {"step": 6, "fields": list(FIELDS)})
    assert jax_ckpt.latest_step(tmp_path) == 6
    like = {f: np.zeros((4, 24, 24), np.float32) for f in FIELDS}
    state, extra = jax_ckpt.restore_checkpoint(tmp_path, 6, like)
    assert extra["fields"] == list(FIELDS)
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(state[f]), host[f])


def test_jax_checkpoint_restores_through_the_port(tmp_path):
    import jax.numpy as jnp

    host = _fields(2)
    jax_ckpt.save_checkpoint(tmp_path, 9, {f: jnp.asarray(a) for f, a in host.items()},
                             {"step": 9})
    like = {f: torch.zeros((4, 24, 24)) for f in FIELDS}
    state, extra = restore_checkpoint(tmp_path, None, like)
    assert extra == {"step": 9}
    for f in FIELDS:
        np.testing.assert_array_equal(state[f].numpy(), host[f])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_health_equals_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    leaves = [rng.standard_normal((7, 5)).astype(np.float32) * 1e3,
              rng.integers(-9, 9, (4,)).astype(np.int32),
              (rng.standard_normal(3) + 1j).astype(np.complex64)]
    leaves[0][1, 1] = np.inf
    leaves[0][2, 2] = np.nan
    got, want = tree_health(leaves), jax_ckpt.tree_health(leaves)
    assert {k: got[k] for k in ("n_elements", "nan_count", "inf_count")} == \
        {k: want[k] for k in ("n_elements", "nan_count", "inf_count")}
    assert np.isclose(got["l2"], want["l2"], rtol=1e-9, atol=0.0)
