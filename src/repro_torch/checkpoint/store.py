"""Checkpointing with atomic commits, async save and validated restore.

The port's copy of ``repro/checkpoint/store.py``, on the same on-disk
format, one directory per step:

    <root>/step_00000123/
        meta.json            -- step, tree structure, shapes/dtypes, health
        arrays.npz           -- flat {"a<i>": np.ndarray}, host copies
        COMMIT               -- written LAST; absence = incomplete/corrupt

  * Atomic: a save writes ``step_X.tmp`` and renames it with
    ``os.replace``; readers trust only directories holding COMMIT, so a
    preemption mid-save never corrupts the latest good checkpoint.
  * Async: :meth:`CheckpointManager.save_async` copies the tree to host
    memory synchronously and writes it on a thread; a thread's error is
    raised at the next :meth:`~CheckpointManager.wait`.
  * Validated: restore checks the leaf count, every shape and dtype against
    ``meta.json``, and recomputes the numerics-health snapshot.
  * Retention: ``keep_last`` newest COMMITted steps.

Trees are flattened by :mod:`repro_torch.tree` in the leaf order
``jax.tree.flatten`` gives. ``meta.json``'s ``treedef`` is the
port's own string; neither package's reader compares it. A ``{field:
array}`` tree is therefore cross-readable: a checkpoint the port writes
restores through ``repro.checkpoint.restore_checkpoint`` and the other way
round. LM training checkpoints are not: the JAX package stacks each block
of a superblock on a leading ``n_super`` axis, the port keeps one block a
layer.

Leaves are saved as numpy arrays. bfloat16 has no numpy dtype where
``ml_dtypes`` is not installed, and the port writes no encoding of its own:
saving a bfloat16 leaf raises a ``TypeError`` naming it.

**Pieces.** With ``shardings`` (a tree of
:class:`~repro_torch.dist.sharding.NamedSharding` matching the tree), the
tree holds this rank's pieces: every rank calls the save, each leaf is
gathered whole onto rank 0's host one leaf at a time (bfloat16 widened to
float32 there, which is exact), rank 0 writes the format above, and every
rank returns once COMMIT is written. The gathers run on the calling
thread; :class:`CheckpointManager` writes on its thread only after them.
A restore with ``shardings`` reads each whole leaf, checks it as above and
keeps this rank's piece: checkpoints are mesh-agnostic, so a relaunch on
another mesh (or on one device) re-shards them.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_flatten_with_paths, tree_unflatten


def _host_array(x: Any, path: str, *, copy: bool) -> np.ndarray:
    """One leaf as a numpy array on the host; with ``copy``, one that shares
    no storage with the leaf (a CPU tensor's ``.numpy()`` would)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {path} is bfloat16, which numpy cannot hold here; "
                "cast it to float32 before saving")
        return x.detach().to("cpu", copy=copy).numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)


def host_tree(tree: Any, shardings: Any = None) -> Any:
    """``tree`` with every leaf a host numpy copy (the async snapshot). With
    ``shardings`` the leaves are this rank's pieces, gathered whole onto
    rank 0 (:func:`~repro_torch.dist.sharding.gather_to_host`, bfloat16
    widened to float32): rank 0 gets the tree, the other ranks ``None``."""
    leaves, paths, treedef = tree_flatten_with_paths(tree)
    if shardings is None:
        return tree_unflatten(treedef, [_host_array(x, p, copy=True)
                                        for x, p in zip(leaves, paths)])
    from repro_torch.dist.sharding import gather_to_host

    shs = tree_flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(shs)} shardings for {len(leaves)} leaves")
    out = []
    for x, p, sh in zip(leaves, paths, shs):
        whole = gather_to_host(torch.as_tensor(x), sh)
        if whole is not None:
            out.append(_host_array(whole.float() if whole.dtype == torch.bfloat16 else whole, p,
                                   copy=False))
    return tree_unflatten(treedef, out) if out else None


def _agree(mesh, failed: bool) -> bool:
    """Whether any rank of ``mesh`` failed (a max over the mesh): every rank
    leaves a collective save together, raising together."""
    from repro_torch.dist.sharding import all_reduce

    flag = torch.tensor(float(failed), device="cpu" if mesh.backend == "gloo" else mesh.device)
    return bool(all_reduce(flag, torch.distributed.ReduceOp.MAX, mesh).item())


def tree_health(host_leaves: list[np.ndarray]) -> dict:
    """Aggregate numerics-health snapshot of a checkpoint's host leaves:
    NaN/Inf counts and the global L2 norm, accumulated in float64 so the
    save-time and restore-time computations agree bit for bit on identical
    bytes (and with the JAX package's, which is the same code). Embedded in
    ``meta.json`` at save and recomputed at restore."""
    nan = inf = n = 0
    sumsq = 0.0
    for a in host_leaves:
        n += a.size
        if np.issubdtype(a.dtype, np.floating) or np.issubdtype(a.dtype, np.complexfloating):
            nan += int(np.isnan(a).sum())
            inf += int(np.isinf(a).sum())
            finite = np.asarray(a)[np.isfinite(a)]
            # |z|^2: np.abs is exact for real floats and makes complex leaves work.
            sumsq += float(np.sum(np.square(np.abs(finite), dtype=np.float64)))
        else:
            sumsq += float(np.sum(np.square(a.astype(np.float64))))
    return {
        "n_elements": int(n),
        "nan_count": int(nan),
        "inf_count": int(inf),
        "l2": float(np.sqrt(sumsq)),
    }


def save_checkpoint(root: str | Path, step: int, tree: Any, extra: dict | None = None,
                    shardings: Any = None) -> Path:
    """Synchronous atomic save of ``tree`` (tensors, numpy arrays or
    scalars in dicts, lists, tuples, NamedTuples). Returns the step's
    directory. With ``shardings`` every rank calls it with its pieces
    (:func:`host_tree`); rank 0 writes and all return after COMMIT."""
    if shardings is not None:
        mesh = tree_flatten(shardings)[0][0].mesh
        snapshot, error = host_tree(tree, shardings), None
        if snapshot is not None:
            try:
                save_checkpoint(root, step, snapshot, extra)
            except BaseException as e:  # noqa: BLE001 - raised after the ranks agree
                error = e
        if _agree(mesh, error is not None):
            raise error or RuntimeError(f"checkpoint step {step}: rank 0 failed to write it")
        return Path(root) / f"step_{step:08d}"
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves, paths, treedef = tree_flatten_with_paths(tree)
    host_leaves = [_host_array(x, p, copy=False) for x, p in zip(leaves, paths)]
    np.savez(tmp / "arrays.npz", **{f"a{i}": a for i, a in enumerate(host_leaves)})
    meta = {
        "step": step,
        "treedef": f"repro_torch.TreeDef({treedef})",
        "n_leaves": len(host_leaves),
        "shapes": [list(a.shape) for a in host_leaves],
        "dtypes": [str(a.dtype) for a in host_leaves],
        "health": tree_health(host_leaves),
        "extra": extra or {},
        "time": time.time(),
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    (tmp / "COMMIT").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(root: str | Path) -> int | None:
    """The newest COMMITted step under ``root``, or None."""
    root = Path(root)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.iterdir()
        if p.is_dir() and p.name.startswith("step_") and (p / "COMMIT").exists()
    ]
    return max(steps) if steps else None


def _like_dtype(r: Any):
    """The torch dtype a restored leaf takes: the target leaf's."""
    if isinstance(r, torch.Tensor):
        return r.dtype
    return torch.from_numpy(np.zeros((), np.asarray(r).dtype)).dtype


def restore_checkpoint(
    root: str | Path,
    step: int | None,
    tree_like: Any,
    device=None,
    *,
    shardings: Any = None,
    verify_health: bool = True,
) -> tuple[Any, dict]:
    """Restores step ``step`` (None: the latest) into the structure of
    ``tree_like``; returns ``(tree of tensors, extra)``. Each leaf takes the
    dtype of its ``tree_like`` leaf and lands on ``device``, or else on the
    device of its ``tree_like`` leaf (the CPU for numpy leaves). With
    ``shardings`` (a matching tree of
    :class:`~repro_torch.dist.sharding.NamedSharding`) ``tree_like`` holds
    this rank's pieces, and each whole leaf is cut to this rank's piece on
    the CURRENT mesh: the elastic re-mesh path.

    ``arrays.npz`` is never trusted blindly: every leaf's shape and dtype is
    checked against ``meta.json`` (a ``ValueError`` naming the leaf), and
    with ``verify_health`` the meta's numerics-health snapshot is
    recomputed and compared, so a corrupted payload fails at load."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints under {root}")
    d = root / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {d} has no COMMIT marker")
    meta = json.loads((d / "meta.json").read_text())
    with np.load(d / "arrays.npz") as z:
        missing = [f"a{i}" for i in range(meta["n_leaves"]) if f"a{i}" not in z]
        if missing:
            raise ValueError(
                f"checkpoint {d}: arrays.npz is missing leaves {missing} "
                f"recorded in meta.json — the payload is corrupt or truncated"
            )
        host_leaves = [z[f"a{i}"] for i in range(meta["n_leaves"])]

    for i, a in enumerate(host_leaves):
        want_shape = tuple(meta["shapes"][i])
        want_dtype = meta["dtypes"][i]
        if tuple(a.shape) != want_shape or str(a.dtype) != want_dtype:
            raise ValueError(
                f"checkpoint {d} leaf a{i}: arrays.npz has shape "
                f"{tuple(a.shape)} dtype {a.dtype} but meta.json recorded "
                f"shape {want_shape} dtype {want_dtype} — the checkpoint "
                f"payload is corrupt (or meta.json was tampered with)"
            )
    if verify_health and "health" in meta:
        want, got = meta["health"], tree_health(host_leaves)
        counts_ok = all(got[k] == want[k] for k in ("n_elements", "nan_count", "inf_count"))
        l2_ok = np.isclose(got["l2"], want["l2"], rtol=1e-9, atol=0.0)
        if not (counts_ok and l2_ok):
            raise ValueError(
                f"checkpoint {d}: health snapshot mismatch — meta.json "
                f"recorded {want} but arrays.npz recomputes to {got}; the "
                f"payload bytes changed since save (bit rot / partial write)"
            )

    ref_leaves, treedef = tree_flatten(tree_like)
    if len(ref_leaves) != len(host_leaves):
        raise ValueError(
            f"checkpoint has {len(host_leaves)} leaves, target structure has {len(ref_leaves)}"
        )
    if shardings is not None:
        shs = tree_flatten(shardings)[0]
        if len(shs) != len(ref_leaves):
            raise ValueError(f"{len(shs)} shardings for {len(ref_leaves)} leaves")
        host_leaves = [sh.piece(torch.from_numpy(np.asarray(h, order="C"))).numpy()
                       for h, sh in zip(host_leaves, shs)]
    for i, (h, r) in enumerate(zip(host_leaves, ref_leaves)):
        if tuple(h.shape) != tuple(np.shape(r)):
            raise ValueError(f"leaf {i}: checkpoint shape {h.shape} != target {np.shape(r)}")

    def place(h: np.ndarray, r: Any) -> torch.Tensor:
        dev = device if device is not None else (
            r.device if isinstance(r, torch.Tensor) else "cpu")
        return torch.from_numpy(np.asarray(h, order="C")).to(device=dev, dtype=_like_dtype(r))

    return tree_unflatten(treedef, [place(h, r) for h, r in zip(host_leaves, ref_leaves)]), \
        meta["extra"]


class CheckpointManager:
    """Async, retention-managed checkpointing for the train loop. With a
    ``mesh`` every rank calls :meth:`save_async` and :meth:`wait` at the
    same points (both are collectives): rank 0 writes, and :meth:`wait`
    returns on every rank once its write is done, raising on every rank
    if it failed."""

    def __init__(self, root: str | Path, keep_last: int = 3, mesh=None):
        self.root = Path(root)
        self.keep_last = keep_last
        self.mesh = mesh
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, step: int, tree: Any, extra: dict | None = None,
                   shardings: Any = None) -> None:
        """Copies ``tree`` to host memory now (with ``shardings``: gathers
        its pieces onto rank 0's host, :func:`host_tree`), writes it on a
        thread."""
        self.wait()  # one in-flight save at a time
        snapshot = host_tree(tree, shardings)
        if snapshot is None:
            return

        def _write():
            try:
                save_checkpoint(self.root, step, snapshot, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - raised at the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Joins the in-flight save; raises its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self.mesh is not None and _agree(self.mesh, err is not None):
            raise err or RuntimeError("a checkpoint write failed on rank 0")
        if err is not None:
            raise err

    def _gc(self) -> None:
        steps = sorted(
            p for p in self.root.iterdir()
            if p.is_dir() and p.name.startswith("step_") and (p / "COMMIT").exists()
        )
        for p in steps[: -self.keep_last]:
            shutil.rmtree(p, ignore_errors=True)
