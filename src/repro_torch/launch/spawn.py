"""Running SPMD ranks as spawned processes on one host.

:func:`run_ranks` starts ``world`` processes (``multiprocessing``'s spawn
method), each calling ``fn(rank, world, store, *args)`` where ``store`` is
the path of a ``torch.distributed.FileStore`` for the ranks to join one
process group through (``fn`` initialises the group itself, with the
backend it wants). Each rank's return value comes back pickled, in rank
order. A rank that raises ends the run: its peers, which would otherwise
wait in their next collective, are killed, and the parent raises with
every failed rank's traceback.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from pathlib import Path


def _entry(fn, rank: int, world: int, store: str, out: str, args: tuple) -> None:
    try:
        status = ("ok", fn(rank, world, store, *args))
    except Exception:  # noqa: BLE001 - carried to the parent
        status = ("error", traceback.format_exc())
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(status, f)
    if status[0] != "ok":
        os._exit(1)


def run_ranks(fn, world: int, work_dir, *args, timeout: float) -> list:
    """``[fn(r, world, store, *args) for r in range(world)]``, each in its own
    spawned process; the store and result files go under ``work_dir``.
    Raises ``RuntimeError`` if a rank fails and ``TimeoutError`` if the
    ranks outlive ``timeout`` seconds."""
    ctx = multiprocessing.get_context("spawn")
    stem = Path(work_dir) / f"ranks.{os.getpid()}.{time.monotonic_ns()}"
    store, out = f"{stem}.store", f"{stem}.out"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, store, out, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        # Poll, so that one failed rank ends the run instead of leaving its
        # peers blocked in a collective until the deadline.
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    results, errors = [], []
    for r in range(world):
        path = Path(f"{out}.{r}")
        status, value = pickle.loads(path.read_bytes()) if path.exists() else (
            "error", f"rank {r} left no result (exit code {procs[r].exitcode})")
        if status != "ok":
            errors.append(f"--- rank {r} ---\n{value}")
        results.append(value)
    for path in stem.parent.glob(f"{stem.name}.*"):
        path.unlink()
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(errors))
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s")
    return results
