"""A pool of spawned ranks joined in one process group, for jobs with a deadline.

`RankPool(world_size, backend)` spawns `world_size` processes (spawn, never
fork: the parent may hold CUDA or other threads), joins them through a
`file://` rendezvous in `workdir` (`initialize_runtime`), and keeps them for
many jobs: `pool.run(fn, *args)` calls `fn(*args)` on every rank and returns
the ranks' results in rank order. `fn` must be importable by the children
(a module-level function of an importable module, or of the script run as
`__main__`).

No job hangs its caller. Every collective carries the group's timeout, and
`run` waits at most `deadline_s`: past it, or when a rank fails or dies, the
pool kills every rank and raises, naming the ranks and their tracebacks.
The next `run` spawns a fresh pool, so one failed job fails one caller.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait

__all__ = ["RankPool", "RankError"]


class RankError(RuntimeError):
    """A rank of a RankPool failed, died or missed the deadline."""


def _worker(rank: int, world: int, backend: str, init: str, conn, timeout_s: float,
            threads: int) -> None:
    import torch
    import torch.distributed as dist

    from .mesh import initialize_runtime

    torch.set_num_threads(threads)
    try:
        initialize_runtime(init, world, rank, backend=backend, timeout_s=timeout_s)
        conn.send(("ok", None))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        conn.send(("err", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg is None:
                break
            fn, args, kwargs = msg
            try:
                out = ("ok", fn(*args, **kwargs))
            except BaseException:  # noqa: BLE001 - reported to the parent
                out = ("err", traceback.format_exc())
            conn.send(out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """`world_size` spawned ranks in one torch.distributed group."""

    def __init__(self, world_size: int, backend: str = "gloo", workdir: "str | None" = None,
                 timeout_s: float = 120.0, threads: int = 1):
        self.world_size = int(world_size)
        self.backend = backend
        self.workdir = workdir or tempfile.mkdtemp(prefix="rankpool-")
        self.timeout_s = float(timeout_s)
        self.threads = int(threads)
        self._procs: list = []
        self._conns: list = []
        self._starts = 0
        self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._starts += 1
        store = os.path.join(self.workdir, f"rendezvous-{os.getpid()}-{id(self)}-{self._starts}")
        if os.path.exists(store):
            os.unlink(store)
        for rank in range(self.world_size):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, daemon=True, args=(
                rank, self.world_size, self.backend, f"file://{store}", child, self.timeout_s,
                self.threads))
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._collect(self.timeout_s, "join the process group")

    def _collect(self, deadline_s: float, what: str) -> list:
        """Every rank's reply, or kill the pool and raise."""
        results = [None] * self.world_size
        errors: dict = {}
        pending = dict(enumerate(self._conns))
        end = time.monotonic() + deadline_s
        while pending:
            ready = wait(list(pending.values()), timeout=max(end - time.monotonic(), 0.0))
            if not ready:
                break
            for rank in [r for r, c in pending.items() if c in ready]:
                conn = pending.pop(rank)
                try:
                    status, payload = conn.recv()
                except (EOFError, OSError):
                    status, payload = "err", f"rank {rank} died (exit code " \
                                             f"{self._procs[rank].exitcode})"
                if status == "ok":
                    results[rank] = payload
                else:
                    errors[rank] = payload
                    # the others may be blocked in a collective with it
                    end = min(end, time.monotonic() + 5.0)
        if errors or pending:
            self.close(kill=True)
            lines = [f"--- rank {r}:\n{tb}" for r, tb in sorted(errors.items())]
            if pending:
                lines.append(f"ranks {sorted(pending)} did not {what} within the deadline")
            raise RankError(f"{len(errors) + len(pending)} of {self.world_size} ranks failed to "
                            f"{what}:\n" + "\n".join(lines))
        return results

    def run(self, fn, *args, deadline_s: "float | None" = None, **kwargs) -> list:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        if not self._procs:
            self._start()
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        return self._collect(self.timeout_s if deadline_s is None else deadline_s,
                             f"run {getattr(fn, '__name__', fn)}")

    def close(self, kill: bool = False) -> None:
        """Stop every rank (at once with kill=True)."""
        for conn in self._conns:
            if not kill:
                try:
                    conn.send(None)
                except (BrokenPipeError, OSError):
                    pass
        for proc in self._procs:
            if not kill:
                proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
