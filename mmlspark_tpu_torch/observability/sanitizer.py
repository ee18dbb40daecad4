"""Runtime lock-order sanitizer: GoodLock-style cycle detection on live
acquisitions.

A copy of mmlspark_tpu/observability/sanitizer.py.

Static analysis (tools/graftlint R2) sees every lock the SOURCE can
nest; this module sees every nesting a RUN actually performs, including
orders that only materialize under a particular interleaving of the
serving batcher, gateway prober, prefetcher, and profiler drainer
threads. The two passes share one vocabulary: a lock made by
``make_lock("ServingServer._counter_lock")`` appears under that name in
both the static graph and the runtime graph, so a finding from either
side points at the same code.

Design (after GoodLock, Havelund 2000): every sanitized acquisition
adds edges ``held -> acquiring`` to a process-wide name-level graph.
An acquisition that closes a path back to a lock the thread already
holds is a potential-deadlock cycle — reported even when the run never
actually deadlocks, which is the point: the interleaving that WOULD
deadlock may be rare, the ordering evidence is not. ``note_blocking``
hooks (installed into ``resilience.policy.SystemClock.sleep`` and
``utils.storage`` fsync paths) report blocking calls made while any
sanitized lock is held — the runtime twin of graftlint R3.

Zero-cost when off: ``make_lock`` returns a plain ``threading.Lock``
unless ``MMLSPARK_TPU_SANITIZE=1`` is set or ``enable()`` was called
first, so production paths never pay the bookkeeping. Locks created
while the sanitizer is off stay plain — enable (or set the env var)
BEFORE constructing the objects under test.

Stdlib-only on purpose: every threaded module in the package imports
(directly or lazily) from here, so this module imports from none of
them. The flight recorder is reached lazily at violation time.
"""

from __future__ import annotations

import os
import threading
import traceback

__all__ = [
    "LockOrderError",
    "SanitizedLock",
    "allow_blocking",
    "enable",
    "disable",
    "enabled",
    "held_locks",
    "make_lock",
    "make_rlock",
    "note_blocking",
    "reset",
    "snapshot",
    "violations",
]


class LockOrderError(RuntimeError):
    """A lock-order cycle or hold-while-blocking violation (raised only
    under hard-fail — env ``MMLSPARK_TPU_SANITIZE=1`` or
    ``enable(hard_fail=True)``)."""


# -- global state --------------------------------------------------------- #

_ENV_FLAG = "MMLSPARK_TPU_SANITIZE"

_state_lock = threading.Lock()      # guards the graph + violation list
_enabled = False
_hard_fail = False
_recorder = None                    # FlightRecorder | None (explicit bind)
# name -> {name -> {"thread", "site"}}: edge A->B means some thread
# acquired B while holding A; the info records the FIRST witness.
_order_graph: dict[str, dict[str, dict]] = {}
_violations: list[dict] = []

_tls = threading.local()            # .held: list[SanitizedLock]


def _env_on() -> bool:
    return os.environ.get(_ENV_FLAG, "") not in ("", "0")


def _held_stack() -> "list[SanitizedLock]":
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _acquire_site() -> str:
    """file:line of the frame that called acquire (skipping this module)."""
    for frame in reversed(traceback.extract_stack(limit=8)[:-2]):
        if not frame.filename.endswith("sanitizer.py"):
            return f"{os.path.basename(frame.filename)}:{frame.lineno}"
    return "?"


# -- control surface ------------------------------------------------------ #

def enable(hard_fail: "bool | None" = None, recorder=None) -> None:
    """Turn the sanitizer on for locks created FROM NOW ON. ``hard_fail``
    defaults to the env flag; ``recorder`` binds an explicit
    FlightRecorder for violation events + dumps (otherwise the package
    default recorder is used, reached lazily)."""
    global _enabled, _hard_fail, _recorder
    _enabled = True
    if hard_fail is not None:
        _hard_fail = bool(hard_fail)
    if recorder is not None:
        _recorder = recorder


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled or _env_on()


def reset() -> None:
    """Drop the acquisition graph, violations, and recorder binding
    (test isolation; live SanitizedLocks keep working and re-populate)."""
    global _order_graph, _violations, _recorder, _enabled, _hard_fail
    with _state_lock:
        _order_graph = {}
        _violations = []
    _recorder = None
    _enabled = False
    _hard_fail = False


def violations() -> "list[dict]":
    with _state_lock:
        return [dict(v) for v in _violations]


def snapshot() -> dict:
    """{"edges": [{"src", "dst", "thread", "site"}], "violations": [...]}
    — the live acquisition graph for tests and postmortems."""
    with _state_lock:
        edges = [{"src": a, "dst": b, **info}
                 for a, dsts in _order_graph.items()
                 for b, info in dsts.items()]
        return {"edges": edges, "violations": [dict(v) for v in _violations]}


def held_locks() -> "list[str]":
    """Names of sanitized locks the CALLING thread currently holds."""
    return [lk.name for lk in _held_stack()]


# -- violation reporting -------------------------------------------------- #

def _report(kind: str, detail: dict) -> None:
    # detail stays kind-free: it is re-passed as **kwargs to
    # recorder.record(kind, ...) where a "kind" key would collide
    entry = {"kind": kind, **detail}
    with _state_lock:
        _violations.append(entry)
    rec = _recorder
    if rec is None:
        try:  # lazy: sanitizer must not import observability eagerly
            from .recorder import get_recorder
            rec = get_recorder()
        except Exception:  # noqa: BLE001 — reporting never masks the bug
            rec = None
    if rec is not None:
        try:
            rec.record(f"sanitizer.{kind}", **detail)
            rec.trigger_dump(f"sanitizer.{kind}", force=True)
        except Exception:  # noqa: BLE001
            pass
    if _hard_fail or _env_on():
        raise LockOrderError(f"sanitizer: {kind}: {detail}")


def _path(src: str, dst: str) -> "list[str] | None":
    """A path src -> ... -> dst in the order graph (caller holds
    _state_lock), or None."""
    stack = [(src, [src])]
    seen = {src}
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        for nxt in _order_graph.get(node, {}):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


class _AllowBlocking:
    """Context manager minted by :func:`allow_blocking`."""

    __slots__ = ("reason",)

    def __init__(self, reason: str):
        self.reason = reason

    def __enter__(self) -> "_AllowBlocking":
        _tls.allow = getattr(_tls, "allow", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _tls.allow = getattr(_tls, "allow", 1) - 1


def allow_blocking(reason: str) -> _AllowBlocking:
    """Acknowledge that the enclosed region blocks while holding locks.

    For stop-the-world sections — WAL/journal ``compact()`` rewrites —
    where excluding writers across the blocking call IS the correctness
    requirement. The runtime analogue of a baseline entry: the
    justification string lives in the source, at the site. Lock-order
    cycle detection stays fully active inside the region; only the
    hold-while-blocking report is waived."""
    return _AllowBlocking(reason)


def note_blocking(op: str) -> None:
    """Report `op` (a blocking call: sleep, fsync, socket wait) if the
    calling thread holds any sanitized lock — the runtime R3 check.
    Installed as a hook; free when no sanitized locks exist. Locks
    created with ``blocking_ok=True`` (coarse mutexes whose holder does
    I/O by design) and :func:`allow_blocking` regions are exempt."""
    held = [lk for lk in _held_stack() if not lk.blocking_ok]
    if not held or getattr(_tls, "allow", 0):
        return
    _report("blocking_under_lock", {
        "op": op,
        "locks": [lk.name for lk in held],
        "thread": threading.current_thread().name,
        "site": _acquire_site(),
    })


# -- the lock wrapper ----------------------------------------------------- #

class SanitizedLock:
    """threading.Lock/RLock wrapper that records the acquisition graph.

    Context-manager + acquire/release compatible, so it drops in
    anywhere a plain lock is used. Reentrant acquisitions (RLock) do
    not re-enter the graph.
    """

    __slots__ = ("name", "blocking_ok", "_lock", "_reentrant", "_depth")

    def __init__(self, name: str, reentrant: bool = False,
                 blocking_ok: bool = False):
        self.name = name
        self.blocking_ok = bool(blocking_ok)
        self._reentrant = bool(reentrant)
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._depth = {}               # thread ident -> reentry depth

    # -- graph bookkeeping ------------------------------------------- #

    def _before_acquire(self) -> None:
        held = _held_stack()
        if not held:
            return
        me = threading.current_thread().name
        site = _acquire_site()
        with _state_lock:
            for prior in held:
                if prior.name == self.name:
                    continue
                back = _path(self.name, prior.name)
                edges = _order_graph.setdefault(prior.name, {})
                info = edges.get(self.name)
                if info is None:
                    edges[self.name] = {"thread": me, "site": site}
                if back is not None:
                    first = _order_graph[back[0]][back[1]]
                    cycle = {
                        "cycle": back + [self.name],
                        "locks": sorted({prior.name, self.name}),
                        "threads": sorted({me, first["thread"]}),
                        "thread": me,
                        "site": site,
                        "prior_site": first["site"],
                    }
                    break
            else:
                return
        # report outside _state_lock (dump path takes recorder locks)
        _report("lock_cycle", cycle)

    def _after_acquire(self) -> None:
        ident = threading.get_ident()
        if self._reentrant:
            depth = self._depth.get(ident, 0) + 1
            self._depth[ident] = depth
            if depth > 1:
                return                  # re-entry: already on the stack
        _held_stack().append(self)

    # -- lock protocol ------------------------------------------------ #

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ident = threading.get_ident()
        fresh = not (self._reentrant and self._depth.get(ident, 0))
        if fresh:
            self._before_acquire()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._after_acquire()
        return ok

    def release(self) -> None:
        ident = threading.get_ident()
        if self._reentrant:
            depth = self._depth.get(ident, 1) - 1
            if depth:
                self._depth[ident] = depth
                self._lock.release()
                return
            self._depth.pop(ident, None)
        stack = _held_stack()
        if self in stack:
            stack.remove(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked() if not self._reentrant else bool(
            self._depth)

    def __enter__(self) -> "SanitizedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"SanitizedLock({self.name!r})"


# -- factories (the adoption surface) ------------------------------------- #

def make_lock(name: str, blocking_ok: bool = False):
    """A mutex named for the graph. Plain ``threading.Lock`` when the
    sanitizer is off — the adoption cost in production is one function
    call at construction time, nothing per acquisition.

    ``blocking_ok`` declares a COARSE mutex whose holder is expected to
    perform I/O (a one-batch-at-a-time pipeline lock); it waives the
    hold-while-blocking report for this lock but keeps it in the
    lock-order graph."""
    if enabled():
        return SanitizedLock(name, blocking_ok=blocking_ok)
    return threading.Lock()


def make_rlock(name: str, blocking_ok: bool = False):
    """Reentrant twin of :func:`make_lock`."""
    if enabled():
        return SanitizedLock(name, reentrant=True, blocking_ok=blocking_ok)
    return threading.RLock()
