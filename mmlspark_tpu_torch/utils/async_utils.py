"""Bounded-concurrency helpers.

Reference: `core/utils/src/main/scala/AsyncUtils.scala:11-65`
(bufferedAwait / bufferedAwaitSafe over Future iterators — a sliding window
of at most `concurrency` in-flight futures). TPU-first: same semantics on a
ThreadPoolExecutor; used by the HTTP client stack and hyperparameter search.

A copy of mmlspark_tpu/utils/async_utils.py.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")

__all__ = ["buffered_map", "buffered_map_safe", "RetryError", "retry_with_backoff"]


def buffered_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    concurrency: int,
    executor: ThreadPoolExecutor | None = None,
) -> Iterator[R]:
    """Yield fn(item) in input order, keeping at most `concurrency` in flight
    (reference AsyncUtils.bufferedAwait)."""
    if concurrency < 1:
        raise ValueError("concurrency must be >= 1")
    own = executor is None
    pool = executor or ThreadPoolExecutor(max_workers=concurrency)
    try:
        window: list[Future] = []
        it = iter(items)
        for item in it:
            window.append(pool.submit(fn, item))
            if len(window) >= concurrency:
                yield window.pop(0).result()
        for fut in window:
            yield fut.result()
    finally:
        if own:
            pool.shutdown(wait=False)


def buffered_map_safe(
    fn: Callable[[T], R],
    items: Iterable[T],
    concurrency: int,
) -> Iterator[tuple[R | None, Exception | None]]:
    """Like buffered_map but yields (result, error) pairs instead of raising
    (reference AsyncUtils.bufferedAwaitSafe)."""

    def wrapped(item: T) -> tuple[R | None, Exception | None]:
        try:
            return fn(item), None
        except Exception as e:  # noqa: BLE001 — deliberate catch-all
            return None, e

    yield from buffered_map(wrapped, items, concurrency)


class RetryError(RuntimeError):
    pass


def retry_with_backoff(
    fn: Callable[[], R],
    backoffs_ms: list[int] | None = None,
    retryable: Callable[[Exception], bool] | None = None,
    policy=None,
) -> R:
    """Run fn with retries (reference HTTPClients.scala:64-105 retry ladder,
    ModelDownloader FaultToleranceUtils.retryWithTimeout). The schedule is a
    resilience.RetryPolicy — pass one for jitter/deadline/fake-clock control;
    the legacy `backoffs_ms` ladder remains the default contract."""
    from ..resilience.policy import RetryPolicy

    if policy is None:
        backoffs = backoffs_ms if backoffs_ms is not None else [100, 500, 1000]
        policy = RetryPolicy(backoffs_ms=backoffs)
    sess = policy.session()
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001
            if retryable is not None and not retryable(e):
                raise
            if not sess.should_retry():
                raise RetryError(f"all retries failed: {e}") from e
            sess.backoff()
