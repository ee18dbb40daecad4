"""Retry policy, circuit breakers, fault injection and preemption-tolerant
training, copied from mmlspark_tpu/resilience: `policy` (clocks,
RetryPolicy), `breaker` (CircuitBreaker, BreakerRegistry, whose metric
families the serving server declares), `chaos` (FaultInjector,
ChaosTransformer, which the fleet's chaos tests inject faults through) and
`elastic` (TrainingCheckpointer, PreemptionGuard), which the checkpointed
GBDT fit uses. The JAX package's supervisor and elastic_fleet modules are
not ported yet (ROADMAP.md Queue 1, item 15)."""

from .breaker import (BreakerRegistry, CircuitBreaker, CircuitBreakerTransformer,
                      CircuitOpenError)
from .chaos import ChaosError, ChaosTransformer, FaultInjector
from .elastic import (RESUMABLE_EXIT_CODE, Preempted, PreemptionGuard, TrainingCheckpointer,
                      get_active_guard, preempt_now, set_active_guard)
from .policy import (SYSTEM_CLOCK, Clock, FakeClock, RetryBudgetExceeded, RetryPolicy,
                     RetrySession, SystemClock, is_fatal_exception, is_retryable_exception,
                     is_retryable_status)

__all__ = [
    "Clock", "SystemClock", "FakeClock", "SYSTEM_CLOCK", "RetryPolicy",
    "RetrySession", "RetryBudgetExceeded", "is_retryable_status",
    "is_retryable_exception", "is_fatal_exception",
    "CircuitBreaker", "CircuitBreakerTransformer", "CircuitOpenError", "BreakerRegistry",
    "FaultInjector", "ChaosError", "ChaosTransformer",
    "TrainingCheckpointer", "PreemptionGuard", "Preempted", "RESUMABLE_EXIT_CODE",
    "get_active_guard", "set_active_guard", "preempt_now",
]
