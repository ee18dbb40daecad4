"""Retry policy, circuit breakers, fault injection and preemption-tolerant
training, copied from mmlspark_tpu/resilience: `policy` (clocks,
RetryPolicy), `breaker` (CircuitBreaker, BreakerRegistry, whose metric
families the serving server declares), `chaos` (FaultInjector,
ChaosTransformer, which the fleet's chaos tests inject faults through) and
`elastic` (TrainingCheckpointer, PreemptionGuard), which the checkpointed
GBDT fit uses, and `supervisor` (RestartPolicy, QuerySupervisor,
PartitionSupervisor), whose RestartPolicy TuneHyperparameters retries
trials under, and `elastic_fleet` (ElasticWorkerFactory, ElasticGBDTFit,
ElasticDNNFit): data-parallel fits over ServingFleet worker processes that
may die and join mid-fit without changing the model's bytes."""

from .breaker import (BreakerRegistry, CircuitBreaker, CircuitBreakerTransformer,
                      CircuitOpenError)
from .chaos import ChaosError, ChaosTransformer, FaultInjector
from .elastic import (RESUMABLE_EXIT_CODE, Preempted, PreemptionGuard, TrainingCheckpointer,
                      get_active_guard, preempt_now, set_active_guard)
from .elastic_fleet import (WORLD_SIZE_GAUGE, ElasticDNNFit, ElasticGBDTFit,
                            ElasticWorkerFactory, elastic_fit_dnn, elastic_fit_gbdt)
from .policy import (SYSTEM_CLOCK, Clock, FakeClock, RetryBudgetExceeded, RetryPolicy,
                     RetrySession, SystemClock, is_fatal_exception, is_retryable_exception,
                     is_retryable_status)
from .supervisor import PartitionSupervisor, QuerySupervisor, RestartPolicy

__all__ = [
    "Clock", "SystemClock", "FakeClock", "SYSTEM_CLOCK", "RetryPolicy",
    "RetrySession", "RetryBudgetExceeded", "is_retryable_status",
    "is_retryable_exception", "is_fatal_exception",
    "CircuitBreaker", "CircuitBreakerTransformer", "CircuitOpenError", "BreakerRegistry",
    "FaultInjector", "ChaosError", "ChaosTransformer",
    "TrainingCheckpointer", "PreemptionGuard", "Preempted", "RESUMABLE_EXIT_CODE",
    "get_active_guard", "set_active_guard", "preempt_now",
    "QuerySupervisor", "PartitionSupervisor", "RestartPolicy",
    "ElasticWorkerFactory", "ElasticDNNFit", "ElasticGBDTFit", "elastic_fit_dnn",
    "elastic_fit_gbdt", "WORLD_SIZE_GAUGE",
]
