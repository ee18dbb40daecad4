"""Host utilities copied from mmlspark_tpu/utils: `async_utils`
(bounded-concurrency maps and retry with backoff, which the HTTP client
stack uses), `storage` (scheme-dispatched file access, `atomic_write`),
`datagen` (seeded constrained tables) and `profiling` (torch.profiler
device traces, named ranges, and timing that waits on the outputs'
streams)."""

from .async_utils import RetryError, buffered_map, buffered_map_safe, retry_with_backoff
from .profiling import annotate, block_until_ready, device_trace, profile_fn
from .datagen import ColumnSpec, generate_table, random_specs
from . import storage

__all__ = ["buffered_map", "buffered_map_safe", "retry_with_backoff", "RetryError",
           "device_trace", "annotate", "profile_fn", "block_until_ready",
           "ColumnSpec", "generate_table", "random_specs", "storage"]
