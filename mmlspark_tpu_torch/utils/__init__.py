"""Host utilities copied from mmlspark_tpu/utils: `async_utils`
(bounded-concurrency maps and retry with backoff, which the HTTP client
stack uses), `storage` (scheme-dispatched file access, `atomic_write`) and
`datagen` (seeded constrained tables). The JAX package's profiling module
is not ported yet."""

from .async_utils import RetryError, buffered_map, buffered_map_safe, retry_with_backoff
from .datagen import ColumnSpec, generate_table, random_specs
from . import storage

__all__ = ["buffered_map", "buffered_map_safe", "retry_with_backoff", "RetryError",
           "ColumnSpec", "generate_table", "random_specs", "storage"]
