"""Host utilities copied from mmlspark_tpu/utils: `storage`
(scheme-dispatched file access, `atomic_write`) and `datagen` (seeded
constrained tables). The JAX package's async_utils and profiling are not
ported yet."""

from .datagen import ColumnSpec, generate_table, random_specs
from . import storage

__all__ = ["ColumnSpec", "generate_table", "random_specs", "storage"]
