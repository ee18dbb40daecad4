"""Host utilities copied from mmlspark_tpu/utils: `storage`
(scheme-dispatched file access, `atomic_write`). The JAX package's
async_utils, profiling and datagen are not ported yet."""

from . import storage

__all__ = ["storage"]
