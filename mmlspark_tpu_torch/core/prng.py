"""Counter-based random draws, bit for bit those of `jax.random`.

The JAX package draws every random number of a fit (bags, GOSS samples,
feature masks, dart drops) from `jax.random` threefry keys. The port must
draw the same numbers, or its trees part from the reference's at the first
bag. This module is the counterpart of the parts of `jax.random` those
draws use, written from jax's own definitions (jax/_src/prng.py):

- `prng_key(seed)` is `jax.random.PRNGKey(seed)` for an int32 seed
  (`_threefry_seed`): the key (seed >> 32, seed & 0xFFFFFFFF), which for an
  int32 is (0, seed mod 2**32).
- `fold_in(key, data)` is `jax.random.fold_in` (`_threefry_fold_in`):
  threefry2x32 of the counter pair (0, data) under `key`, both output words.
- `random_bits(key, shape)` is `jax.random.bits` for 32-bit words under
  `jax_threefry_partitionable=True`, jax's default since 0.5
  (`_threefry_random_bits_partitionable`): element i (row-major) is
  x0 ^ x1 of threefry2x32 of the counter pair (i >> 32, i & 0xFFFFFFFF).
  So an element depends only on its index and a draw of shape (n,) does
  not depend on n. The scheme with the flag off is not ported.
- `uniform(key, shape)` is `jax.random.uniform(key, shape)` in float32:
  the word's top 23 bits as the mantissa of a float in [1, 2), minus 1.
- `fold_in_static(key, data)` is flax's `_fold_in_static`
  (flax/core/scope.py), which `make_rng` uses to derive a module's key
  from its path and call count: `fold_in` of the first four bytes of the
  SHA-1 of the strings and ints of `data` (flax_fix_rng_separator off,
  flax's default).

Keys are pairs of Python ints: choosing one launches nothing and reads
nothing back. The draws run on the device they are asked for, as torch
integer ops on int64 tensors masked to 32 bits (torch's uint32 lacks
shifts and adds on CUDA, and int32's `>>` is arithmetic). Integer
arithmetic is exact on every device, so the card's draws equal the CPU's
bit for bit. The same threefry function runs on Python ints for the keys.
"""

from __future__ import annotations

import hashlib
import math

import torch

__all__ = ["Key", "prng_key", "fold_in", "fold_in_static", "random_bits", "uniform"]

Key = tuple  # (k0, k1): two Python ints in [0, 2**32)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds (jax's `_threefry2x32_lowering`), on
    Python ints or int64 tensors holding values in [0, 2**32)."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """`jax.random.PRNGKey(seed)` for an int32 seed."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside int32, which the JAX package's keys take")
    return (0, seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """`jax.random.fold_in(key, data)`; data is taken as a uint32."""
    return _threefry2x32(int(key[0]), int(key[1]), 0, int(data) & _M32)


def fold_in_static(key: Key, data) -> Key:
    """flax's `_fold_in_static(key, data)` for a tuple of strings and ints."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits(key: Key, shape, device: "str | torch.device" = "cuda") -> torch.Tensor:
    """The 32-bit words of `jax.random.bits(key, shape)` (partitionable
    threefry), as an int64 tensor of values in [0, 2**32) on `device`."""
    shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list)) else (shape,)))
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    x0, x1 = _threefry2x32(int(key[0]), int(key[1]), idx >> 32, idx & _M32)
    return (x0 ^ x1).reshape(shape)


def uniform(key: Key, shape, device: "str | torch.device" = "cuda") -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1) on `device`."""
    bits = random_bits(key, shape, device)
    # 0x3F800000 is 1.0f: the word's top 23 bits become a mantissa in [1, 2)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one_to_two - 1.0
