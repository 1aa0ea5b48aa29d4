"""JAX's threefry2x32 key chain, in numpy.

The JAX package draws every random number of the tick from
`jax.random` keys (JAX 0.9, `jax_threefry_partitionable=True`).  The key
chain never depends on simulation state, so the port derives it on the
host, bit for bit, and ships only the drawn values to the device.  This
module covers exactly the calls the tick makes:

  * `split(key, n)`          (`ops/engine.py:679, 1025`, `agents/rain.py:32`)
  * `bits(key, shape)`       (`ops/engine.py:603`, u32 draws)
  * `uniform(key)`, `randint(key, lo, hi)`, `bernoulli(key, p)` on scalars
    (`agents/rain.py:50-73`)

A key is a numpy uint32 array of shape (2,), as `jax.random.PRNGKey`
returns it.  numpy has a real uint32, so the wrapping adds, rotations and
xors below are the threefry2x32 hash of `jax/_src/prng.py` verbatim.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block function on counter pairs (x0, x1), 20
    rounds with the key schedule injected every 4 (`_threefry2x32_
    lowering`)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3]
        x[1] = x[1] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n: int):
    """`iota_2x32_shape`: the u64 iota as (high, low) u32 halves."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)` -> uint32 [n, 2] (the fold-like split
    of the partitionable threefry)."""
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def bits(key: np.ndarray, shape=()) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)`."""
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray) -> np.float32:
    """`jax.random.uniform(key)`: a scalar f32 in [0, 1) from the top 23
    bits as a mantissa."""
    b = bits(key, (1,))
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return np.maximum(np.float32(0.0), f[0] - np.float32(1.0))


def randint(key: np.ndarray, minval: int, maxval: int) -> np.int32:
    """`jax.random.randint(key, (), minval, maxval)` for int32: two u32
    draws reduced modulo the span (`_randint`)."""
    k = split(key, 2)
    hi, lo = bits(k[0], (1,)), bits(k[1], (1,))
    if maxval <= minval:
        return np.int32(minval)
    span = np.uint32(maxval - minval)
    mult = np.uint32((1 << 16) % int(span))
    mult = (np.asarray([mult], np.uint32) * mult) % span
    off = ((hi % span) * mult + (lo % span)) % span
    return np.int32(minval + int(off[0]))


def bernoulli(key: np.ndarray, p: float = 0.5) -> bool:
    """`jax.random.bernoulli(key, p)` (mode 'low'): uniform < p in f32."""
    return bool(uniform(key) < np.float32(p))
