"""JAX's threefry2x32 key chain, in numpy.

The JAX package draws every random number of the tick from
`jax.random` keys (JAX 0.9, `jax_threefry_partitionable=True`).  The key
chain never depends on simulation state, so the port derives it on the
host, bit for bit, and ships only the drawn values to the device.  This
module covers exactly the calls the tick makes:

  * `split(key, n)`          (`ops/engine.py:679, 1025`, `agents/rain.py:32`)
  * `bits(key, shape)`       (`ops/engine.py:603`, `gen/zoning.py:227`)
  * `uniform(key, shape)`, `randint(key, lo, hi, shape)`,
    `bernoulli(key, p, shape)` (`agents/rain.py:50-73`,
    `agents/demand.py:109-161`, `gen/subblocks.py:67-84`,
    `gen/zoning.py:78`, `gen/bands.py`)
  * `normal(key)` on scalars (`gen/bands.py:41,44`): sqrt(2) times XLA's
    f32 `ErfInv` polynomial of a uniform draw in (-1, 1)
  * the RL controllers' draws (`rl/controllers.py:203, 231, 264, 382-383,
    396`): `categorical` through `gumbel`, `uniform`, and `randint` whose
    maxval the JAX code traces (`maximum(filled, 1)`); the port mirrors
    `filled` on the host, so the whole draw runs here

A key is a numpy uint32 array of shape (2,), as `jax.random.PRNGKey`
returns it.  numpy has a real uint32, so the wrapping adds, rotations and
xors below are the threefry2x32 hash of `jax/_src/prng.py` verbatim.

Every function also takes a stack of keys [..., 2] and then draws for
each key at once, as `jax.vmap` of the same call would (the per-world key
chains of a batch of worlds, `ops/engine.tick_draws`).
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
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0, None], key[..., 1, None]
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


def PRNGKey(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the 64-bit seed as (high, low) u32."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, n: int = 2) -> np.ndarray:
    """`jax.random.split(key, n)` -> uint32 [..., n, 2] (the fold-like
    split of the partitionable threefry)."""
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def bits(key: np.ndarray, shape=()) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)` -> [..., *shape]."""
    n = int(np.prod(shape, dtype=np.int64))
    hi, lo = _counters(n)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(np.shape(key)[:-1] + tuple(shape))


def _unit(b: np.ndarray) -> np.ndarray:
    """u32 draws -> f32 in [0, 1) from the top 23 bits as a mantissa."""
    f = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniform(key: np.ndarray, shape=()):
    """`jax.random.uniform(key, shape)`: f32 in [0, 1) per key and
    entry."""
    b = bits(key, (1,) if shape == () else shape)
    if shape == ():
        b = b[..., 0]
    return np.maximum(np.float32(0.0), _unit(b))[()]


def randint(key: np.ndarray, minval: int, maxval, shape=()):
    """`jax.random.randint(key, shape, minval, maxval)` for int32 per key:
    two u32 draws reduced modulo the span (`_randint`).  `maxval` is an
    int, or an int array over the key stack's batch dims: a maxval that
    the JAX code traces, one per key (the draws do not depend on it,
    only the span arithmetic does)."""
    k = split(key, 2)
    n = (1,) if shape == () else tuple(shape)
    hi, lo = bits(k[..., 0, :], n), bits(k[..., 1, :], n)
    out_shape = np.shape(key)[:-1] + tuple(shape)
    mx = np.asarray(maxval, np.int64)
    mx = mx.reshape(mx.shape + (1,) * len(n))
    # span 1 where maxval <= minval: every draw is minval, as in JAX
    span = np.where(mx <= minval, 1, mx - minval).astype(np.uint32)
    mult = (np.uint32(1 << 16) % span).astype(np.uint32)
    mult = (mult * mult) % span
    off = ((hi % span) * mult + (lo % span)) % span
    return (np.int64(minval) + off).astype(np.int32).reshape(out_shape)[()]


def bernoulli(key: np.ndarray, p: float = 0.5, shape=()):
    """`jax.random.bernoulli(key, p, shape)` (mode 'low'): uniform < p in
    f32; a bool for one key and no shape, else a bool array."""
    out = np.asarray(uniform(key, shape) < np.float32(p))
    return bool(out) if out.ndim == 0 else out


# XLA's f32 ErfInv (Giles' single-precision approximation), coefficients
# for w < 5 and w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma32(a, b, c):
    """f32 a * b + c with one rounding (XLA's CPU contraction)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 `ErfInv`: w = -log1p(-x*x); a degree-8 polynomial in
    w - 2.5 (w < 5) or sqrt(w) - 3, evaluated by Horner steps that the
    CPU backend contracts into fused multiply-adds; times x; +-inf at
    |x| = 1."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(f32)
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w).astype(f32) - f32(3.0))
    lo, hi = (np.asarray(c, f32) for c in (_ERFINV_LT5, _ERFINV_GE5))
    p = np.where(lt, lo[0], hi[0]).astype(f32)
    for i in range(1, 9):
        p = _fma32(p, w, np.where(lt, lo[i], hi[i]).astype(f32))
    out = (p * x).astype(f32)
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max, out)


SQRT2 = np.float32(np.sqrt(2))


def normal_erfinv(key: np.ndarray):
    """erfinv(u) of `jax.random.normal(key)` = SQRT2 * erfinv(u), u
    uniform on [nextafter(-1, 0), 1), f32 per key.  A caller that scales
    the draw by a constant gets XLA's folded form from this: XLA merges
    the two constant factors and fuses the add, mean + std * normal ->
    fma(erfinv(u), SQRT2 * std, mean)."""
    f32 = np.float32
    b = bits(key, (1,))[..., 0]
    lo = np.nextafter(f32(-1.0), f32(0.0))
    span = f32(1.0) - lo                       # rounds to 2 in f32
    u = np.maximum(lo, _fma32(_unit(b), span, lo))
    return erfinv32(u)[()]


def normal(key: np.ndarray):
    """`jax.random.normal(key)` in f32 per key.  The log1p inside XLA's
    ErfInv is XLA's own; numpy's differs from it in the last bit for
    about 1% of draws."""
    return (SQRT2 * normal_erfinv(key)).astype(np.float32)[()]


def gumbel(key: np.ndarray, shape=()) -> np.ndarray:
    """`jax.random.gumbel(key, shape)` (mode "low"): -log(-log(u)) of a
    uniform on [tiny, 1), f32.  The uniform bits are JAX's; numpy's f32
    `log` is not XLA's, so a value may differ from JAX's in the last two
    bits."""
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    # u * (1 - tiny) + tiny in f32: the draw itself, or tiny for 0
    u = _unit(bits(key, shape))
    u = np.where(u == f32(0.0), tiny, u).astype(f32)
    return (-np.log(-np.log(u))).astype(f32)


def categorical(key: np.ndarray, logits: np.ndarray) -> np.ndarray:
    """`jax.random.categorical(key, logits, axis=-1)`: the argmax of the
    logits plus Gumbel noise (the first index on a tie), int32."""
    g = gumbel(key, np.shape(logits))
    return np.argmax(g + np.asarray(logits, np.float32), axis=-1).astype(
        np.int32)
