# Frozen copy of trafficsimulation_tpu_torch/prng.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
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
  * flax's parameter draws (`rl/nets.init_params`): `fold_in` and the
    `truncated_normal(key, -2, 2)` of `lecun_normal`

The float transforms are XLA's CPU f32 arithmetic, bit for bit: `log32`
and `log1p32` (Eigen's polynomials with the backend's FMA contractions,
`_fma32`), `erfinv32`, and the subnormal flush of the runtime.  `gumbel`
and `truncated_normal` depend on a draw's bits only through the 23 bits
of its uniform, so each looks its values up in a table of all 2^23 built
once per process (~2 s each).

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
    """f32 a * b + c with one rounding (XLA's CPU contraction).  The f64
    product of two f32 is exact; the f64 sum rounds once more, which can
    land on a midpoint between two f32 and then round the wrong way: those
    few sums are redone exactly (`_fma32_exact`)."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    s = np.multiply(a, b, dtype=np.float64) + c
    out = np.asarray(s.astype(np.float32))
    mid = (s.view(np.int64) & 0x1FFFFFFF) == 0x10000000
    if mid.any():
        i = np.nonzero(mid)
        out[i] = _fma32_exact(*(np.broadcast_to(v, s.shape)[i]
                                for v in (a, b, c)))
    return out[()]


def _fma32_exact(a, b, c):
    """`_fma32` by an error-free sum (TwoSum) and round-to-odd in f64,
    after which the cast to f32 rounds once, correctly."""
    p = a.astype(np.float64) * b
    c = c.astype(np.float64)
    s = p + c
    bp = s - c
    lo = (p - bp) + (c - (s - bp))
    bits = s.view(np.int64)
    odd = (lo != 0) & ((bits & 1) == 0)
    bits = np.where(odd, bits + np.where((lo > 0) == (s > 0), 1, -1), bits)
    return bits.view(np.float64).astype(np.float32)


def _ftz(x):
    """XLA's CPU runtime flushes subnormal f32 results to zero (sign
    kept)."""
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < _TINY, np.copysign(np.float32(0), x), x)


_TINY = np.finfo(np.float32).tiny

# XLA's CPU f32 `log` (Eigen's `plog_float`, Cephes' polynomial): the
# mantissa in [sqrt(1/2), sqrt(2)) minus one, a degree-8 polynomial in
# three Horner chains joined by x^3, and the exponent times ln 2 split in
# two; the LLVM backend contracts each multiply with a single use into
# the add that takes it
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRTHF = 0.707106781186547524


def log32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 `log`, bit for bit (-inf at 0 and at subnormals,
    which the runtime reads as 0; NaN below 0)."""
    f32 = np.float32
    x = _ftz(x)
    bits = np.maximum(x, _TINY).view(np.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(f32)
    small = m < f32(_SQRTHF)
    e = (((bits >> 23) - 127).astype(f32) + f32(1.0)) - small.astype(f32)
    z = (m - f32(1.0)) + np.where(small, m, f32(0.0))
    z2 = z * z
    z3 = z2 * z
    p = [f32(c) for c in _LOG_P]
    y = _fma32(_fma32(z, p[0], p[1]), z, p[2])
    y1 = _fma32(_fma32(z, p[3], p[4]), z, p[5])
    y2 = _fma32(_fma32(z, p[6], p[7]), z, p[8])
    y = _fma32(_fma32(_fma32(y, z3, y1), z3, y2), z3, e * f32(_LOG_Q1))
    r = _fma32(e, f32(_LOG_Q2), _fma32(f32(-0.5), z2, z) + y)
    r = np.where(x == f32(0.0), f32(-np.inf), r)
    r = np.where(x == f32(np.inf), x, r)
    return np.where(x < f32(0.0), f32(np.nan), r).astype(f32)[()]


# XLA's CPU f32 `log1p`: below |x| = 0.41421357 a rational form
# x - x^2 / 2 + x^3 P(x) / Q(x) (Horner steps contracted; the x^2 / 2
# term one FMA), above it log(1 + x)
_LOG1P_Q = (1.0, 15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
            60.11866)
_LOG1P_P = (4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
            57.112965, 20.039553)


def log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 `log1p`, bit for bit, subnormals flushed."""
    f32 = np.float32
    x = _ftz(x)
    q = np.full(x.shape, f32(_LOG1P_Q[0]))
    for c in _LOG1P_Q[1:]:
        q = _fma32(q, x, f32(c))
    p = np.full(x.shape, f32(_LOG1P_P[0]))
    for c in _LOG1P_P[1:]:
        p = _fma32(p, x, f32(c))
    x2 = _ftz(x * x)
    small = _ftz(x + _fma32(x2, f32(-0.5), _ftz(_ftz(x * x2)
                                                  * _ftz(p / q))))
    return np.where(np.abs(x) < f32(0.41421357), small,
                    log32(x + f32(1.0))).astype(f32)[()]


def erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 `ErfInv`, bit for bit: w = -log1p(x * -x) (XLA's
    `log1p32`); a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3,
    evaluated by Horner steps that the CPU backend contracts into fused
    multiply-adds; times x; +-inf at |x| = 1."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -log1p32(_ftz(x * -x))
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w).astype(f32) - f32(3.0))
    lo, hi = (np.asarray(c, f32) for c in (_ERFINV_LT5, _ERFINV_GE5))
    p = np.where(lt, lo[0], hi[0]).astype(f32)
    for i in range(1, 9):
        p = _fma32(p, w, np.where(lt, lo[i], hi[i]).astype(f32))
    out = _ftz(p * x)
    return np.where(np.abs(x) == f32(1.0), x * np.finfo(f32).max,
                    out).astype(f32)[()]


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


# erf(-+2 / sqrt(2)) as XLA's CPU f32 `erf` computes it from the traced
# bounds of `jax.random.truncated_normal(key, -2, 2)` (`-2 * 0.70710677`:
# XLA turns the division by sqrt(2) into a multiply by its reciprocal)
TRUNC_LO = np.int32(-1082893800).view(np.float32)      # -0.9544997
TRUNC_HI = np.int32(1064589848).view(np.float32)       # 0.9544997


_DEVICE_TABLES: dict = {}
