"""The port's ordered scatter-add (`hopper_engine.ordered_add`) against
JAX's `b.at[i].add(v)`, bit for bit, on the CPU.

XLA's CPU runtime adds with subnormals flushed to zero (a subnormal
operand or result becomes a zero of its sign), and the port does too.
The card's kernel (csrc/ordered_add.cu) drops the zero updates (+-0 and
subnormals), groups the rest by target in update order and folds each
run from the stored value with a flushing add; a target that only zero
updates reach ends at its base flushed; a result of -0 with a +0 update
after the target's last nonzero update turns into +0.  `_emulate` is
that algorithm in numpy, step for step (compaction, counts, the last
nonzero and +0 positions and the zero marks, run starts, the stable
placement 32 updates at a time, the folds, the zero rule); the plain
version `ordered_add_plain` (a flushing fold, the k-th update of every
target at a step) and the emulation are held to JAX's jitted scatter-add
on every case, which also checks the exactness argument the kernel rests
on.  Indices here lie in [0, T), as at the JAX call site, which clips
them (trafficsimulation_tpu/ops/engine.py, `_post_move`); JAX's `.at[]`
wraps a negative index where the port drops it, so dropped indices are
held between the emulation and the plain version only.  The cases
(`_case`) also serve the card's test of the kernel
(tests/test_torch_cuda.py), which runs where there is no JAX, so JAX is
imported where it is called."""

import functools

import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch.ops import hopper_engine as HE

F32 = np.float32


def _ftz(x):
    """f32 x flushed: a subnormal becomes a zero of its sign."""
    x = F32(x)
    b = x.view(np.uint32)
    return np.uint32(b & 0x80000000).view(F32) if not b & 0x7F800000 else x


def _add_ftz(a, b):
    """add.rn.ftz.f32: operands and result flushed."""
    return _ftz(F32(_ftz(a) + _ftz(b)))


def _emulate(base, idx, vals):
    """The kernel's algorithm over rows: base [R, T], idx [R, n], vals
    [R, n] (numpy) -> [R, T] f32."""
    R, T = base.shape
    out = np.empty_like(base)
    for r in range(R):
        # 1: order-keeping compaction of the in-range nonzero updates,
        # counts per target, the last nonzero and +0 positions, the marks
        # of zero updates
        bits = vals[r].view(np.uint32)
        keep = []
        count = np.zeros(T, np.int64)
        last_nz = np.full(T, -1)
        last_p0 = np.full(T, -1)
        zmark = np.zeros(T, bool)
        for i, t in enumerate(idx[r]):
            if not 0 <= t < T:
                continue
            if bits[i] & 0x7F800000:
                keep.append((int(t), vals[r, i]))
                count[t] += 1
                last_nz[t] = max(last_nz[t], i)
            else:
                zmark[t] = True
                if not bits[i] >> 31:
                    last_p0[t] = max(last_p0[t], i)
        # 2: run starts (exclusive scan)
        start = np.concatenate([[0], np.cumsum(count)])
        cur = start[:-1].copy()
        # 3: stable placement, 32 at a time: rank among equal targets of
        # the chunk, then each target's cursor advances by its peers
        placed = np.zeros(len(keep), F32)
        for j0 in range(0, len(keep), 32):
            chunk = keep[j0:j0 + 32]
            tg = [t for t, _ in chunk]
            for lane, (t, v) in enumerate(chunk):
                placed[cur[t] + tg[:lane].count(t)] = v
            for t in set(tg):
                cur[t] += tg.count(t)
        # 4: the flushing folds, then the zero rule
        for t in range(T):
            acc = base[r, t]
            for k in range(start[t], start[t + 1]):
                acc = _add_ftz(acc, placed[k])
            if start[t] == start[t + 1] and zmark[t]:
                acc = _add_ftz(acc, F32(-0.0))
            if acc.view(np.uint32) == 0x80000000 and last_p0[t] > last_nz[t]:
                acc = F32(0.0)
            out[r, t] = acc
    return out


@functools.lru_cache(maxsize=None)
def _jax_add():
    import jax
    return jax.jit(lambda b, i, v: b.at[i].add(v))


def _jax(base, idx, vals):
    return np.stack([np.asarray(_jax_add()(b, i, v))
                     for b, i, v in zip(base, idx, vals)])


def _plain(base, idx, vals):
    return HE.ordered_add_plain(torch.from_numpy(base), torch.from_numpy(idx),
                                torch.from_numpy(vals)).numpy()


def _bits(a):
    return np.ascontiguousarray(a, F32).view(np.uint32)


def _case(name):
    """(base [R, T], idx [R, n] int64, vals [R, n]) for each case."""
    rng = np.random.default_rng(7)
    pz, nz = F32(0.0), F32(-0.0)
    if name == "order":
        # the fold order decides the f32 result
        base = np.array([[1.0, 0.0, 5.0], [0.0, 3.0, 0.0]], F32)
        idx = np.array([[0, 0, 0, 2, 1, 0], [1, 1, 1, 1, 2, 1]])
        vals = np.array([[1e8, 1.0, -1e8, 2.0, 7.0, 0.5],
                         [1e8, -1e8, 1.0, 1.0, 9.0, 9.0]], F32)
    elif name == "zero_runs":
        # thousands of +-0 on one target, a few nonzero among them, and
        # pure zero runs onto -0 and +0 bases
        n = 4000
        idx = np.zeros((4, n), np.int64)
        vals = np.where(rng.random((4, n)) < 0.5, pz, nz).astype(F32)
        idx[1] = 1
        vals[1, [17, 2000, 3999]] = [0.1, -3.7, 1e-3]
        idx[2, ::2] = 2
        vals[3] = nz
        idx[3] = 3
        base = np.tile(np.array([-0.0, -0.0, 0.0, -0.0], F32), (4, 1))
    elif name == "signed_zero_bases":
        # -0 and +0 bases: +0 only, -0 only, both, a nonzero before and
        # after a +0, a nonzero alone
        base = np.array([[-0.0, -0.0, -0.0, 0.0, 0.0, -0.0, -0.0, -0.0,
                          0.0]], F32)
        idx = np.array([[0, 1, 1, 2, 3, 4, 5, 5, 6, 6, 7, 8, 8]])
        vals = np.array([[0.0, -0.0, 0.0, -0.0, -0.0, 0.0, 2.5, 0.0, 0.0,
                          -1.5, 4.0, -0.0, 0.0]], F32)
    elif name == "cancel":
        # runs that cancel to +0, then +-0 and more cancellation
        base = np.array([[-0.0, 2.0, -0.0, 1e-3]], F32)
        idx = np.array([[0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 3]])
        vals = np.array([[7.0, -7.0, -0.0, -2.0, -0.0, 0.0, 3.0, -3.0,
                          -1e-3, 0.0, -0.0]], F32)
    elif name == "rows32":
        R, T, n = 32, 40, 300
        base = np.where(rng.random((R, T)) < 0.2, F32(-0.0),
                        rng.normal(0, 50, (R, T))).astype(F32)
        idx = rng.integers(0, T, (R, n))
        vals = np.where(rng.random((R, n)) < 0.6,
                        np.where(rng.random((R, n)) < 0.5, pz, nz),
                        rng.normal(0, 1e4, (R, n))).astype(F32)
    elif name == "config5":
        # config #5's shape: one update per destination slot, most of them
        # +-0 onto block 0 (no service block), a few deliveries
        T, n = 5184, 10432
        base = rng.uniform(0, 100, (2, T)).astype(F32)
        base[:, :50] = -0.0
        idx = np.zeros((2, n), np.int64)
        hit = rng.random(n) < 0.02
        idx[:, hit] = rng.integers(0, T, int(hit.sum()))
        vals = np.stack([np.where(hit, rng.uniform(0, 20, n), 0.0),
                         -np.where(hit, rng.uniform(0, 20, n), 0.0)])
        vals = vals.astype(F32)
    elif name == "dropped":
        # indices outside [0, T), which the port drops
        base = rng.normal(0, 10, (3, 30)).astype(F32)
        idx = rng.integers(-40, 70, (3, 500))
        vals = np.where(rng.random((3, 500)) < 0.5, F32(0.0),
                        rng.normal(0, 10, (3, 500))).astype(F32)
    elif name == "flushed_negative_zero":
        # sums whose tiny result flushes to -0 (or +0), then +0, -0 or a
        # subnormal update after it or before it; bases that only zero
        # updates reach flush, a base that none reaches keeps its bits
        a, b = 1.5e-38, 1.4e-38
        base = np.array([[-a, -a, -a, -a, a, -0.0, 2e-39, -2e-39, 3e-39,
                          -a]], F32)
        idx = np.array([[0, 1, 2, 3, 4, 5, 7, 8, 0, 1, 2, 3, 5, 9, 9, 9,
                         9]])
        vals = np.array([[b, b, 0.0, b, -b, -1e-40, -0.0, 0.0, 0.0, -0.0,
                          b, 1e-40, 1e-40, b, 0.0, 1.0, -1.0]], F32)
    elif name == "subnormal":
        base = np.array([[-0.0, -0.0, 1e-39, -1e-45]], F32)
        idx = np.array([[0, 0, 1, 1, 2, 2, 3, 3]])
        vals = np.array([[0.0, 1e-40, 1e-41, -1e-41, -1e-39, 5e-40, 0.0,
                          1e-45]], F32)
    else:
        raise KeyError(name)
    return base.astype(F32), idx.astype(np.int64), vals.astype(F32)


CASES = ("order", "zero_runs", "signed_zero_bases", "cancel", "rows32",
         "config5", "subnormal", "flushed_negative_zero")
# held between the port's versions only: JAX wraps negative indices
PORT_CASES = CASES + ("dropped",)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("impl", ["plain", "emulation"])
def test_matches_jax_scatter_add(name, impl):
    base, idx, vals = _case(name)
    ref = _jax(base, idx, vals)
    got = (_plain if impl == "plain" else _emulate)(base, idx, vals)
    assert np.array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("name", PORT_CASES)
def test_emulation_matches_plain(name):
    """Also with indices outside [0, T) (dropped by both)."""
    base, idx, vals = _case(name)
    assert np.array_equal(_bits(_emulate(base, idx, vals)),
                          _bits(_plain(base, idx, vals)))


def test_zero_updates_change_only_a_bare_negative_zero():
    """The fact the kernel rests on, in numpy f32: acc + (+-0) is acc
    except (-0) + (+0) = +0; -0 + y equals +0 + y for nonzero y; and a
    sum of nonzero values that cancels is +0, never -0."""
    pz, nz = F32(0.0), F32(-0.0)
    for acc in (F32(3.5), F32(-2e-3), F32(1e-40), F32(-1e-40), pz):
        for z in (pz, nz):
            assert _bits(F32(acc + z)) == _bits(acc)
    assert _bits(F32(nz + nz)) == _bits(nz)
    assert _bits(F32(nz + pz)) == _bits(pz)
    for y in (F32(1.0), F32(-7e-30), F32(1e-42)):
        assert _bits(F32(nz + y)) == _bits(F32(pz + y))
        assert _bits(F32(y + -y)) == _bits(pz)


def test_flush_facts_the_zero_rule_rests_on():
    """Under a flush of subnormal operands and results (`_add_ftz`, as
    add.rn.ftz.f32 and XLA's CPU runtime add): a subnormal update acts
    as a zero of its sign; a sum of nonzero values can be -0 (a tiny
    negative result) and +0 (a tiny positive one); +-0 updates after it
    act as without a flush (only -0 + +0 changes it, to +0); -0 + y
    equals +0 + y for every nonzero y; a base that a -0 update reaches
    flushes."""
    pz, nz = F32(0.0), F32(-0.0)
    a, b = F32(1.5e-38), F32(1.4e-38)
    for acc in (F32(3.5), F32(-2e-3), pz, nz):
        assert _bits(_add_ftz(acc, F32(1e-40))) == _bits(_add_ftz(acc, pz))
        assert _bits(_add_ftz(acc, F32(-1e-40))) == _bits(_add_ftz(acc, nz))
    assert _bits(_add_ftz(-a, b)) == _bits(nz)
    assert _bits(_add_ftz(a, -b)) == _bits(pz)
    assert _bits(_add_ftz(_add_ftz(-a, b), pz)) == _bits(pz)
    assert _bits(_add_ftz(_add_ftz(-a, b), nz)) == _bits(nz)
    for y in (F32(1.0), F32(-7e-30), F32(-a)):
        assert _bits(_add_ftz(nz, y)) == _bits(_add_ftz(pz, y))
    assert _bits(_add_ftz(F32(2e-39), nz)) == _bits(pz)
    assert _bits(_add_ftz(F32(-2e-39), nz)) == _bits(nz)


def test_subnormal_sum_matches_jax():
    base = np.array([[-0.0]], F32)
    idx = np.array([[0, 0]])
    vals = np.array([[0.0, 1e-40]], F32)
    assert np.array_equal(_bits(_plain(base, idx, vals)),
                          _bits(_jax(base, idx, vals)))
