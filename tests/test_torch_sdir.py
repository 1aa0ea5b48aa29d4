"""K5, the batched next-move stack build (csrc/sdir.cu,
`sdir_batched_kernel`), emulated in numpy on the CPU and held bit for bit
to JAX's `build_sdir_pallas_batched` (Pallas in interpret mode) and to
the port's plain version `sdir_encode_batched`.

`_emulate` follows the kernel: its launch (the <NB, G> form the batch
picks, CW cells a block, the runs of packed words, the world groups),
the rows of a word past D, and its arithmetic per key row, cell and
world: the per-cell byte table (byte m = m | contra(m) << 3) and
straight bits, the min of four keys as DPX `vimin3` then `min`, the
argmin and its contra bit as `prmt.b32.rc8` of the table, the straight
bound as DPX `viaddmin` (min(a + b, c), the sum wrapping as an int32),
the compares, the unreachable select and the pack of four bytes with
`__byte_perm`.  Every output word must be written exactly once.

The cases cover the kernel's edges: ragged D (not a multiple of 4 or of
the words a block walks; rows past D decode to 7), batches that do not
fill a thread's or a block's worlds (B = 1, 2, 3, 5, 16, 17), unreachable
(KBIG) rows and 1 << 17 pens (pen << 2 = 2^19), ties between moves, keys
exactly at the straight bound, bounds at the KBIG - 1 cap, and tp2 = 0
(JAX's value with turn penalties off).  JAX's kernel takes D a multiple
of 4, so a ragged stack goes to it padded with unreachable rows (which
decode to 7, as rows past D do).  No JAX tick is compiled here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.ops import pallas_engine

from trafficsimulation_tpu_torch.ops import hopper_engine as HE

torch.set_num_threads(2)

KBIG = 1 << 19
CAP = ((KBIG - 1) << 2) | 3
THREADS = 256
WORDS = 40          # K5_WORDS: packed words a block walks, at most
H, W = 8, 128


def _i32(x):
    return np.asarray(x, np.int64).astype(np.uint32).view(np.int32)


def byte_perm(x, y, s):
    """`__byte_perm(x, y, s)` (prmt.b32, default mode), elementwise on
    int32 arrays: byte i of the result is byte s.nibble[i] & 7 of the
    8-byte {y, x}, or that byte's sign bit replicated where the nibble's
    bit 3 is set."""
    src = (np.asarray(y, np.int64).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(x, np.int64).astype(np.uint32).astype(np.uint64)
    out = np.zeros(np.broadcast(x, y, s).shape, np.uint64)
    s = np.asarray(s, np.int64)
    for i in range(4):
        nib = (s >> (4 * i)) & 0xF
        byte = (src >> (8 * (nib & 7)).astype(np.uint64)) & np.uint64(0xFF)
        sign = np.where(byte & np.uint64(0x80), np.uint64(0xFF),
                        np.uint64(0))
        byte = np.where(nib & 8, sign, byte)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32).view(np.int32)


def prmt_rc8(a, c):
    """`prmt.b32.rc8 d, a, 0, c`: byte c[1:0] of a in all four bytes."""
    byte = (np.asarray(a, np.int64) >> (8 * (np.asarray(c) & 3))) & 0xFF
    return _i32(byte * 0x01010101)


def viaddmin(a, b, c):
    """DPX `__viaddmin_s32`: min(a + b, c), the sum wrapping as int32."""
    return np.minimum(_i32(np.asarray(a, np.int64) + b), c)


def vimin3(a, b, c):
    return np.minimum(np.minimum(a, b), c)


def launch(D, HW, B):
    """The host side of `tsim_build_sdir_batched`: (NB, G, CW, wpb, grid)."""
    NB, G = ((1, 1) if B <= 1 else (2, 1) if B <= 2 else (4, 1) if B <= 4
             else (4, 2) if B <= 8 else (4, 4))
    CW = THREADS // G
    D4 = (D + 3) // 4
    runs = (D4 + WORDS - 1) // WORDS
    wpb = (D4 + runs - 1) // runs
    grid = (-(-HW // CW), -(-D4 // wpb), -(-B // (G * NB)))
    return NB, G, CW, wpb, grid


def enc_dpx(kv, ps, tbl, hb, tp4):
    """`sdir_enc_dpx` on arrays over cells: kv [4, n] the row's keys, ps
    [4, n] the world's pen << 2, tbl / hb the cell's table and straight
    bits; only byte 0 of the result counts."""
    key = [_i32(kv[m].astype(np.int64) + ps[m]) for m in range(4)]
    bk = np.minimum(vimin3(key[0], key[1], key[2]), key[3])
    e = prmt_rc8(tbl, bk)
    bnd = viaddmin(bk | 3, tp4, CAP)
    for h in range(4):
        e = np.where(key[h] <= bnd, e | hb[h], e)
    return np.where(bk >= (KBIG << 2), 7, e).astype(np.int32)


def _emulate(K0, pen4b, legal4, tp2):
    """The kernel over its grid: K0 [D, 4, H, W], pen4b [B, 4, H, W],
    legal4 [4, H, W] (int32 numpy) -> [B, ceil(D/4), H, W]."""
    D = K0.shape[0]
    B = pen4b.shape[0]
    HW = K0.shape[2] * K0.shape[3]
    D4 = (D + 3) // 4
    k0 = K0.reshape(D, 4, HW)
    pen = pen4b.reshape(B, 4, HW)
    leg = legal4.reshape(4, HW) != 0
    out = np.zeros((B, D4, HW), np.int32)
    writes = np.zeros((B, D4, HW), np.int64)
    NB, G, CW, wpb, (gx, gy, gz) = launch(D, HW, B)
    # per cell: the byte table and the straight bits where legal
    tbl = np.zeros(HW, np.int64)
    for m in range(4):
        tbl |= (m | np.where(leg[m], 0, 8)) << (8 * m)
    tbl = _i32(tbl)
    hb = [np.where(leg[m], 1 << (4 + m), 0).astype(np.int32)
          for m in range(4)]
    tp4 = _i32(tp2 << 2)
    for bx in range(gx):
        c = np.arange(bx * CW, min(bx * CW + CW, HW))
        for by in range(gy):
            g0 = by * wpb
            for bz in range(gz):
                for grp in range(G):
                    for j in range(NB):
                        b = bz * G * NB + grp * NB + j
                        if b >= B:
                            continue
                        ps = pen[b][:, c] << 2
                        for g in range(g0, min(g0 + wpb, D4)):
                            e = []
                            for k in range(4):
                                d = 4 * g + k
                                e.append(enc_dpx(k0[d][:, c], ps, tbl[c],
                                                 [x[c] for x in hb], tp4)
                                         if d < D else
                                         np.full(c.shape, 7, np.int32))
                            out[b, g, c] = byte_perm(
                                byte_perm(e[0], e[1], 0x0040),
                                byte_perm(e[2], e[3], 0x0040), 0x5410)
                            writes[b, g, c] += 1
    assert (writes == 1).all(), "an output word written other than once"
    return out.reshape(B, D4, *K0.shape[2:])


def _keys(x):
    """Stored keys (x << 2) | m from x [D, 4, H, W]."""
    m = np.arange(4, dtype=np.int64).reshape(1, 4, 1, 1)
    return _i32((np.asarray(x, np.int64) << 2) | m)


def _case(name):
    """(K0, pen4b, legal4, tp2) for each case."""
    rng = np.random.default_rng(PLAIN_CASES.index(name))
    B, D, tp2 = {"b16": (16, 8, 20), "b1_ragged": (1, 7, 20),
                 "b2": (2, 8, 20), "b3_ragged": (3, 10, 20),
                 "b5": (5, 12, 20), "b17_ragged": (17, 6, 20),
                 "tp2_zero": (4, 8, 0), "edges": (3, 9, 3),
                 "long_d": (2, 170, 20)}[name]
    legal = (rng.random((4, H, W)) < 0.6).astype(np.int32)
    if name == "edges":
        # small costs and pens (ties, keys at the bound), whole unreachable
        # rows, pens at 1 << 17, costs near KBIG (the bound's cap)
        x = rng.integers(0, 8, (D, 4, H, W))
        x = np.where(rng.random(x.shape) < 0.1, KBIG, x)
        x[2] = KBIG
        near = rng.random(x.shape) < 0.1
        x = np.where(near, KBIG - rng.integers(1, 6, x.shape), x)
        pen = rng.integers(0, 4, (B, 4, H, W))
        pen = np.where(rng.random(pen.shape) < 0.1, 1 << 17, pen)
        pen[:, :, :, :16] = 0                 # exact ties across moves
        x[:, :, :, :16] = x[:, :1, :, :16]
    else:
        x = rng.integers(0, 60000, (D, 4, H, W))
        x = np.where(rng.random(x.shape) < 0.15, KBIG, x)
        pen = rng.integers(0, 3000, (B, 4, H, W))
        pen = np.where(rng.random(pen.shape) < 0.1, 1 << 17, pen)
    return _keys(x), pen.astype(np.int32), legal, tp2


CASES = ("b16", "b1_ragged", "b2", "b3_ragged", "b5", "b17_ragged",
         "tp2_zero", "edges")
# held to the plain version only: D4 = 43 words split into two runs of a
# block, which JAX's interpret mode unrolls slowly
PLAIN_CASES = CASES + ("long_d",)


def _jax(K0, pen4b, legal4, tp2):
    """JAX's kernel in interpret mode, K0 padded to a multiple of 4 rows
    with unreachable keys."""
    D = K0.shape[0]
    pad = -D % 4
    if pad:
        K0 = np.concatenate([K0, _keys(np.full((pad, 4) + K0.shape[2:],
                                               KBIG))])
    cfg = JConfig(VEHICLE_TURN_PENALTY_ENABLED=tp2 != 0,
                  VEHICLE_TURN_PENALTY=tp2 / 2)
    return np.asarray(pallas_engine.build_sdir_pallas_batched(
        cfg, jnp.asarray(K0), jnp.asarray(pen4b), jnp.asarray(legal4),
        interpret=True))


def _plain(K0, pen4b, legal4, tp2):
    return HE.sdir_encode_batched(torch.from_numpy(K0),
                                  torch.from_numpy(pen4b),
                                  torch.from_numpy(legal4), tp2).numpy()


def _check(name, ref):
    args = _case(name)
    got = _emulate(*args)
    want = ref(*args)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_emulation_matches_jax(name):
    _check(name, _jax)


@pytest.mark.parametrize("name", PLAIN_CASES)
def test_emulation_matches_plain(name):
    _check(name, _plain)


def test_edges_case_reaches_every_edge():
    """The `edges` case holds ties between moves, keys exactly at the
    straight bound, unreachable rows, 1 << 17 pens and bounds at the
    cap (the kernel's inputs, counted with the plain arithmetic)."""
    K0, pen, legal, tp2 = _case("edges")
    key = K0[None].astype(np.int64) + (pen[:, None].astype(np.int64) << 2)
    bk = key.min(axis=2)
    best = bk >> 2
    bnd2 = (np.minimum(best + tp2, KBIG - 1) << 2) | 3
    ties = ((key >> 2) == best[:, :, None]).sum(axis=2) > 1
    at_bound = (key == bnd2[:, :, None]).any(axis=2)
    capped = (best + tp2 >= KBIG - 1) & (best < KBIG)
    assert ties.any() and at_bound.any() and capped.any()
    assert (best >= KBIG).any() and (pen == 1 << 17).any()


def test_launch_shapes():
    """The launch's forms: a thread's worlds and a block's groups grow
    with B up to 16 worlds a block; D4 splits into even runs of at most
    40 words (D = 608: four runs of 38)."""
    assert launch(608, 65536, 16) == (4, 4, 64, 38, (1024, 4, 1))
    assert launch(608, 65536, 17)[4][2] == 2
    assert [launch(8, 1024, b)[:2] for b in (1, 2, 3, 5, 9)] == [
        (1, 1), (2, 1), (4, 1), (4, 2), (4, 4)]


def test_byte_ops_follow_ptx():
    """The emulated byte ops on fixed words: __byte_perm's selectors (a
    byte of {y, x}, the sign replicate bit) and prmt.rc8."""
    x, y = _i32(0x84838281), _i32(0x08070605)
    assert byte_perm(x, y, 0x3210) == x
    assert byte_perm(x, y, 0x7654) == y
    assert byte_perm(x, y, 0x0040) == _i32(0x81810581)
    assert byte_perm(x, y, 0x000B) == _i32(0x818181FF)
    assert byte_perm(x, y, 0x000F) == _i32(0x81818100)
    assert prmt_rc8(x, 6) == _i32(0x83838383)
    assert viaddmin(_i32(2**31 - 1), 1, 5) == _i32(-2**31)
