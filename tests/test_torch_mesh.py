"""The port's batch of cities (BASELINE config #4: 64x64 worlds, each from
its own key of the bench's `split(PRNGKey(0), 1024)`) against the JAX
package.

The JAX side is the shipped digest `data/config4_batch_digest.json`
(`tools/make_torch_batch_digest.py`): worlds 0-1 at init (JAX's
`jax.vmap(init_world)`), after 10 ticks of `jax.vmap(run_chunk)` and
after 3 ticks of `run_batch`.  Every leaf's dtype, shape and sha256 must
agree (integer, bool and f32 leaves alike: the f32 leaves are exact).
Also here: the batched generator against the world-by-world
`init_world`; the demand-window guard; and the per-world-geometry plain
forms of K1, K2 and K3 against a loop of their single-world plain
versions and against JAX's Pallas kernels under `jax.vmap` with batched
geometry (interpret mode), numpy-seeded, B = 3.

No JAX compile of `generate_city`, `step_world` or `run_chunk`; the
worlds are 64x64 and generated on the CPU by the port.
"""

import functools
import hashlib
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.ops import pallas_engine

from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.ops import engine
from trafficsimulation_tpu_torch.ops import hopper_engine as HE
from trafficsimulation_tpu_torch.parallel import mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                      "config4_batch_digest.json")
B = 3


@functools.cache
def _digest() -> dict:
    with open(DIGEST) as f:
        return json.load(f)


@functools.cache
def _cfg() -> Config:
    return Config(**_digest()["cfg"])


def _keys(n: int) -> np.ndarray:
    return prng.split(prng.PRNGKey(0), _digest()["n_split"])[:n]


@functools.cache
def _worlds():
    """Worlds 0-1 of the bench's split, generated as one batch on the CPU
    with vmap's per-world fallback turned into an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            return sim.init_worlds(_cfg(), _keys(2), "cpu")
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def _assert_digest(worlds, ref: list):
    """World b of the batch against the digest's entry b, every leaf."""
    got = world_to_numpy(worlds)
    for b, want in enumerate(ref):
        assert set(got) == set(want), set(got) ^ set(want)
        bad = []
        for k, d in want.items():
            a = np.array(got[k][b], order="C")       # 0-d stays 0-d
            if (str(a.dtype) != d["dtype"] or list(a.shape) != d["shape"]
                    or hashlib.sha256(a.tobytes()).hexdigest()
                    != d["sha256"]):
                bad.append(k)
        assert not bad, f"world {b}: leaves differ from JAX: {bad}"


def test_init_world_batch_matches_jax_digest():
    _assert_digest(_worlds(), _digest()["init"][:2])


def test_run_chunk_batch_matches_jax_digest(monkeypatch):
    """10 ticks of the bench's vmapped chunk; the kernels' vmap rules run
    their batched forms once per call for the whole batch: K1 and K4 once
    a tick, K2 and K3 once a segment, no K9."""
    calls = {}
    for name in ("decide_move_batched", "prefix_planes_batched",
                 "build_sdir_stacks", "build_wavefront_batched",
                 "mega_segment_batched"):
        def spy(*a, _name=name, _fn=getattr(HE, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(HE, name, spy)
    end = mesh.run_chunk_batch(_cfg(), _worlds(), 10)
    assert calls == {"decide_move_batched": 10, "prefix_planes_batched": 10,
                     "build_sdir_stacks": 2, "build_wavefront_batched": 2}
    _assert_digest(end, _digest()["chunk10"][:2])
    assert [int(a) for a in end.vehicles.active.sum(-1)] == \
        _digest()["chunk10_active"][:2]


def test_run_batch_matches_jax_digest():
    """3 ticks of `run_batch` (`step_world` under vmap, routing rebuilt
    every tick)."""
    end = mesh.run_batch(_cfg(), _worlds(), 3)
    _assert_digest(end, _digest()["run_batch3"])
    assert [int(t) for t in end.tick] == [3, 3]


def test_batched_generator_equals_init_world():
    """World b of the batch is `init_world` of key b, bit for bit."""
    batch = world_to_numpy(_worlds())
    for b, key in enumerate(_keys(2)):
        one = world_to_numpy(sim.init_world(_cfg(), key, "cpu"))
        assert set(one) == set(batch)
        bad = [k for k, v in one.items()
               if not (v.dtype == batch[k].dtype
                       and np.array_equal(v, batch[k][b]))]
        assert not bad, f"world {b}: {bad}"


def test_init_world_batch_splits_the_key_and_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="item 15"):
        mesh.init_world_batch(_cfg(), prng.PRNGKey(0), 2, mesh=object(),
                              device="cpu")
    tm = {}
    small = Config(WIDTH=32, HEIGHT=32, WALL_THICKNESS=4,
                   SIDEWALK_RING_WIDTH=1, MAX_FIELD_DESTS=8,
                   MAX_VEHICLES=32)
    w = mesh.init_world_batch(small, prng.PRNGKey(3), 2, device="cpu",
                              timings=tm)
    keys = prng.split(prng.PRNGKey(3), 2)
    assert np.array_equal(w.key.numpy().view(np.uint32), keys)
    assert set(tm) == {"draws", "city", "cost_field", "key_stack",
                       "demand_state", "generate_all_sec"}
    assert w.grid.cell_type.shape == (2, 32, 32)


def test_run_batch_past_the_demand_table_raises():
    """As `tests/test_parallel.py::test_demand_window_guard` holds for
    JAX: a batched rollout past the pre-generated table fails loudly."""
    w = _worlds()
    rem = mesh.demand_ticks_remaining(w)
    assert rem > 0
    mesh.assert_demand_window(_cfg(), w, min(rem, 2))
    with pytest.raises(RuntimeError, match="outruns the pre-generated"):
        mesh.run_batch(_cfg(), w, rem + 1)
    with pytest.raises(RuntimeError, match="outruns the pre-generated"):
        mesh.run_chunk_batch(_cfg(), w, rem + 1)


# ---- the per-world-geometry plain forms of K1, K2, K3 ----------------------

HS, WS = 16, 32
KCFG = dict(WIDTH=WS, HEIGHT=HS, RAIN_ENABLED=True,
            VEHICLE_MALFUNCTION_ACTIVE=True,
            VEHICLE_SIDESWIPE_COLLISION_ACTIVE=True,
            VEHICLE_MALFUNCTION_CHANCE=0.01,
            VEHICLE_SIDESWIPE_COLLISION_CHANCE=0.3,
            VEHICLE_MIN_SPEED=1, VEHICLE_MAX_SPEED=3,
            VEHICLE_MAX_CONTRAFLOW_OVERTAKE_STEPS=4,
            MAX_VEHICLES=64, MAX_FIELD_DESTS=8)


def _k1_inputs(seed: int, D: int = 8):
    """K1's arguments for B worlds of HS x WS, numpy-seeded, each world
    with its own geometry (intersection, dest_id)."""
    rng = np.random.default_rng(seed)
    sh = (B, HS, WS)

    def bits():
        return rng.integers(-2**31, 2**31, sh, dtype=np.int64).astype(
            np.int32)
    sdir = rng.integers(0, 256, (B, D, HS, WS)).astype(np.uint8)
    sdir4 = np.stack([engine.pack_sdir4(torch.from_numpy(s)).numpy()
                      for s in sdir])
    wb = rng.integers(0, 16, (4,) + sh)
    wnd = (wb[0] | (wb[1] << 8) | (wb[2] << 16) | (wb[3] << 24)).astype(
        np.int32)
    planes = tuple(bits() for _ in range(5)) + (
        rng.random(sh, dtype=np.float32),)
    masks = tuple(rng.random(sh) < p for p in (0.15, 0.1, 0.02))
    inter = rng.random(sh) < 0.1
    dest = rng.integers(-1, D, sh).astype(np.int32)
    randoms = (rng.random(sh, dtype=np.float32),
               rng.random(sh, dtype=np.float32),
               rng.integers(1, 4, sh).astype(np.int32), bits())
    return sdir4, wnd, planes, masks, inter, dest, randoms


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1])
def test_k1_per_world_geometry(seed):
    """The batched K1's plain form with [B, H, W] intersection and
    dest_id == a loop of `decide_move_core` == `decide_move` under
    `torch.func.vmap` == JAX's `decide_move_pallas` (interpret) under
    `jax.vmap`."""
    cfg = Config(**KCFG)
    sdir4, wnd, planes, masks, inter, dest, randoms = _k1_inputs(seed)
    tp = tuple(_t(p) for p in planes)
    tm = tuple(_t(m) for m in masks)
    tr = tuple(_t(r) for r in randoms)
    got = HE.decide_move_batched(cfg, _t(sdir4), _t(wnd), tp, *tm,
                                 _t(inter), _t(dest), tr)
    loop = [HE.decide_move_core(cfg, _t(sdir4[b]), _t(wnd[b]),
                                *(p[b] for p in tp), *(m[b] for m in tm),
                                _t(inter[b]), _t(dest[b]),
                                *(r[b] for r in tr)) for b in range(B)]
    vm = torch.func.vmap(lambda *a: HE.decide_move(
        cfg, a[0], a[1], a[2:8], *a[8:13], a[13:]))(
        _t(sdir4), _t(wnd), *tp, *tm, _t(inter), _t(dest), *tr)
    jcfg = JConfig(**KCFG)

    def jk(s, w, pa, pb, pc, pd, pe, pl, st, ra, pe_, it, de, r0, r1, r2,
           r3):
        return pallas_engine.decide_move_pallas(
            jcfg, s, w, (pa, pb, pc, pd, pe, pl), st, ra, pe_, it, de,
            (r0, r1, r2, r3.view(jnp.uint32)), interpret=True)
    ref = jax.vmap(jk)(*(jnp.asarray(a) for a in (
        sdir4.view(np.uint32), wnd, *planes, *masks, inter, dest,
        *randoms)))
    for k in range(7):
        g = got[k].numpy()
        assert np.array_equal(g, torch.stack([o[k] for o in loop]).numpy())
        assert np.array_equal(g, vm[k].numpy())
        r = np.asarray(ref[k])
        assert np.array_equal(g.view(np.int32), r.view(np.int32)), k
    assert (got[6].numpy() & HE.FLAG_MOVED).any()


def _geo(seed: int):
    rng = np.random.default_rng(seed)
    allowed = rng.integers(0, 16, (B, HS, WS)).astype(np.uint8)
    road = rng.random((B, HS, WS)) < 0.5
    hard = (rng.random((B, HS, WS)) < 0.1) & road
    return rng, allowed, road, hard


# the H100's numbers that choose K1's form: 132 SMs, 232,448 bytes of
# shared memory a block may take (of the SM's 233,472)
H100 = (132, 232448)
SM_SMEM = 233472
BLOCK_RESERVED = 1024            # the shared memory CUDA reserves a block


@pytest.mark.parametrize("B,H,W,form", [
    (1024, 64, 64, "worlds"),        # config #4
    (3, 64, 64, "coop"),             # too few worlds to fill the card
    (1, 64, 64, "coop"),
    (1, 256, 256, "coop"),           # the one-world headline
    (16, 256, 256, "coop"),          # the shared-geometry batch
    (1, 1024, 1024, "coop"),         # config #5
    (1, 100, 100, "coop"),           # config #1: fits, but one world
    (1024, 60, 50, "worlds"),        # ragged, within a block
    (1024, 80, 96, "worlds"),        # 30 tiles: still two blocks an SM
    (1024, 96, 96, "coop"),          # 36 tiles: fits a block, one an SM
    (1024, 128, 128, "coop"),        # 64 tiles: the most a block owns
    (1024, 128, 160, "coop"),        # 80 tiles: larger than a block holds
    (1024, 136, 128, "coop")])       # 68 tiles
def test_k1_form_by_shape(B, H, W, form):
    """K1's form is a function of the shape and the card's numbers
    (`hopper_engine.k1_form`; no card needed): the block-per-world form
    where one world fits one block, two such blocks fit one SM and the
    batch fills the card, the cooperative form everywhere else."""
    assert HE.k1_form(B, H, W, *H100) == form


def test_k1_form_thresholds():
    """The batch that fills the card starts at K1_WORLDS_PER_SM worlds an
    SM; a card whose blocks take less shared memory keeps a 128^2 world
    cooperative, and a 64^2 one where two blocks do not fit an SM;
    config #4's block (52 KB of shared memory) leaves room
    for at least two blocks an SM, and the form is taken exactly where
    two blocks fit the SM's shared memory."""
    n = int(HE.K1_WORLDS_PER_SM * H100[0])
    assert HE.k1_form(n, 64, 64, *H100) == "worlds"
    assert HE.k1_form(n - 1, 64, 64, *H100) == "coop"
    assert HE.k1_form(1024, 128, 128, H100[0], 101376) == "coop"
    # 99 KB a block holds one 64^2 world but one block an SM; 163 KB three
    assert HE.k1_form(1024, 64, 64, H100[0], 101376) == "coop"
    assert HE.k1_form(1024, 64, 64, 108, 166912) == "worlds"
    smem = HE.k1_world_smem(64, 64)
    assert smem == 16 * 256 * 8 + 4096 * 5
    assert 2 * (smem + HE.K1_WORLD_STATIC + BLOCK_RESERVED) <= SM_SMEM
    assert HE.K1_BLOCK_RESERVED == BLOCK_RESERVED
    assert H100[1] + BLOCK_RESERVED == SM_SMEM
    assert HE.k1_world_blocks_per_sm(64, 64, H100[1]) == 4
    for H in range(8, 129, 8):
        for W in range(32, 129, 32):
            need = HE.k1_world_smem(H, W) + HE.K1_WORLD_STATIC
            two = (HE.k1_world_tiles(H, W) <= HE.K1_MAX_TILES
                   and 2 * (need + BLOCK_RESERVED) <= SM_SMEM)
            assert (HE.k1_form(1024, H, W, *H100) == "worlds") == two, (H, W)


@pytest.mark.parametrize("seed", [0, 1])
def test_k3_per_world_geometry(seed):
    """The batched K3's plain form with [B, H, W] allowed and is_road ==
    a loop of `wavefront_core` == `build_wavefront` under vmap == JAX's
    `build_wavefront_pallas` (interpret) under `jax.vmap`."""
    cfg = Config(**KCFG)
    _, allowed, road, hard = _geo(seed)
    got = HE.build_wavefront_batched(cfg, _t(allowed), _t(road), _t(hard))
    loop = torch.stack([HE.wavefront_core(cfg, _t(allowed[b]), _t(road[b]),
                                          _t(hard[b])) for b in range(B)])
    vm = torch.func.vmap(lambda a, r, h: HE.build_wavefront(cfg, a, r, h))(
        _t(allowed), _t(road), _t(hard))
    ref = jax.vmap(lambda a, r, h: pallas_engine.build_wavefront_pallas(
        JConfig(**KCFG), a, r, h, interpret=True))(
        jnp.asarray(allowed.astype(np.int32)), jnp.asarray(road),
        jnp.asarray(hard))
    assert np.array_equal(got.numpy(), loop.numpy())
    assert np.array_equal(got.numpy(), vm.numpy())
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() != 0x07070707).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_k2_per_world_key_stacks(seed):
    """The batched K2's plain form over [B, D, 4, H, W] key stacks and
    [B, 4, H, W] legal planes == a loop of `sdir_encode` ==
    `build_sdir` under vmap == JAX's `build_sdir_pallas` (interpret)
    under `jax.vmap` with the key stack batched."""
    D = 8
    rng, allowed, road, hard = _geo(seed)
    cfg = Config(**KCFG)
    Q = rng.integers(0, 60000, (B, D, 4, HS, WS)).astype(np.int32)
    Q = np.where(rng.random(Q.shape) < 0.15, 65535, Q)
    K0 = engine.costs_u16_to_keys(_t(Q))
    soft2 = _t(rng.integers(0, 5000, (B, HS, WS)).astype(np.int32))
    lp = [engine.entry_costs(cfg, _t(allowed[b]), _t(road[b]), soft2[b],
                             _t(hard[b])) for b in range(B)]
    legal4 = torch.stack([l for l, _ in lp])
    pen4 = torch.stack([p for _, p in lp])
    tp2 = int(round(2 * cfg.VEHICLE_TURN_PENALTY))
    got = HE.build_sdir_stacks(K0, pen4, legal4, tp2)
    loop = torch.stack([HE.sdir_encode(K0[b], pen4[b], legal4[b], tp2)
                        for b in range(B)])
    vm = torch.func.vmap(lambda k, p, lg: HE.build_sdir(k, p, lg, tp2))(
        K0, pen4, legal4)
    ref = jax.vmap(lambda k, p, lg: pallas_engine.build_sdir_pallas(
        JConfig(**KCFG), k, p, lg, interpret=True))(
        jnp.asarray(K0.numpy()), jnp.asarray(pen4.numpy()),
        jnp.asarray(legal4.numpy()))
    assert np.array_equal(got.numpy(), loop.numpy())
    assert np.array_equal(got.numpy(), vm.numpy())
    assert np.array_equal(got.numpy(), np.asarray(ref))
    # a shared key stack beside per-world legal planes: the batched K2
    # with a zero stride, equal to the loop
    mixed = HE.build_sdir_stacks(K0[0], pen4, legal4, tp2)
    assert np.array_equal(mixed.numpy(), torch.stack([
        HE.sdir_encode(K0[0], pen4[b], legal4[b], tp2)
        for b in range(B)]).numpy())
