"""World generation in the PyTorch port against the JAX package, on the
CPU: the generation draws of `prng`, connected-component labelling, the
whole `generate_city` pipeline (two seeds, every leaf and the cost
field), sub-block road carving, demand (`generate_days` as the jitted world
init runs it), and
`init_world` + `measure_and_shrink` + `inject_vehicles`, every leaf.
All of it must be bit-equal; the one tolerance is `normal` itself (XLA's
log1p inside its ErfInv differs from numpy's in the last bit for about 1%
of draws; the draws the bands use come out bit-equal in XLA's fused
form, checked below).  The JAX generator compiles once per worker (the
session fixtures `gen_fn`, `small_city`, `small_world`)."""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trafficsimulation_tpu import sim as jsim
from trafficsimulation_tpu.agents import demand as jdemand
from trafficsimulation_tpu.gen.subblocks import \
    carve_subblock_roads as jcarve
from trafficsimulation_tpu.ops import labels as jlabels

from trafficsimulation_tpu_torch import prng
from trafficsimulation_tpu_torch import sim as tsim
from trafficsimulation_tpu_torch.agents import demand as tdemand
from trafficsimulation_tpu_torch.config import Config as TConfig
from trafficsimulation_tpu_torch.core.transfer import world_to_numpy
from trafficsimulation_tpu_torch.gen import bands, generate, raster
from trafficsimulation_tpu_torch.gen.subblocks import carve_subblock_roads
from trafficsimulation_tpu_torch.ops import labels

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)

KEYS = np.stack([np.asarray(jax.random.PRNGKey(s * 7919 + 5))
                 for s in range(400)])


def _tcfg(jcfg) -> TConfig:
    """The port's Config with the JAX one's non-default values."""
    import dataclasses
    base = type(jcfg)()
    return TConfig(**{f.name: getattr(jcfg, f.name)
                      for f in dataclasses.fields(jcfg)
                      if getattr(jcfg, f.name) != getattr(base, f.name)})


def assert_leaves_equal(ref: dict, got: dict):
    """Same leaf set, dtypes, shapes and bits."""
    assert ref.keys() == got.keys(), sorted(set(ref) ^ set(got))
    bad = [(k, int((a != got[k]).sum()) if a.shape == got[k].shape
            else (a.shape, got[k].shape))
           for k, a in ref.items()
           if a.dtype != got[k].dtype or not np.array_equal(a, got[k])]
    assert not bad, f"leaves differ (name, entries): {bad}"


def _struct_leaves(obj) -> dict:
    import dataclasses
    return {f.name: getattr(obj, f.name).numpy()
            for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


# ---- prng ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (3, 5)])
def test_prng_shaped_draws_match_jax(shape):
    for k in KEYS[:40]:
        assert np.array_equal(np.asarray(jax.random.uniform(k, shape)),
                              prng.uniform(k, shape))
        assert np.array_equal(
            np.asarray(jax.random.randint(k, shape, 6, 19)),
            prng.randint(k, 6, 19, shape))
        assert np.array_equal(
            np.asarray(jax.random.bernoulli(k, 0.3, shape)),
            prng.bernoulli(k, 0.3, shape))
    assert prng.PRNGKey(7).tolist() == np.asarray(
        jax.random.PRNGKey(7)).tolist()


def test_prng_normal_matches_jax():
    """`normal` within 4 ulp of JAX and bit-equal on at least 98% of the
    keys (the erfinv of the same uniform draw); `mean + std * normal` as
    XLA compiles it, one fused multiply-add of erfinv(u) and the folded
    constant SQRT2 * std, is bit-equal given JAX's erfinv."""
    ks = jnp.asarray(KEYS)
    ref = np.asarray(jax.jit(jax.vmap(jax.random.normal))(ks))
    got = prng.normal(KEYS)
    ulp = np.abs(ref.view(np.int32).astype(np.int64)
                 - got.view(np.int32).astype(np.int64))
    assert ulp.max() <= 4 and (ulp == 0).mean() >= 0.98, \
        (ulp.max(), (ulp == 0).mean())
    f32 = np.float32
    lo = np.nextafter(f32(-1), f32(0))
    u = np.maximum(lo, prng._fma32(prng._unit(prng.bits(KEYS, (1,))[:, 0]),
                                   f32(1) - lo, lo))
    e_ref = np.asarray(jax.jit(jax.scipy.special.erfinv)(u))
    e_got = prng.erfinv32(u)
    assert (e_ref == e_got).mean() >= 0.98
    ref_p = np.asarray(jax.jit(jax.vmap(
        lambda k: 0.70 + 0.05 * jax.random.normal(k)))(ks))
    assert np.array_equal(ref_p, prng._fma32(e_ref, prng.SQRT2 * f32(0.05),
                                             f32(0.70)))


# ---- labels ----------------------------------------------------------------

def test_labels_match_jax():
    rng = np.random.default_rng(3)
    cc = jax.jit(jlabels.connected_components)
    cck = jax.jit(jlabels.connected_components_keyed)
    compact = jax.jit(functools.partial(jlabels.compact_labels,
                                        max_items=40))
    for p in (0.45, 0.6, 0.75):
        mask = rng.random((40, 56)) < p
        keys = rng.integers(0, 3, (40, 56)).astype(np.int32)
        ref = np.asarray(cc(mask))
        got = labels.connected_components(torch.from_numpy(mask))
        assert np.array_equal(ref, got.numpy())
        assert np.array_equal(
            np.asarray(cck(mask, keys)),
            labels.connected_components_keyed(
                torch.from_numpy(mask), torch.from_numpy(keys)).numpy())
        for a, b in zip(compact(ref), labels.compact_labels(got, 40)):
            assert np.array_equal(np.asarray(a), b.numpy())


# ---- generate_city ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_generate_city_matches_jax(small_cfg, gen_fn, small_city, seed):
    ref = small_city if seed == 0 else jax.block_until_ready(
        gen_fn(jax.random.PRNGKey(seed)))
    got = generate.generate_city(_tcfg(small_cfg),
                                 np.asarray(jax.random.PRNGKey(seed)), "cpu")
    for r, g in zip(ref[:5], got[:5]):
        assert_leaves_equal(world_to_leaves(r), _struct_leaves(g))
    assert np.array_equal(np.asarray(ref[5]), got[5].numpy())
    assert bool(got[0].intersection.any()) and bool(got[1].valid.any())


def test_carve_subblock_roads_matches_jax(small_cfg):
    """Sub-block carving (default off) on the rasterised small city."""
    jcfg = small_cfg.replace(CARVE_SUBBLOCK_ROADS=True, SUBBLOCK_CHANGE=0.9,
                             MIN_SUBBLOCK_SPACING=2)
    tcfg = _tcfg(jcfg)
    caps = tcfg.capacities()
    key = np.asarray(jax.random.PRNGKey(11))
    kh, kv = prng.split(key, 2)
    hb = bands.sample_axis_bands(kh, tcfg, tcfg.interior_y_min,
                                 tcfg.interior_y_max, True, caps.max_bands)
    vb = bands.sample_axis_bands(kv, tcfg, tcfg.interior_x_min,
                                 tcfg.interior_x_max, False, caps.max_bands)
    ras = raster.rasterize(tcfg, hb, vb, "cpu")
    cell, allowed = ras["cell_type"], ras["allowed_dirs"]
    ref = jax.jit(functools.partial(jcarve, jcfg,
                                    max_blocks=caps.max_blocks))(
        key, cell.numpy(), allowed.numpy())
    got = carve_subblock_roads(tcfg, key, cell, allowed, caps.max_blocks)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert not torch.equal(got[0], cell), "nothing was carved"


# ---- demand ----------------------------------------------------------------

def test_generate_days_matches_jax(small_cfg, small_world):
    """The jitted JAX call, as the world init makes it (fused f32).  The
    eager call of the sim's regeneration (unfused) is held to JAX in
    test_torch_sim.py."""
    w = small_world
    bs, d = w.blocks_static, w.dests
    DF = int(w.cost_field.shape[0])
    layout = jdemand.trip_layout(small_cfg)
    tl = tdemand.trip_layout(_tcfg(small_cfg))
    assert all(np.array_equal(getattr(layout, f), getattr(tl, f))
               for f in ("zone_start", "zone_end", "kind", "o_code",
                         "d_code", "j_idx", "n_svc"))
    key = jax.random.PRNGKey(9)
    args = (bs.valid, bs.btype, bs.dest, bs.entrance, d.valid, d.kind,
            d.hw_pos, d.hw_valid)
    fn = functools.partial(jdemand.generate_days, small_cfg, layout,
                           start_day=jnp.int32(1), n_days=2,
                           current_tick=jnp.int32(3000), n_field_dests=DF)
    names = ("blk_valid", "blk_btype", "blk_dest", "blk_entrance",
             "dest_valid", "dest_kind", "entrance_pos", "entrance_valid")
    # as the JAX world init calls it: day and tick are constants of the
    # jitted function
    ref = jax.jit(fn)(key, **dict(zip(names, args)))
    got = tdemand.generate_days(
        _tcfg(small_cfg), tl, np.asarray(key), 1, 2,
        torch.tensor(3000, dtype=torch.int32),
        *(torch.from_numpy(np.array(a)) for a in args), DF)
    assert_leaves_equal(world_to_leaves(ref), _struct_leaves(got))
    assert int(got.valid.sum()) > 0


# ---- init_world ------------------------------------------------------------

def test_init_world_shrink_inject_match_jax(small_cfg, small_world):
    from bench import inject_vehicles
    tcfg = _tcfg(small_cfg)
    port = tsim.init_world(tcfg, prng.PRNGKey(0), "cpu")
    assert_leaves_equal(world_to_leaves(small_world), world_to_numpy(port))
    cfg2, w2 = jsim.measure_and_shrink(small_cfg, small_world)
    tcfg2, p2 = tsim.measure_and_shrink(tcfg, port)
    assert tcfg2 == _tcfg(cfg2)
    assert_leaves_equal(world_to_leaves(w2), world_to_numpy(p2))
    assert_leaves_equal(world_to_leaves(inject_vehicles(cfg2, w2, 150)),
                        world_to_numpy(tsim.inject_vehicles(tcfg2, p2, 150)))
    tsim.assert_world_fits(tcfg2, p2)
