"""The batched megakernel (K9 with a world dimension) on the CPU: its vmap
rule, its plain batched version, its plan and who owns what.

- Config #4's batch of cities (64^2 worlds from the bench's
  `split(PRNGKey(0), 1024)`) through `run_chunk_batch(10)` on the
  megakernel branch (TSIM_MEGA_INTERPRET) with vmap's per-world fallback
  as an error, against JAX's digest `data/config4_batch_digest.json`
  (`chunk10`, every leaf), with one batched K9 call a segment.
- K9's vmap rule runs the plain batched version once per vmapped call,
  with the chunk tables shared (a shared-geometry batch) and one set a
  world (a batch of cities); each world equals `segment_plain` on its
  own inputs.
- `k9_form` / `k9_plan` by shape at the H100's numbers, and the owners
  of every tile and light item of a batch (`megakernel.block_owners`).

Integer leaves bit for bit; the f32 duration sums of the stats rows
within rtol 1e-5 (their order is the kernel's, as `tests/
test_megakernel.py` allows in JAX).  No JAX compile: the reference is the
shipped digest.
"""

import functools
import hashlib
import json
import os
import warnings

import numpy as np
import pytest
import torch

from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core.transfer import (world_from_leaves,
                                                       world_leaves,
                                                       world_to_numpy)
from trafficsimulation_tpu_torch.ops import engine, megakernel
from trafficsimulation_tpu_torch.ops import hopper_engine as HE
from trafficsimulation_tpu_torch.parallel import mesh

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST = os.path.join(ROOT, "trafficsimulation_tpu_torch", "data",
                      "config4_batch_digest.json")
# the world of tests/test_torch_mega.py (tests/test_megakernel.py's)
MEGA_CFG = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
                MAX_FIELD_DESTS=32, MAX_VEHICLES=256,
                INTERNAL_POPULATION_TRAFFIC_PER_DAY=60000,
                PASSING_POPULATION_TRAFFIC_PER_DAY=20000,
                RAIN_SPAWN_CHANCE=0.2)
DUR_COLS = [megakernel.ST_DUR_I, megakernel.ST_DUR_T, megakernel.ST_DUR_SVC]
# the H100's numbers that choose K9's form (132 SMs, 232,448 bytes of
# shared memory a block may take) and the single-world kernel's registers
H100 = (132, 232448)
K9_REGISTERS = 102


@functools.cache
def _digest() -> dict:
    with open(DIGEST) as f:
        return json.load(f)


@functools.cache
def _config4():
    """(cfg, the digest's worlds as one batch, the indices of the first two
    that reach none of K9's JAX quirks)."""
    d = _digest()
    cfg = Config(**d["cfg"])
    keys = prng.split(prng.PRNGKey(0), d["n_split"])[:d["worlds"]]
    worlds = sim.init_worlds(cfg, keys, "cpu")
    clean = [b for b in range(d["worlds"])
             if not megakernel.quirks(cfg, mesh.world_at(worlds, b))]
    return cfg, worlds, clean[:2]


def test_config4_megakernel_batch_matches_jax_digest(monkeypatch):
    """10 ticks of config #4's chunk on the megakernel branch under vmap:
    one plain batched K9 call a segment for the whole batch, no K1 or K4,
    no per-world fallback of vmap, and the worlds equal JAX's digest on
    every leaf.  A world of the digest that reaches one of K9's JAX quirks
    (a queue run over 127 cells, two blocks on one service cell, a valid
    block with no destination: the megakernel path then differs from the
    per-tick path JAX's digest ran) gives way to the digest's next
    world; worlds 0 and 1 reach none."""
    cfg, worlds, picked = _config4()
    assert len(picked) == 2, "the digest holds no two worlds without quirks"
    assert picked == [0, 1]
    batch = world_from_leaves({k: t[picked] for k, t in
                               world_leaves(worlds).items()})
    calls, seen = {}, []
    for name in ("mega_segment_batched", "decide_move_batched",
                 "prefix_planes_batched"):
        def spy(*a, _name=name, _fn=getattr(HE, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            seen.append(a)
            return _fn(*a, **k)
        monkeypatch.setattr(HE, name, spy)
    monkeypatch.delenv("TSIM_NO_MEGAKERNEL", raising=False)
    monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*batching rule.*")
            end = mesh.run_chunk_batch(cfg, batch, 10)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert calls == {"mega_segment_batched": 2}
    # what the card's wrapper would take without a copy: every input of
    # one world's shape, each world's tensor contiguous, all per world
    for _, args, B, batched in seen:
        assert B == 2 and set(batched) == set(args)
        assert HE.check_mega_inputs(args, B, batched)["R"] == 5
    got = world_to_numpy(end)
    for b, w in enumerate(picked):
        want = _digest()["chunk10"][w]
        assert set(got) == set(want), set(got) ^ set(want)
        bad = []
        for k, d in want.items():
            a = np.array(got[k][b], order="C")
            if (str(a.dtype) != d["dtype"] or list(a.shape) != d["shape"]
                    or hashlib.sha256(a.tobytes()).hexdigest()
                    != d["sha256"]):
                bad.append(k)
        assert not bad, f"world {w}: leaves differ from JAX: {bad}"


def _segment_args(cfg, world, R: int) -> dict:
    """K9's inputs for the next R ticks of one world, as `run_chunk`
    launches them on the megakernel path."""
    es = sim._enter_engine(cfg, world)
    cs = megakernel.build_chunk_static(cfg, world)
    draws, _ = engine.tick_draws(cfg, sim._key_np(world.key), R)
    args, _ = megakernel.segment_inputs(
        cfg, world, es, cs, engine.routing_planes(cfg, world, es), R,
        torch.from_numpy(draws))
    return args


@functools.cache
def _batches():
    """{"shared": one world's geometry, 3 keys, each run 4 ticks;
    "per_world": config #4's worlds 0-2 (each its own city), run 4 ticks}:
    (cfg, the worlds' K9 inputs for their next 5 ticks, the names that
    carry a world dim: in the shared batch all but the chunk tables)."""
    cfg = Config(**MEGA_CFG, TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED")
    world = sim.init_world(cfg, prng.PRNGKey(3), "cpu")
    cfg, world = sim.measure_and_shrink(cfg, world)
    world = sim.inject_vehicles(cfg, world, 120)
    shared = []
    for k in ([0, 3], [7, 9], [1, 2026]):
        w = world.replace(key=torch.tensor(k, dtype=torch.int32))
        shared.append(_segment_args(cfg, sim.run_chunk(cfg, w, 4), 5))
    c4, worlds, _ = _config4()
    worlds = mesh.run_chunk_batch(c4, worlds, 4)
    per = [_segment_args(c4, mesh.world_at(worlds, b), 5) for b in range(3)]
    tables = set(megakernel.build_chunk_static(cfg, world))
    for k in tables & set(shared[0]):
        assert all(torch.equal(a[k], shared[0][k]) for a in shared), k
    return {"shared": (cfg, shared, set(shared[0]) - tables),
            "per_world": (c4, per, set(per[0]))}


def _stack(args, batched):
    return {k: torch.stack([a[k] for a in args]) if k in batched else
            args[0][k] for k in args[0]}


def _assert_segment_equal(got: dict, ref: dict, where: str):
    for k in HE.MEGA_OUTPUTS:
        g, r = got[k], ref[k]
        assert g.shape == r.shape and g.dtype == r.dtype, (where, k)
        if k == "stats":
            keep = [c for c in range(g.shape[-1]) if c not in DUR_COLS]
            assert torch.equal(g[..., keep], r[..., keep]), (where, k)
            assert torch.allclose(g[..., DUR_COLS], r[..., DUR_COLS],
                                  rtol=1e-5, atol=0.0), (where, k)
        elif g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), r.view(torch.int32)), \
                (where, k)
        else:
            assert torch.equal(g, r), (where, k)


@pytest.mark.parametrize("tables", ["shared", "per_world"])
def test_vmap_rule_calls_the_plain_batched_version_once(tables, monkeypatch):
    """`mega_segment` under torch.func.vmap over 3 worlds: the rule
    passes every batched input with its world dim first and contiguous
    (what the card's wrapper takes without a copy), the shared ones as
    they are, to one call of the plain batched version; world b equals
    `segment_plain` on world b's inputs.  The chunk tables are shared by
    the worlds of one city and batched for a batch of cities."""
    cfg, args, batched = _batches()[tables]
    assert ({"qrun", "lown", "b_mask", "g_destid"} <= batched) \
        == (tables == "per_world")
    assert {"sdir4", "pa", "ticks", "li"} <= batched
    a = _stack(args, batched)
    seen = []
    plain = megakernel.segment_plain_batched

    def spy(cfg_, a_, B, names):
        seen.append((B, set(names)))
        for k in names:
            assert a_[k].shape[0] == B and a_[k].is_contiguous(), k
        for k in set(a_) - set(names):
            assert a_[k] is a[k], k
        return plain(cfg_, a_, B, names)
    monkeypatch.setattr(megakernel, "segment_plain_batched", spy)
    in_dims = ({k: 0 if k in batched else None for k in a},)
    out = torch.func.vmap(lambda x: HE.mega_segment(cfg, x),
                          in_dims=in_dims)(a)
    assert seen == [(3, batched)]
    assert HE.check_mega_inputs(a, 3, batched)["R"] == 5
    for b in range(3):
        _assert_segment_equal({k: v[b] for k, v in out.items()},
                              megakernel.segment_plain(cfg, args[b]),
                              f"world {b}")
    # the worlds moved, each its own way
    for b in range(3):
        assert not torch.equal(out["pa"][b], args[b]["pa"])
    assert not torch.equal(out["pa"][0], out["pa"][1])


@pytest.mark.parametrize("B,H,W,plan", [
    # the shared-geometry batch: 16 worlds of 256 tiles, 16 a block
    (16, 256, 256, dict(form="coop", blocks=256, tiles_per_block=16,
                        blocks_per_world=16, worlds_per_group=16, groups=1,
                        smem_bytes=32768)),
    # config #4: one block a world
    (1024, 64, 64, dict(form="worlds", blocks=1024, tiles_per_block=16,
                        blocks_per_world=1, worlds_per_group=1024, groups=1,
                        smem_bytes=16 * 256 * 8 + 4096 * 5)),
    # too few small worlds to fill the card
    (3, 64, 64, dict(form="coop", blocks=48, tiles_per_block=1,
                     blocks_per_world=16, worlds_per_group=3, groups=1,
                     smem_bytes=2048)),
    # one world: the single-world grid (256 blocks of one tile)
    (1, 256, 256, dict(form="coop", blocks=256, tiles_per_block=1,
                       blocks_per_world=256, worlds_per_group=1, groups=1,
                       smem_bytes=2048)),
    # more tiles than one resident grid holds: two world groups
    (64, 256, 256, dict(form="coop", blocks=256, tiles_per_block=32,
                        blocks_per_world=8, worlds_per_group=32, groups=2,
                        smem_bytes=65536))])
def test_k9_form_and_plan_by_shape(B, H, W, plan):
    """K9's form and launch are functions of the shape and the card's
    numbers (`k9_form`, `k9_plan`; the kernel's library must plan the same
    on the card, `mega_plan`): the block-per-world form where a world fits
    one block, two such blocks fit an SM and the batch fills the card;
    else the cooperative form on the fewest tiles a block whose resident
    grid (2 blocks an SM at 102 registers) holds the batch, in world
    groups where none does."""
    assert HE.k9_form(B, H, W, *H100) == plan["form"]
    assert HE.k9_plan(B, H, W, *H100, K9_REGISTERS) == plan


def test_k9_refuses_what_neither_form_takes():
    """A world whose tiles fit neither one block nor one cooperative grid
    at 64 tiles a block raises ValueError naming the shape; so do an empty
    batch and a forced block-per-world form for a world too large for a
    block."""
    with pytest.raises(ValueError, match="2048 x 2048"):
        HE.k9_form(1, 2048, 2048, *H100)
    with pytest.raises(ValueError, match="2048 x 2048"):
        HE.k9_plan(4, 2048, 2048, *H100, K9_REGISTERS)
    with pytest.raises(ValueError):
        HE.k9_form(0, 64, 64, *H100)
    with pytest.raises(ValueError, match="256 x 256"):
        HE.k9_plan(16, 256, 256, *H100, K9_REGISTERS, form="worlds")
    # the largest square world one cooperative grid takes: 132 blocks of
    # 64 tiles (one an SM at 128 KB of state words and work list)
    assert HE.k9_form(1, 1448, 1448, *H100) == "coop"
    # the block-per-world form needs two blocks an SM: not on a card whose
    # blocks take 99 KB
    assert HE.k9_form(1024, 64, 64, 132, 101376) == "coop"
    assert HE.k9_form(263, 64, 64, *H100) == "coop"
    assert HE.k9_form(264, 64, 64, *H100) == "worlds"


@pytest.mark.parametrize("B,H,W,form", [(3, 64, 64, None), (5, 64, 64,
                                                             "worlds"),
                                        (64, 256, 256, None),
                                        (1, 256, 256, None)])
def test_block_owners_give_each_item_one_owner(B, H, W, form):
    """Every (world, tile) and every (world, pseudo-group) of a launch has
    exactly one owning block (`block_owners`, the kernel's loops), whose
    world it is; with each world's own owner table (config #4's worlds,
    cycled) every queue run, light and stop run of every world that
    covers a cell is listed under exactly one block, the block
    `light_owners` names at the plan's blocks a world."""
    plan = HE.k9_plan(B, H, W, *H100, K9_REGISTERS, form=form)
    c4, worlds, _ = _config4()
    cs = [megakernel.build_chunk_static(c4, mesh.world_at(worlds, b))
          for b in range(2)]
    G = worlds.lights.current_phase.shape[-1]
    own = megakernel.block_owners(plan, B, H, W, G)
    per_world = -(-H // 8) * -(-W // 32)
    tiles, groups = {}, {}
    for (gi, blk), (w, ts, gs) in own.items():
        for t in ts:
            tiles[w, t] = tiles.get((w, t), 0) + 1
        for g in gs:
            groups[w, g] = groups.get((w, g), []) + [blk]
    assert set(tiles) == {(w, t) for w in range(B) for t in range(per_world)}
    assert set(tiles.values()) == {1}
    assert set(groups) == {(w, g) for w in range(B) for g in range(G + 1)}
    assert {len(v) for v in groups.values()} == {1}
    bpw = plan["blocks_per_world"]
    for w in range(B):
        t = cs[w % 2]
        NQ, NS = t["qrun"].shape[0], t["srun"].shape[0]
        L = t["l_group"].shape[0]
        lo = megakernel.light_owners(t["lown"], G, NQ, L, NS, t["srun"],
                                     c4.HEIGHT, c4.WIDTH, bpw)
        n = G + 3
        tab = t["lown"].numpy()
        for name, k, size in (("queue_run", 0, NQ), ("light", 1, L),
                              ("stop_run", 2, NS)):
            off = tab[k * n:(k + 1) * n]
            idx = tab[3 * n + [0, NQ, NQ + L][k]:][:size]
            listed = np.zeros(size, np.int64)
            for g in range(G + 1):
                blk = groups[w, g][0]
                for item in idx[off[g]:off[g + 1]]:
                    listed[item] += 1
                    assert lo[name][item] == blk % bpw, (w, name, item)
            covers = lo[name] >= 0
            assert (listed[covers] == 1).all() and \
                (listed[~covers] == 0).all(), (w, name)
