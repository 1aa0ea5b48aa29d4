"""The RL light controllers in the port's world batches, and the draws
that make the port's RL JAX's own.

* `rl/nets.init_params` equals flax's `net.init` bit for bit for the
  three families at the Config's default widths, under one key and under
  a stack of `split` keys (JAX's `init_world` under vmap).
* `prng.truncated_normal` (with its erf bounds as f32 literals),
  `prng.gumbel` and XLA's CPU `log` / `log1p` transcriptions
  (`prng.log32`, `prng.log1p32`) equal jitted JAX bit for bit: the
  Gumbel transform over a dense sample of [tiny, 1) (2^24 values spread
  over every exponent) and its edge values.
* The functional training step (`torch.func.grad`, the flat Adam with
  the bias corrections as tensors) of a batch under vmap gives each
  world's own update, and the interleaved GAE's custom op under vmap
  each world's host recurrence.
* The batch runners with each family against JAX's vmapped digest
  (`data/rl_batch_digest.json`, `tools/make_torch_rl_batch_digest.py`):
  the crossroad as a shared-geometry batch of 4 (`run_batch_shared`),
  and 3 generated 64x64 cities (`init_world_batch`, `run_chunk_batch`,
  `run_batch`), narrow nets, each world training at least 3 times.
  Every leaf's sha256 equals JAX's but the trained floats (`NEAR`:
  parameters, Adam moments, A2C's value outputs), which the digest also
  ships whole (`data/rl_batch_trained.npz`): they agree element by
  element within `RTOL` and an absolute `ATOL` times the leaf's largest
  magnitude, up to 1 (the batched and JAX's matrix products sum in other orders),
  or, in the per-world batch, within twice JAX's own spread (`_spread`).
  Adam turns a gradient near 0, whose sign the summation order decides,
  into a step of up to lr, and GAT-DQN's attention kernel has such
  gradients: there JAX's batched and single-world compiles of the same
  run lie up to 9.9e-5 apart after 11 updates at lr 1e-3, and the port
  up to 1.41 times that spread from JAX's batch beside the tolerance
  (REINFORCE and A2C within the tolerance).
  The near ties of the actions (`rl/ties.py`) are counted in the port's
  run and must be none.
  functorch's per-world fallback warning is an error here.

No JAX compile of the simulation: the JAX side is the digest, the
flax inits and the draw transforms.
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

from trafficsimulation_tpu.rl import nets as jnets

from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth, transfer
from trafficsimulation_tpu_torch.parallel import mesh
from trafficsimulation_tpu_torch.rl import controllers as tctl
from trafficsimulation_tpu_torch.rl import nets as tnets
from trafficsimulation_tpu_torch.rl import ties

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(__file__), "..",
                    "trafficsimulation_tpu_torch", "data")
RTOL, ATOL = 1e-4, 1e-5     # ATOL times the leaf's largest magnitude (<= 1)
NEAR = ("rl.params.", "rl.target_params.", "rl.opt_state.0.mu.",
        "rl.opt_state.0.nu.", "rl.roll_v")
f32 = np.float32


def _assert_close(got, ref, msg: str, spread: float = 0.0):
    """Element by element within RTOL and an absolute ATOL times max
    |ref| (at most ATOL), plus twice `spread` (`_spread`)."""
    ref = np.asarray(ref)
    scale = min(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, err_msg=msg,
                               atol=ATOL * scale + 2 * spread)


@pytest.fixture(autouse=True)
def _no_vmap_fallback():
    """functorch's "performance drop" warning (an op without a batching
    rule, run world by world) is an error in this file."""
    F = torch._C._functorch
    F._set_vmap_fallback_warning_enabled(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield
    F._set_vmap_fallback_warning_enabled(False)


# ---- Part A: the draws ---------------------------------------------------

FLAX = [("policy", (13, 128, 10)), ("actor_critic", (13, 256, 10)),
        ("gat", ())]


def _flax_net(kind, args):
    if kind == "gat":
        return jnets.GATQNet(), (jnp.zeros((1, 5, 9)), jnp.zeros((1, 5)))
    cls = jnets.PolicyMLP if kind == "policy" else jnets.ActorCritic
    return cls(args[1], args[2]), (jnp.zeros((1, args[0])),)


def _flat(variables) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(variables["params"])
    return {".".join(k.key for k in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("kind,args", FLAX, ids=[k for k, _ in FLAX])
def test_init_params_are_flax_draws(kind, args):
    """The world key PRNGKey(0) and 3 split keys of a batch, through one
    jitted `jax.vmap` of flax's `init` (as `init_world_batch` runs it;
    the eager init of one world gives the same bits: the crossroad tests
    of test_torch_rl.py and test_torch_synth.py hold those), against
    `init_params` of each key alone and of the stack of 3."""
    fnet, dummy = _flax_net(kind, args)
    net = tnets.build(kind, *args)
    keys = np.concatenate([np.asarray(jax.random.PRNGKey(0))[None],
                           np.asarray(jax.random.split(
                               jax.random.PRNGKey(7), 3))])
    ref = _flat(jax.jit(jax.vmap(lambda k: fnet.init(k, *dummy)))(keys))
    for got, rows in ((tnets.init_params(net, keys[0], "cpu"), 0),
                      (tnets.init_params(net, keys[1:], "cpu"),
                       slice(1, None))):
        assert set(ref) == set(got)
        for k, a in ref.items():
            b = got[k].numpy()
            assert a[rows].dtype == b.dtype and a[rows].shape == b.shape, k
            assert np.array_equal(a[rows].view(np.int32), b.view(np.int32)), k


def test_truncated_normal_and_fold_in_match_jax():
    erf = jax.jit(lambda lo: jax.lax.erf(lo.astype(jnp.float32)
                                         / np.float32(np.sqrt(2))))
    assert np.asarray(erf(np.int32(-2))).view(np.int32) == \
        prng.TRUNC_LO.view(np.int32)
    assert np.asarray(erf(np.int32(2))).view(np.int32) == \
        prng.TRUNC_HI.view(np.int32)
    for s in range(3):
        key = jax.random.PRNGKey(s * 101 + 5)
        ref = np.asarray(jax.random.truncated_normal(key, -2, 2, (1 << 18,)))
        got = prng.truncated_normal(np.asarray(key), (1 << 18,))
        assert np.array_equal(ref.view(np.int32), got.view(np.int32))
        # the card's form: the bits hashed by torch (here on the CPU)
        assert torch.equal(prng.truncated_normal(np.asarray(key), (64, 33),
                                                 "cpu"),
                           torch.from_numpy(ref[:64 * 33].reshape(64, 33)
                                            .copy()))
        for d in (0, 1, 0xDEADBEEF):
            assert np.array_equal(np.asarray(jax.random.fold_in(key, d)),
                                  prng.fold_in(np.asarray(key), d))


def test_device_draws_equal_the_host_draws():
    """The forms the card's plan and parameter draws take (`bits_on`:
    threefry in torch int64, here on the CPU) against numpy's, key
    stacks and traced maxvals included."""
    k = prng.split(prng.PRNGKey(3), 12).reshape(3, 4, 2)
    mx = np.array([[1, 5, 0, 9999], [2 ** 31 - 1, 7, 3, 65537],
                   [1, 1, 2, 300]])
    for host, dev in (
            (prng.bits(k, (3, 5)), prng.bits_on(k, (3, 5), "cpu")),
            (prng.randint(k, 0, mx, (64,)),
             prng.randint(k, 0, mx, (64,), "cpu")),
            (prng.randint(k, 0, 2, (7,)), prng.randint(k, 0, 2, (7,), "cpu")),
            (prng.gumbel(k, (5, 2)), prng.gumbel(k, (5, 2), "cpu")),
            (prng.uniform(k, (7,)), prng.uniform(k, (7,), "cpu"))):
        assert np.array_equal(np.asarray(host).astype(np.float64),
                              dev.numpy().astype(np.float64))


def _dense(lo: int, hi: int, n: int, seed: int) -> np.ndarray:
    """n f32 between the bit patterns lo and hi, uniform in the bits (so
    every exponent gets its share)."""
    b = np.random.default_rng(seed).integers(lo, hi, n, dtype=np.int64)
    return b.astype(np.int32).view(np.float32)


def test_gumbel_is_xla_bit_for_bit():
    """The transform over 2^24 values of [tiny, 1) spread over every
    exponent, and its edges; `gumbel` on keys; `log32` on (0, 2^64)."""
    tiny = np.finfo(f32).tiny
    edges = np.array([tiny, np.nextafter(tiny, f32(1)), 2.0 ** -126 * 3,
                      2.0 ** -23, 0.5, np.nextafter(f32(0.5), f32(0)),
                      np.nextafter(f32(1), f32(0)), 1 - 2.0 ** -23,
                      0.70710677, 0.7071068], f32)
    u = np.concatenate([_dense(0x00800000, 0x3F800000, 1 << 24, 1), edges])
    ref = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x)))(u))
    got = prng.gumbel_of(u)
    assert np.array_equal(ref.view(np.int32), got.view(np.int32)), \
        f"{int((ref != got).sum())} of {u.size} differ"
    x = np.concatenate([_dense(0x00800000, 0x5F800000, 1 << 20, 2),
                        np.array([0.0, np.inf, 1.0, 2.0, 1e-45], f32)])
    assert np.array_equal(np.asarray(jax.jit(jnp.log)(x)).view(np.int32),
                          prng.log32(x).view(np.int32))
    y = _dense(0x00800000, 0x3F700000, 1 << 18, 3) * f32(-1)
    y = np.concatenate([y, -y, np.array([0.0, 0.41421357, -0.41421357,
                                         0.4142136], f32)])
    assert np.array_equal(np.asarray(jax.jit(jnp.log1p)(y)).view(np.int32),
                          prng.log1p32(y).view(np.int32))
    for s in range(4):
        key = jax.random.PRNGKey(s)
        ref = np.asarray(jax.random.gumbel(key, (1 << 16, 2)))
        got = prng.gumbel(np.asarray(key), (1 << 16, 2))
        assert np.array_equal(ref.view(np.int32), got.view(np.int32))


# ---- the functional training step ------------------------------------------

FAMILIES = ("NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED", "GAT_DQN_BATCHED")


def _random_state(cfg: Config, G: int, seed: int):
    """A train state of the family with random buffers, rollout and Adam
    moments (`test_torch_rl.py`'s forced-training case, port side)."""
    rng = np.random.default_rng(seed)
    ts = tctl.init_rl_state(cfg, G, prng.PRNGKey(seed), "cpu")

    def rnd(x, scale=1.0):
        return torch.from_numpy((rng.normal(size=tuple(x.shape)) * scale)
                                .astype(np.float32))

    def ints(x, hi=2):
        return torch.from_numpy(rng.integers(0, hi, tuple(x.shape))
                                .astype(np.int32))
    opt = tctl.Adam(count=torch.tensor(5, dtype=torch.int32),
                    mu={k: rnd(v, 1e-3) for k, v in ts.params.items()},
                    nu={k: rnd(v, 1e-5).abs() for k, v in ts.params.items()})
    ts = ts.replace(opt_state=opt)
    if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM == "RL_A2C_BATCHED":
        return ts.replace(roll_s=rnd(ts.roll_s, 3), roll_r=rnd(ts.roll_r, 4),
                          roll_v=rnd(ts.roll_v, 2), roll_a=ints(ts.roll_a),
                          roll_m=torch.from_numpy(
                              rng.random(tuple(ts.roll_m.shape)) < 0.8),
                          global_step=torch.tensor(3, dtype=torch.int32))
    ts = ts.replace(buf_s=rnd(ts.buf_s, 3), buf_r=rnd(ts.buf_r, 4),
                    buf_a=ints(ts.buf_a),
                    filled=torch.tensor(150, dtype=torch.int32))
    if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM == "GAT_DQN_BATCHED":
        ts = ts.replace(buf_ns=rnd(ts.buf_ns, 3),
                        buf_m=(rnd(ts.buf_m) > 0).float(),
                        buf_nm=(rnd(ts.buf_nm) > 0).float())
    return ts


def _update(cfg, ts, tick):
    net = tctl.net_of(cfg)
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    fn = {"NEIGHBOR_RL_BATCHED": tctl._srl_train,
          "RL_A2C_BATCHED": tctl._a2c_update,
          "GAT_DQN_BATCHED": tctl._gat_train}[algo]
    return fn(cfg, net, ts, tick)


def _leaves(ts) -> dict:
    w = transfer.world_from_numpy({}, "cpu").replace(rl=ts)
    return transfer.world_to_numpy(w)


@pytest.mark.parametrize("algo", FAMILIES)
def test_vmapped_update_is_each_worlds_update(algo):
    """One forced update at the Config's default widths for a batch of 3
    random train states under vmap (`torch.func.grad` and the flat Adam
    inside it): world b equals its own update (test_torch_rl.py holds the
    one-world update to the autograd form it replaced, bit for bit)."""
    cfg = Config(TRAFFIC_LIGHT_AGENT_ALGORITHM=algo)
    states = [_random_state(cfg, 37, s) for s in range(3)]
    rng = np.random.default_rng(1)
    bs = cfg.SRL_BATCH_SIZE if algo != "GAT_DQN_BATCHED" else \
        cfg.GAT_BATCH_SIZE
    bc = tctl._bias_corrections(np.array([6, 6, 6]))
    ticks = [tctl.RLTick(
        bidx=torch.from_numpy(rng.integers(0, 150, bs)),
        train=torch.tensor(True), sync=torch.tensor(True),
        bc1=torch.tensor(bc["bc1"][0]), bc2=torch.tensor(bc["bc2"][0]),
        train_any=True, train_all=True) for _ in range(3)]
    new = [_leaves(_update(cfg, s, t)) for s, t in zip(states, ticks)]
    batch = _stack([tctl.tree(s) for s in states])
    tk = {k: torch.stack([getattr(t, k) for t in ticks])
          for k in ("bidx", "train", "sync", "bc1", "bc2")}

    def one(b, t):
        out = _update(cfg, tctl.untree(states[0], b), tctl.RLTick(
            train_any=True, train_all=True, **t))
        return tctl.tree(out)
    out = torch.func.vmap(one)(batch, tk)
    for b in range(3):
        got = _leaves(tctl.untree(states[0], _index(out, b)))
        for k, a in new[b].items():
            _assert_close(got[k], a, k)


def _stack(trees: list):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    return torch.stack(trees)


def _index(tree, b: int):
    if isinstance(tree, dict):
        return {k: _index(v, b) for k, v in tree.items()}
    return tree[b]


def test_interleaved_gae_op_under_vmap_is_the_host_recurrence():
    rng = np.random.default_rng(0)
    B, N = 4, 6 * 37
    r = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, N)).astype(np.float32))
    m = torch.from_numpy(rng.random((B, N)) < 0.8)
    got = torch.func.vmap(lambda a, b, c: tctl.interleaved_gae(
        0.8, 0.75, a, b, c))(r, v, m)
    for b in range(B):
        one = tctl.interleaved_gae(0.8, 0.75, r[b], v[b], m[b])
        assert torch.equal(got[b], one)
        # the recurrence written out, one entry at a time in f32
        g, gl = f32(0.8), f32(0.8 * 0.75)
        gae = nv = f32(0)
        want = np.zeros(N, f32)
        rn, vn, mn = r[b].numpy(), v[b].numpy(), m[b].numpy()
        for i in range(N - 1, -1, -1):
            if mn[i]:
                gae = rn[i] + g * nv - vn[i] + gl * gae
                nv, want[i] = vn[i], gae
        assert np.array_equal(one.numpy(), want)


# ---- Part B: the batch runners against JAX's digest ----------------------------

@functools.cache
def _digest() -> dict:
    with open(os.path.join(DATA, "rl_batch_digest.json")) as f:
        return json.load(f)


@functools.cache
def _trained() -> dict:
    """The digest's trained floats, whole: `kind|name|phase|world|leaf`
    -> array."""
    with np.load(os.path.join(DATA, "rl_batch_trained.npz")) as z:
        return {k: z[k] for k in z.files}


@functools.cache
def _spread(algo: str) -> dict:
    """Per trained leaf of the per-world case, JAX's own spread: the
    largest difference between JAX's batched run of a world and its
    single-world run of it, over the case's worlds and both runs (a
    world alone can show ~0 where the two compiles happen to sum in the
    same order).  The port is held within twice it: were the port no
    farther from JAX's single run than JAX's batch is, it would lie at
    most that far from JAX's batch."""
    dig, z, out = _digest(), _trained(), {}
    for n, phase in ((dig["ticks"], f"tick{dig['ticks']}"),
                     (dig["run_batch_ticks"],
                      f"run_batch{dig['run_batch_ticks']}")):
        pre = f"per_world|{algo}|{phase}|"
        for key, r in z.items():
            if key.startswith(pre):
                b, leaf = key[len(pre):].split("|", 1)
                s = z[f"per_world|{algo}|single{n}|{b}|{leaf}"]
                out[leaf] = max(out.get(leaf, 0.0), float(np.abs(
                    s.astype(np.float64) - r).max(initial=0.0)))
    return out


def _cfg(rec: dict) -> Config:
    return Config(**rec["cfg"])


def _check(name: str, ref: dict, leaves: dict, whole: str = "",
           spread: dict | None = None):
    """Every leaf of one world against the digest's entry: sha256, or,
    where `whole` names the world's trained floats in the digest's npz
    (`kind|name|phase|world`), the NEAR leaves element by element within
    RTOL and ATOL times the leaf's largest magnitude, plus twice JAX's
    own spread of the leaf where `spread` has it (`_spread`)."""
    leaves = {k: v for k, v in leaves.items() if k != "cost_field"}
    assert set(ref) == set(leaves), sorted(set(ref) ^ set(leaves))
    bad = []
    for k, d in ref.items():
        a = np.asarray(leaves[k])
        if str(a.dtype) != d["dtype"] or list(a.shape) != d["shape"]:
            bad.append((k, "dtype/shape"))
            continue
        if whole and k.startswith(NEAR):
            try:
                _assert_close(a, _trained()[f"{whole}|{k}"], k,
                              (spread or {}).get(k, 0.0))
            except AssertionError as e:
                bad.append((k, str(e)[-300:]))
        elif hashlib.sha256(a.tobytes()).hexdigest() != d["sha256"]:
            bad.append((k, "sha256"))
    assert not bad, f"{name}: {bad}"


SHARED = ["NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED",
          "RL_A2C_BATCHED+interleaved", "GAT_DQN_BATCHED"]


@pytest.mark.parametrize("case", SHARED)
def test_shared_batch_matches_jax_digest(case):
    dig = _digest()
    rec = dig["shared"][case]
    cfg, n, B = _cfg(rec), dig["ticks"], dig["shared_b"]
    world = synth.crossroad_world(cfg, device="cpu")
    batch = mesh.tile_dynamic(world, prng.split(prng.PRNGKey(0), B))
    _check("init", rec["init"][0],
           transfer.world_to_numpy(mesh.world_at(batch, 0)))
    with ties.spying(B) as spy:
        end = mesh.run_batch_shared(cfg, batch, n)
    assert len(spy.gaps) == n
    assert spy.ties(cfg, sim._chain(cfg, batch, n)[1]).sum() == 0
    counts = end.rl.opt_state.count.tolist()
    assert counts == rec["counts"] and min(counts) >= 3
    for b in range(B):
        _check(f"world {b} after {n} ticks", rec[f"tick{n}"][b],
               transfer.world_to_numpy(mesh.world_at(end, b)),
               f"shared|{case}|tick{n}|{b}")


@functools.cache
def _cities(algo: str):
    rec = _digest()["per_world"][algo]
    return mesh.init_world_batch(_cfg(rec), prng.PRNGKey(0),
                                 _digest()["per_world_b"], device="cpu")


@pytest.mark.parametrize("algo", FAMILIES)
def test_per_world_batch_matches_jax_digest(algo):
    """`init_world_batch` (each world's train state from its own key),
    then `run_chunk_batch` and `run_batch` from it."""
    dig = _digest()
    rec = dig["per_world"][algo]
    cfg, n, B = _cfg(rec), dig["ticks"], dig["per_world_b"]
    worlds = _cities(algo)
    for b in range(B):
        _check(f"world {b} at init", rec["init"][b],
               transfer.world_to_numpy(mesh.world_at(worlds, b)))
    _, plan, _ = sim._chain(cfg, worlds, n)
    train = plan.tensors["train"].numpy()
    assert train.sum(axis=1).min() >= 3
    mixed = int((plan.train_any & ~plan.train_all).sum())
    # A2C's rollout cursor moves alike in every world
    assert (mixed > 0) == (algo != "RL_A2C_BATCHED"), train
    with ties.spying(B) as spy:
        end = mesh.run_chunk_batch(cfg, worlds, n)
    with ties.spying(B) as spy_rb:
        rb = mesh.run_batch(cfg, worlds, dig["run_batch_ticks"])
    assert len(spy.gaps) == n and len(spy_rb.gaps) == dig["run_batch_ticks"]
    assert spy.ties(cfg, plan).sum() == 0
    assert spy_rb.ties(cfg, plan).sum() == 0
    assert end.rl.opt_state.count.tolist() == rec["counts"]
    assert rb.rl.opt_state.count.tolist() == rec["run_batch_counts"]
    for b in range(B):
        _check(f"world {b} after {n} ticks", rec[f"tick{n}"][b],
               transfer.world_to_numpy(mesh.world_at(end, b)),
               f"per_world|{algo}|tick{n}|{b}", _spread(algo))
        nb = dig["run_batch_ticks"]
        _check(f"world {b} after run_batch", rec[f"run_batch{nb}"][b],
               transfer.world_to_numpy(mesh.world_at(rb, b)),
               f"per_world|{algo}|run_batch{nb}|{b}", _spread(algo))


def test_rl_batch_of_one_world_is_the_single_world_run():
    """A shared batch of one world is `sim.run_chunk` of that world, bit
    for bit (B = 1 of the same code)."""
    rec = _digest()["shared"]["GAT_DQN_BATCHED"]
    cfg = _cfg(rec)
    world = synth.crossroad_world(cfg, device="cpu")
    one = sim.run_chunk(cfg, world, 8)
    batch = mesh.run_batch_shared(
        cfg, mesh.tile_dynamic(world, sim._key_np(world.key)[None]), 8)
    a = transfer.world_to_numpy(one)
    b = transfer.world_to_numpy(mesh.world_at(batch, 0))
    for k, v in a.items():
        if k.startswith(NEAR):
            _assert_close(b[k], v, k)
        else:
            assert np.array_equal(v, b[k]), k


def test_init_world_batch_with_rl_still_refuses_a_mesh():
    """Under an RL config too, anything but a `parallel.mesh.Mesh` as
    `mesh` is refused (the sharded RL batch, from a `Mesh`:
    tests/test_torch_dist.py)."""
    cfg = Config(**_digest()["per_world"]["NEIGHBOR_RL_BATCHED"]["cfg"])
    with pytest.raises(TypeError, match="Mesh"):
        mesh.init_world_batch(cfg, prng.PRNGKey(0), 2, mesh=object(),
                              device="cpu")
