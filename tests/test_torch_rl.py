"""The port's RL light controllers (`rl/`) against the JAX package's.

* Features (the five REINFORCE widths, A2C's and GAT's star graph), bit
  for bit against the jitted JAX functions, on JAX's crossroad and on a
  seeded random group layout (37 groups, random neighbours, f32 sizes
  and penalties, random occupancy and stuck counts).
* The four nets at the Config's default widths on flax parameters
  carried across: within rtol 1e-5 of the jitted flax `apply` (f32
  matmuls of another summation order).
* `_phase_mechanics`, `_ring_write`, both GAE forms, `prng.gumbel` /
  `categorical` and `randint` with a traced maxval against `jax.random`,
  and the RL key of the tick's key chain.
* Each controller's step at default widths for one inference tick
  against the jitted JAX step from the same train state: integer leaves,
  features, rewards and the light state bit for bit, the value outputs
  within rtol 1e-5; actions equal (the near ties between the two
  perturbed logits, closer than 1e-4, are counted: none on these seeds).
  Then one forced training update each from a random buffer and a
  random Adam state: parameters and moments within the tolerances
  stated at `_assert_trained_like`.
* The learning oracles of tests/test_agents.py on the port alone: the
  parameters move and Adam counts its updates; GAT-DQN stores real
  (s, a, r, s') transitions and its TD loss falls.
* `transfer` both ways, the crossroad run of each family held to JAX's
  digest (`data/rl_digest.json`, `tools/make_torch_rl_digest.py`) at
  init and after 23 ticks, and the world batches' refusal of RL.

No JAX compile of the simulation: the JAX steps are the controllers'
alone, and the crossroad is built eagerly.
"""

import functools
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trafficsimulation_tpu.config import Config as JConfig
from trafficsimulation_tpu.core import synth as jsynth
from trafficsimulation_tpu.lights import fsm as jfsm
from trafficsimulation_tpu.rl import controllers as jctl
from trafficsimulation_tpu.rl import features as jfeat
from trafficsimulation_tpu.rl import nets as jnets

from trafficsimulation_tpu_torch import prng, sim
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth, transfer
from trafficsimulation_tpu_torch.lights import fsm as tfsm
from trafficsimulation_tpu_torch.ops import engine
from trafficsimulation_tpu_torch.parallel import mesh
from trafficsimulation_tpu_torch.rl import controllers as tctl
from trafficsimulation_tpu_torch.rl import features as tfeat
from trafficsimulation_tpu_torch.rl import nets as tnets

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from make_torch_snapshot import world_to_leaves  # noqa: E402

torch.set_num_threads(2)
NS = types.SimpleNamespace
DATA = os.path.join(os.path.dirname(__file__), "..",
                    "trafficsimulation_tpu_torch", "data")
CROSS = dict(WIDTH=32, HEIGHT=32, MAX_FIELD_DESTS=8, MAX_VEHICLES=64,
             VEHICLE_MAX_SPEED=2)
FAMILIES = ("NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED", "GAT_DQN_BATCHED")
NET_RTOL = 1e-5
TIE = 1e-4          # perturbed logits closer than this count as a tie


def T(x):
    return torch.from_numpy(np.array(np.asarray(x)))


# ---- cases -------------------------------------------------------------------

@functools.cache
def _jax_cross():
    return jsynth.crossroad_world(JConfig(**CROSS),
                                  key=jax.random.PRNGKey(0))


def _case(name: str, seed: int = 0) -> dict:
    """Numpy inputs of the controllers: lane labels, group tables, light
    registers, occupancy and stuck counts."""
    rng = np.random.default_rng(seed)
    if name == "crossroad":
        w = _jax_cross()
        qg = np.asarray(w.grid.queue_group)
        qb = np.asarray(w.grid.queue_bucket)
        road = np.asarray(w.grid.is_road)
        gs = w.groups_static
        valid, nb = np.asarray(gs.valid), np.asarray(gs.neighbor)
        isz = np.asarray(gs.intersection_size)
        pen = np.asarray(gs.penalty_score)
    else:
        G, H, W = 37, 24, 40
        qg = rng.integers(-1, G, (H, W)).astype(np.int32)
        qb = rng.integers(0, 5, (H, W)).astype(np.int8)
        road = np.ones((H, W), bool)
        valid = rng.random(G) < 0.8
        nb = np.where(rng.random((G, 4)) < 0.7,
                      rng.integers(0, G, (G, 4)), -1).astype(np.int32)
        isz = (rng.random(G) * 10).astype(np.float32)
        pen = (rng.random(G) * 3).astype(np.float32)
    G = valid.shape[0]
    occ = road & (rng.random(road.shape) < 0.4)
    return dict(
        qg=qg, qb=qb, valid=valid, nb=nb, isz=isz, pen=pen, occ=occ,
        stuck=np.where(occ, rng.integers(0, 4096, occ.shape), 0).astype(
            np.int32),
        ft=rng.integers(0, 2, G).astype(np.int32),
        timer=rng.integers(0, 70, G).astype(np.int32),
        pend=np.where(rng.random(G) < 0.8, -1,
                      rng.integers(0, 2, G)).astype(np.int32))


ARGS = ("qg", "qb", "valid", "nb", "isz", "pen", "occ", "stuck")


def _pieces(c: dict, conv):
    """(grid, gs, occupancy, stuck) namespaces of the case's arrays."""
    a = [conv(c[k]) for k in ARGS]
    return (NS(queue_group=a[0], queue_bucket=a[1]),
            NS(valid=a[2], neighbor=a[3], intersection_size=a[4],
               penalty_score=a[5]), a[6], a[7])


def _lights(c: dict, fsm, conv):
    G = c["valid"].shape[0]
    cfg = JConfig() if fsm is jfsm else Config()
    return fsm.init_lights_state(cfg, G, 8, conv(c["valid"])).replace(
        ft_phase=conv(c["ft"]), rl_timer=conv(c["timer"]),
        pending_phase=conv(c["pend"]))


def _cfgs(algo: str, **kw):
    return (JConfig(TRAFFIC_LIGHT_AGENT_ALGORITHM=algo, **kw),
            Config(TRAFFIC_LIGHT_AGENT_ALGORITHM=algo, **kw))


# ---- features ------------------------------------------------------------------

FEATURES = [("srl", 7), ("srl", 11), ("srl", 13), ("srl", 17), ("srl", 19),
            ("a2c", 13), ("gat", 9)]


@pytest.mark.parametrize("case", ["crossroad", "random"])
@pytest.mark.parametrize("kind,dim", FEATURES,
                         ids=[f"{k}{d}" for k, d in FEATURES])
def test_features_match_jitted_jax(kind, dim, case):
    c = _case(case, seed=dim)
    jcfg, tcfg = _cfgs("NEIGHBOR_RL_BATCHED", SRL_INPUT_DIMENSIONS=dim)

    def jfn(ft, timer, *arrs):
        grid, gs, occ, stuck = _pieces(dict(zip(ARGS, arrs)), lambda x: x)
        lights = NS(ft_phase=ft, rl_timer=timer)
        if kind == "srl":
            return (jfeat.srl_state(jcfg, grid, gs, lights, occ, stuck),)
        if kind == "a2c":
            return (jfeat.a2c_state(jcfg, grid, gs, lights, occ),)
        return jfeat.gat_state(jcfg, grid, gs, lights, occ)

    ref = jax.jit(jfn)(c["ft"], c["timer"], *[c[k] for k in ARGS])
    grid, gs, occ, stuck = _pieces(c, T)
    lights = NS(ft_phase=T(c["ft"]), rl_timer=T(c["timer"]))
    got = {"srl": lambda: (tfeat.srl_state(tcfg, grid, gs, lights, occ,
                                           stuck),),
           "a2c": lambda: (tfeat.a2c_state(tcfg, grid, gs, lights, occ),),
           "gat": lambda: tfeat.gat_state(tcfg, grid, gs, lights, occ)}[
        kind]()
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.dtype == g.numpy().dtype and r.shape == tuple(g.shape)
        assert np.array_equal(r, g.numpy()), \
            f"{int((r != g.numpy()).sum())} of {r.size} entries differ"
    if case == "random":      # the neighbour means see real divisions
        assert len(np.unique(np.asarray(ref[0])[:, -1])) > 5


# ---- nets ------------------------------------------------------------------------

def _flax_params(variables) -> dict:
    return {k[len("params."):]: v
            for k, v in world_to_leaves(variables).items()}


NETS = [("policy", (13, 128, 10)), ("actor_critic", (13, 256, 10)),
        ("gat", ())]


@pytest.mark.parametrize("kind,args", NETS, ids=[k for k, _ in NETS])
def test_nets_on_flax_params(kind, args):
    rng = np.random.default_rng(5)
    B = 64
    if kind == "gat":
        fnet = jnets.GATQNet()
        x = (rng.normal(size=(B, 5, 9)).astype(np.float32) * 3,
             (rng.random((B, 5)) < 0.7).astype(np.float32))
        x[1][:, 0] = 1.0
    else:
        fnet = (jnets.PolicyMLP(args[1], args[2]) if kind == "policy"
                else jnets.ActorCritic(args[1], args[2]))
        x = (rng.normal(size=(B, args[0])).astype(np.float32) * 3,)
    variables = fnet.init(jax.random.PRNGKey(7), *[jnp.asarray(a[:1])
                                                    for a in x])
    ref = jax.jit(fnet.apply)(variables, *x)
    ref = ref if isinstance(ref, tuple) else (ref,)
    params = {k: T(v) for k, v in _flax_params(variables).items()}
    net = tnets.build(kind, *(args if kind != "gat" else ()))
    assert sorted(params) == sorted(n for n, _ in net.named_parameters())
    got = tnets.apply(net, params, *[T(a) for a in x])
    got = got if isinstance(got, tuple) else (got,)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert r.shape == tuple(g.shape)
        np.testing.assert_allclose(g.numpy(), r, rtol=NET_RTOL,
                                   atol=NET_RTOL * np.abs(r).max())


def test_init_params_follow_flax_initializers():
    net = tnets.build("policy", 13, 128, 10)
    p = tnets.init_params(net, prng.PRNGKey(0), "cpu")
    q = tnets.init_params(net, prng.PRNGKey(0), "cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    k0 = p["Dense_0.kernel"]
    # LeCun normal: variance 1 / fan_in, cut at 2 of the untruncated
    # normal's standard deviations
    std = np.sqrt(1 / 13)
    assert k0.abs().max() <= 2 * std / 0.87962566103423978
    assert abs(k0.std() - std) < 0.1 * std
    assert not torch.equal(p["Dense_1.kernel"], tnets.init_params(
        net, prng.PRNGKey(1), "cpu")["Dense_1.kernel"])
    assert torch.equal(p["LayerNorm_0.scale"], torch.ones(128))
    assert not p["Dense_3.bias"].any()


# ---- mechanics, buffers, GAE, draws --------------------------------------------

def test_phase_mechanics_and_ring_write():
    c = _case("random", 3)
    rng = np.random.default_rng(4)
    G = c["valid"].shape[0]
    active = rng.random(G) < 0.7
    action = rng.integers(0, 2, G).astype(np.int32)
    cfg = JConfig()
    jl, jw, jp = jax.jit(lambda lt, a, b: jctl._phase_mechanics(
        cfg, lt, a, b, 5))(_lights(c, jfsm, jnp.asarray), active, action)
    tl, tw, tp = tctl._phase_mechanics(Config(), _lights(c, tfsm, T),
                                       T(active), T(action), 5)
    for a, b in ((jl.rl_timer, tl.rl_timer), (jl.ft_phase, tl.ft_phase),
                 (jw, tw), (jp, tp)):
        assert np.asarray(a).dtype == b.numpy().dtype
        assert np.array_equal(np.asarray(a), b.numpy())
    buf = rng.normal(size=(11, 3)).astype(np.float32)
    vals = rng.normal(size=(7, 3)).astype(np.float32)
    for cur in (0, 6, 10):
        ref = jax.jit(lambda b, c_, v: jctl._ring_write(b, c_, v, 7))(
            buf, np.int32(cur), vals)
        got = tctl._ring_write(T(buf), torch.tensor(cur, dtype=torch.int32),
                               T(vals), 7)
        assert np.array_equal(np.asarray(ref), got.numpy())


def test_group_gae_matches_jax_scan():
    rng = np.random.default_rng(1)
    R, G = 32, 37
    r = rng.normal(size=(R, G)).astype(np.float32) * 5
    v = rng.normal(size=(R, G)).astype(np.float32) * 5
    gamma, lam = JConfig().A2C_GAMMA, JConfig().A2C_LAMBDA

    def scan(r, v):
        def body(carry, x):
            gae, next_v = carry
            r_, v_ = x
            delta = r_ + gamma * next_v - v_
            gae = delta + gamma * lam * gae
            return (gae, v_), gae
        return jax.lax.scan(body, (jnp.zeros((G,)), jnp.zeros((G,))),
                            (r, v), reverse=True)[1]

    ref = np.asarray(jax.jit(scan)(r, v))
    got = tctl.group_gae(gamma, lam, T(r), T(v)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_interleaved_gae_matches_jax_and_reference_transcription():
    rng = np.random.default_rng(0)
    R, G = 6, 5
    gamma, lam = 0.8, 0.75
    r = rng.normal(size=(R, G)).astype(np.float32)
    v = rng.normal(size=(R, G)).astype(np.float32)
    m = rng.random((R, G)) < 0.8
    m[:, 0] = True
    # tests/test_rl.py's transcription of the reference's `compute_gae`
    rs, vs, pos = [], [], []
    for t in range(R):
        for g in range(G):
            if m[t, g]:
                rs.append(r[t, g])
                vs.append(v[t, g])
                pos.append((t, g))
    want = np.zeros((R, G), np.float32)
    gae, next_v = 0.0, 0.0
    for i in reversed(range(len(rs))):
        gae = rs[i] + gamma * next_v - vs[i] + gamma * lam * gae
        want[pos[i]] = gae
        next_v = vs[i]
    ref = np.asarray(jax.jit(functools.partial(
        jctl.interleaved_gae, gamma, lam))(r.reshape(-1), v.reshape(-1),
                                           m.reshape(-1))).reshape(R, G)
    got = tctl.interleaved_gae(gamma, lam, T(r.reshape(-1)),
                               T(v.reshape(-1)), T(m.reshape(-1)))
    got = got.numpy().reshape(R, G)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rl_draws_match_jax_random():
    """`prng.gumbel` within 1e-6 relative of JAX's (numpy's f32 log is
    not XLA's), `categorical` equal but at near ties (counted: none),
    `uniform` and `randint` with a traced maxval bit for bit."""
    ties = 0
    for s in range(6):
        key = jax.random.PRNGKey(s)
        k = np.asarray(key)
        ref = np.asarray(jax.random.gumbel(key, (300, 2)))
        got = prng.gumbel(k, (300, 2))
        assert got.dtype == np.float32
        assert (np.abs(got - ref) <= 1e-6 * np.maximum(1, np.abs(ref))).all()
        logits = np.random.default_rng(s).normal(size=(300, 2)).astype(
            np.float32)
        jc = np.asarray(jax.random.categorical(key, logits, axis=-1))
        tc = prng.categorical(k, logits)
        margin = np.abs(np.diff(logits + ref, axis=-1))[:, 0]
        ties += int((margin < TIE).sum())
        assert np.array_equal(jc[margin >= TIE], tc[margin >= TIE])
        assert np.array_equal(np.asarray(jax.random.uniform(key, (300,))),
                              prng.uniform(k, (300,)))
        rint = jax.jit(lambda kk, m: jax.random.randint(
            kk, (64,), 0, jnp.maximum(m, 1)))
        fills = np.array([0, 1, 7, 255, 9999, 65537, 2 ** 31 - 1])
        keys = prng.split(k, len(fills))
        stack = prng.randint(keys, 0, np.maximum(fills, 1), (64,))
        for i, filled in enumerate(fills):
            ref = np.asarray(rint(keys[i], np.int32(filled)))
            assert np.array_equal(ref, prng.randint(keys[i], 0,
                                                    max(filled, 1), (64,)))
            assert np.array_equal(ref, stack[i])
    assert ties == 0


@pytest.mark.parametrize("peds", [False, True])
def test_tick_chain_rl_key_matches_jax(peds):
    cfg = Config(TRAFFIC_LIGHT_AGENT_ALGORITHM="RL_A2C_BATCHED",
                 PEDESTRIANS_ENABLED=peds)
    key = jax.random.PRNGKey(9)
    draws, rl_keys, last = engine.tick_chain(cfg, np.asarray(key), 4)
    for t in range(4):
        ks = jax.random.split(key, 6)
        key, k_mal = ks[0], ks[1]
        key, k_rl = jax.random.split(key)
        assert np.array_equal(rl_keys[t], np.asarray(k_rl))
        assert np.array_equal(draws[t, :4], np.asarray(jax.random.bits(
            k_mal, (4,), jnp.uint32)).astype(np.int64))
        if peds:
            key, _ = jax.random.split(key)
        key, _ = jax.random.split(key)
    assert np.array_equal(last, np.asarray(key))
    off, none, last_off = engine.tick_chain(
        cfg.replace(TRAFFIC_LIGHT_AGENT_ALGORITHM="QUEUE_ACTUATED"),
        np.asarray(jax.random.PRNGKey(9)), 4)
    assert none is None and not np.array_equal(last_off, last)


# ---- the controller steps ---------------------------------------------------------

def _to_port(jts):
    return transfer.world_from_numpy(
        {"rl." + k: v for k, v in world_to_leaves(jts).items()}, "cpu").rl


def _port_leaves(ts) -> dict:
    w = transfer.world_from_numpy({}, "cpu").replace(rl=ts)
    return {k[3:]: v for k, v in transfer.world_to_numpy(w).items()}


@functools.cache
def _jax_step(algo: str):
    jcfg, _ = _cfgs(algo)

    def step(ts, lights, tp, key, *arrs):
        grid, gs, occ, stuck = _pieces(dict(zip(ARGS, arrs)), lambda x: x)
        return jctl.rl_controller_step(jcfg, ts, grid, gs, lights, occ,
                                       stuck, tp, key)
    return jax.jit(step)


def _run_both(algo: str, c: dict, jts, key, tp=0.75):
    """One step of JAX's controller and of the port's from the same
    state: (JAX's outputs, the port's, the port's plan tick)."""
    _, tcfg = _cfgs(algo)
    ts = _to_port(jts)
    ref = _jax_step(algo)(jts, _lights(c, jfsm, jnp.asarray),
                          jnp.float32(tp), key, *[c[k] for k in ARGS])
    grid, gs, occ, stuck = _pieces(c, T)
    plan = tctl.plan_ticks(tcfg, ts, gs.valid, np.asarray(key)[None])
    got = tctl.rl_controller_step(tcfg, ts, grid, gs, _lights(c, tfsm, T),
                                  occ, stuck, torch.tensor(np.float32(tp)),
                                  plan[0])
    return ref, got, plan[0]


NEAR = {"roll_v"}       # value head outputs (the nets' tolerance)


def _assert_step_like(ref, got, near=NEAR, skip=()):
    rl, tl = world_to_leaves(ref[0]), _port_leaves(got[0])
    assert set(rl) == set(tl), sorted(set(rl) ^ set(tl))
    for k, a in rl.items():
        b = tl[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in skip:
            continue
        if k in near:
            np.testing.assert_allclose(b, a, rtol=NET_RTOL,
                                       atol=NET_RTOL * np.abs(a).max(),
                                       err_msg=k)
        else:
            assert np.array_equal(a, b), \
                f"{k}: {int((a != b).sum())} of {a.size} differ"
    for f in ("rl_timer", "ft_phase", "pending_phase"):
        assert np.array_equal(np.asarray(getattr(ref[1], f)),
                              getattr(got[1], f).numpy()), f
    for a, b in zip(ref[2:], got[2:]):
        assert np.array_equal(np.asarray(a), b.numpy())


def _margin(algo, jts, c, tick):
    """Per group, how far the JAX step's action was from a tie."""
    jcfg, _ = _cfgs(algo)
    net = {"NEIGHBOR_RL_BATCHED": jnets.PolicyMLP(), "RL_A2C_BATCHED":
           jnets.ActorCritic(), "GAT_DQN_BATCHED": jnets.GATQNet()}[algo]
    grid, gs, occ, stuck = _pieces(c, jnp.asarray)
    lights = _lights(c, jfsm, jnp.asarray)
    if algo == "GAT_DQN_BATCHED":
        f, m = jfeat.gat_state(jcfg, grid, gs, lights, occ)
        return np.abs(np.diff(np.asarray(net.apply(jts.params, f, m)),
                              axis=1))[:, 0]
    s = (jfeat.srl_state(jcfg, grid, gs, lights, occ, stuck)
         if algo == "NEIGHBOR_RL_BATCHED"
         else jfeat.a2c_state(jcfg, grid, gs, lights, occ))
    lg = net.apply(jts.params, s)
    lg = np.asarray(lg[0] if isinstance(lg, tuple) else lg)
    return np.abs(np.diff(lg + tick.gumbel.numpy(), axis=1))[:, 0]


@pytest.mark.parametrize("algo", FAMILIES)
def test_step_inference_matches_jitted_jax(algo):
    c = _case("random", 21)
    jcfg, _ = _cfgs(algo)
    G = c["valid"].shape[0]
    jts = jctl.init_rl_state(jcfg, G, jax.random.PRNGKey(2))
    if algo == "GAT_DQN_BATCHED":
        # a pending transition to complete, and epsilon low enough that
        # some groups act greedily
        rng = np.random.default_rng(8)
        jts = jts.replace(
            pend_valid=jnp.asarray(rng.random(G) < 0.7),
            pend_s=jnp.asarray(rng.normal(size=(G, 5, 9)), jnp.float32),
            pend_m=jnp.asarray(rng.random((G, 5)) < 0.6, jnp.float32),
            pend_a=jnp.asarray(rng.integers(0, 2, G), jnp.int32),
            epsilon=jnp.full((G,), 0.5, jnp.float32),
            cursor=jnp.int32(9990))
    key = jax.random.PRNGKey(31)
    ref, got, tick = _run_both(algo, c, jts, key)
    assert not tick.train
    near_ties = int((_margin(algo, jts, c, tick) < TIE).sum())
    assert near_ties == 0
    _assert_step_like(ref, got)
    if algo == "GAT_DQN_BATCHED":
        assert int(ref[0].filled) > 0 and int(ref[0].cursor) < 9990


def _adam_state(params, rng, count=5):
    def mom(x, lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, np.shape(x)), jnp.float32)
    return (optax.ScaleByAdamState(
        count=jnp.int32(count),
        mu=jax.tree_util.tree_map(lambda x: mom(x, -1e-3, 1e-3), params),
        nu=jax.tree_util.tree_map(lambda x: mom(x, 1e-5, 1e-4), params)),
        optax.EmptyState())


def _assert_trained_like(ref, got):
    """After one update from the same state and batch: parameters within
    1e-6 absolute (the update is lr x a bounded ratio; the gradients
    agree to ~1e-5 relative), first moments within 1e-4 relative (1e-6 of
    their scale absolute) and second moments within 1e-4 relative of
    JAX's; Adam's count and every integer leaf exact."""
    rl, tl = world_to_leaves(ref[0]), _port_leaves(got[0])
    for k, a in rl.items():
        b = tl[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k.startswith(("params.", "target_params.")):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=k)
        elif k.startswith("opt_state.0.mu"):
            np.testing.assert_allclose(b, a, rtol=1e-4,
                                       atol=1e-6 * np.abs(a).max(),
                                       err_msg=k)
        elif k.startswith("opt_state.0.nu"):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=0, err_msg=k)
        elif k in NEAR:
            np.testing.assert_allclose(b, a, rtol=NET_RTOL,
                                       atol=NET_RTOL * np.abs(a).max(),
                                       err_msg=k)
        else:
            assert np.array_equal(a, b), k


@pytest.mark.parametrize("algo", FAMILIES)
def test_forced_training_update_matches_jitted_jax(algo):
    c = _case("random", 22)
    jcfg, _ = _cfgs(algo)
    G = c["valid"].shape[0]
    rng = np.random.default_rng(9)
    jts = jctl.init_rl_state(jcfg, G, jax.random.PRNGKey(3))
    p0 = world_to_leaves(jts)
    jts = jts.replace(opt_state=_adam_state(jts.params, rng))

    def rnd(x, scale=1.0):
        return jnp.asarray(rng.normal(size=np.shape(x)) * scale, jnp.float32)
    if algo == "NEIGHBOR_RL_BATCHED":
        cap = jts.buf_s.shape[0]
        jts = jts.replace(
            buf_s=rnd(jts.buf_s, 3), buf_r=rnd(jts.buf_r, 4),
            buf_a=jnp.asarray(rng.integers(0, 2, cap), jnp.int32),
            filled=jnp.int32(150), cursor=jnp.int32(150),
            since_train=jnp.int32(jcfg.SRL_UPDATE_EVERY - 1))
    elif algo == "RL_A2C_BATCHED":
        R = jts.roll_s.shape[0]
        jts = jts.replace(
            roll_s=rnd(jts.roll_s, 3), roll_r=rnd(jts.roll_r, 4),
            roll_v=rnd(jts.roll_v, 2),
            roll_a=jnp.asarray(rng.integers(0, 2, (R, G)), jnp.int32),
            roll_m=jnp.asarray(rng.random((R, G)) < 0.8),
            t=jnp.int32(R - 1), global_step=jnp.int32(3))
    else:
        cap = jts.buf_s.shape[0]
        jts = jts.replace(
            buf_s=rnd(jts.buf_s, 3), buf_ns=rnd(jts.buf_ns, 3),
            buf_m=jnp.asarray(rng.random((cap, 5)) < 0.7, jnp.float32),
            buf_nm=jnp.asarray(rng.random((cap, 5)) < 0.7, jnp.float32),
            buf_r=rnd(jts.buf_r, 4),
            buf_a=jnp.asarray(rng.integers(0, 2, cap), jnp.int32),
            filled=jnp.int32(300), cursor=jnp.int32(300),
            train_steps=jnp.int32(jcfg.GAT_TARGET_UPDATE_EVERY - 1),
            epsilon=jnp.full((G,), 0.3, jnp.float32))
    ref, got, tick = _run_both(algo, c, jts, jax.random.PRNGKey(41))
    assert tick.train and int(ref[0].opt_state[0].count) == 6
    assert tick.count == 6 and tick.sync == (algo == "GAT_DQN_BATCHED")
    _assert_trained_like(ref, got)
    after = world_to_leaves(ref[0])
    assert any(not np.array_equal(after[k], p0[k]) for k in p0
               if k.startswith("params."))


# ---- learning on the port alone (tests/test_agents.py's oracles) -----------------

@functools.cache
def _port_cross(cfg: Config):
    return synth.crossroad_world(cfg, device="cpu")


def _drive(algo: str, n: int = 40, **kw):
    """n ticks of the controller alone on the crossroad, random
    occupancy a tick, its phase requests committed (the port form of
    tests/test_agents.py's `_drive_controller`)."""
    cfg = Config(**CROSS, TRAFFIC_LIGHT_AGENT_ALGORITHM=algo, **kw)
    w = _port_cross(cfg)
    gs = w.groups_static
    G, L = gs.valid.shape[0], w.lights_static.valid.shape[0]
    ts0 = tctl.init_rl_state(cfg, G, prng.PRNGKey(3), "cpu")
    lights = tfsm.init_lights_state(cfg, G, L, gs.valid)
    keys = prng.split(prng.PRNGKey(4), n)
    rng = np.random.default_rng(4)
    ts = ts0
    for t in range(n):
        occ = w.grid.is_road & T(rng.random(w.grid.is_road.shape) < 0.4)
        tick = tctl.plan_ticks(cfg, ts, gs.valid, keys[t][None])[0]
        ts, lights, want, phase = tctl.rl_controller_step(
            cfg, ts, w.grid, gs, lights, occ,
            torch.zeros(occ.shape, dtype=torch.int32),
            torch.tensor(0.0), tick)
        lights = tfsm.run_controllers(cfg, w.grid, gs, lights, occ,
                                      rl_phase_request=(want, phase))
        lights = tfsm.execute_phase_change(
            cfg, w.lights_static, gs, lights,
            torch.zeros((G,), dtype=torch.bool))
    return w, ts0, ts, lights


@pytest.mark.parametrize("algo,kw", [
    ("NEIGHBOR_RL_BATCHED", dict(SRL_UPDATE_EVERY=16, SRL_BATCH_SIZE=16)),
    ("NEIGHBOR_RL", dict(SRL_UPDATE_EVERY=16, SRL_BATCH_SIZE=16)),
    ("RL_A2C_BATCHED", dict(A2C_UPDATE_EVERY=8)),
    ("GAT_DQN_BATCHED", dict(GAT_BATCH_SIZE=8)),
    ("GAT_DQN", dict(GAT_BATCH_SIZE=8))])
def test_port_controllers_train(algo, kw):
    w, ts0, ts, lights = _drive(algo, **kw)
    gv = w.groups_static.valid
    assert (lights.current_phase[gv] >= 0).all()
    k = "Dense_0.kernel"
    assert not torch.allclose(ts0.params[k], ts.params[k]), algo
    assert int(ts.opt_state.count) > 0
    assert all(torch.isfinite(v).all() for v in ts.params.values())


def test_port_gat_stores_transitions_and_learns():
    cfg = Config(**CROSS, TRAFFIC_LIGHT_AGENT_ALGORITHM="GAT_DQN_BATCHED",
                 GAT_BATCH_SIZE=4, GAT_TARGET_UPDATE_EVERY=1000)
    w = _port_cross(cfg)
    gs = w.groups_static
    G, L = gs.valid.shape[0], w.lights_static.valid.shape[0]
    ts = tctl.init_rl_state(cfg, G, prng.PRNGKey(3), "cpu")
    lights = tfsm.init_lights_state(cfg, G, L, gs.valid)
    empty = torch.zeros(w.grid.is_road.shape, dtype=torch.bool)
    queue = (w.grid.queue_group == 0) & (w.grid.queue_bucket == 0) \
        & w.grid.is_road
    zero = torch.zeros(empty.shape, dtype=torch.int32)
    key = prng.PRNGKey(5)

    def step(ts, lights, occ, k):
        tick = tctl.plan_ticks(cfg, ts, gs.valid, k[None])[0]
        return tctl.gat_step(cfg, ts, w.grid, gs, lights, occ,
                             torch.tensor(0.0), tick)

    ts1, lights, _, _ = step(ts, lights, empty, key)
    assert int(ts1.filled) == 0 and bool(ts1.pend_valid[gs.valid].all())
    ts2, lights, _, _ = step(ts1, lights, queue, key)
    assert int(ts2.filled) == int(gs.valid.sum())
    s0, ns0 = ts2.buf_s[0, 0, :2], ts2.buf_ns[0, 0, :2]
    assert not torch.allclose(s0, ns0) and ns0.sum() > s0.sum()
    net = tctl.net_of(cfg)

    def td_loss(ts, n):
        qp = tnets.apply(net, ts.params, ts.buf_s[:n], ts.buf_m[:n])
        qsa = torch.gather(qp, 1, ts.buf_a[:n, None].long())[:, 0]
        qn = tnets.apply(net, ts.target_params, ts.buf_ns[:n], ts.buf_nm[:n])
        tgt = ts.buf_r[:n] + cfg.GAT_GAMMA * qn.amax(1)
        return float(torch.mean((qsa - tgt) ** 2))

    for _ in range(6):
        key, kk = prng.split(key, 2)
        ts2, lights, _, _ = step(ts2, lights, queue, kk)
    n = int(ts2.filled)
    before, steps0 = td_loss(ts2, n), int(ts2.train_steps)
    for _ in range(10):
        key, kk = prng.split(key, 2)
        ts2, lights, _, _ = step(ts2, lights, queue, kk)
    assert int(ts2.train_steps) > steps0
    assert int(ts2.opt_state.count) == int(ts2.train_steps)
    assert td_loss(ts2, n) < before


# ---- transfer, the crossroad digest, the batches ---------------------------------

@pytest.mark.parametrize("algo", FAMILIES)
def test_transfer_both_ways(algo):
    """A JAX crossroad world with a trained controller becomes a port
    world leaf for leaf, and its leaves rebuild JAX's world."""
    jcfg, tcfg = _cfgs(algo, **CROSS)
    jw = jsynth.crossroad_world(jcfg, key=jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    jw = jw.replace(rl=jw.rl.replace(
        opt_state=_adam_state(jw.rl.params, rng, count=7),
        params=jax.tree_util.tree_map(lambda x: x + 0.5, jw.rl.params)))
    ref = world_to_leaves(jw)
    tw = transfer.world_from_numpy(ref, "cpu")
    assert type(tw.rl).__name__ == type(jw.rl).__name__
    assert int(tw.rl.opt_state.count) == 7
    got = transfer.world_to_numpy(tw)
    assert set(ref) == set(got), sorted(set(ref) ^ set(got))
    for k, a in ref.items():
        assert a.dtype == got[k].dtype and np.array_equal(a, got[k]), k
    flat, tree = jax.tree_util.tree_flatten_with_path(jw)
    names = list(world_to_leaves(jw))
    back = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(got[n]) for n in names])
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
               zip(jax.tree_util.tree_leaves(back),
                   jax.tree_util.tree_leaves(jw)))
    # the port's own crossroad: every leaf but the drawn parameters
    mine = transfer.world_to_numpy(synth.crossroad_world(tcfg,
                                                         device="cpu"))
    jw0 = world_to_leaves(jsynth.crossroad_world(jcfg,
                                                 key=jax.random.PRNGKey(0)))
    assert set(mine) == set(jw0)
    for k, a in jw0.items():
        assert a.dtype == mine[k].dtype and a.shape == mine[k].shape, k
        if "params." not in k:
            assert np.array_equal(a, mine[k]), k


def _digest():
    with open(os.path.join(DATA, "rl_digest.json")) as f:
        return json.load(f)


def rl_params(algo: str) -> dict:
    with np.load(os.path.join(DATA, "rl_params.npz")) as z:
        return {k[len(algo) + 1:]: z[k] for k in z.files
                if k.startswith(algo + ".")}


def check_digest(name: str, digest: dict, leaves: dict, near=()):
    """Every leaf's dtype, shape and sha256 against the JAX digest; the
    `near` f32 leaves may instead match its float64 sums within 1e-5."""
    import hashlib
    assert set(digest) == set(leaves), sorted(set(digest) ^ set(leaves))
    bad = []
    for k, d in digest.items():
        a = np.asarray(leaves[k])
        if str(a.dtype) != d["dtype"] or list(a.shape) != d["shape"]:
            bad.append((k, "dtype/shape"))
        elif hashlib.sha256(a.tobytes()).hexdigest() != d["sha256"]:
            v = a.astype(np.float64)
            if not (k in near and np.allclose(
                    (v.sum(), np.abs(v).sum(), v.max()),
                    (d["sum"], d["abs_sum"], d["max"]), rtol=1e-5, atol=0)):
                bad.append((k, "sha256"))
    assert not bad, f"{name}: {bad}"


def hold_off(cfg: Config) -> Config:
    """The digest's config: training held off for the window."""
    return cfg.replace(SRL_UPDATE_EVERY=10 ** 6,
                       GAT_BATCH_SIZE=cfg.GAT_MEMORY_CAPACITY + 1)


@pytest.mark.parametrize("algo", FAMILIES)
def test_crossroad_run_matches_jax_digest(algo):
    dig = _digest()
    n = dig["ticks"]
    rec = dig["crossroad"][algo]
    cfg = hold_off(Config(**dig["crossroad"]["cfg"],
                          TRAFFIC_LIGHT_AGENT_ALGORITHM=algo))
    w = transfer.with_rl_params(synth.crossroad_world(cfg, device="cpu"),
                                rl_params(algo))
    leaves = transfer.world_to_numpy(w)
    leaves.pop("cost_field")
    check_digest("init", rec["init"], leaves)
    end = sim.run_chunk(cfg, w, n)
    leaves = transfer.world_to_numpy(end)
    leaves.pop("cost_field")
    check_digest(f"tick {n}", rec[f"tick{n}"], leaves,
                 near={"rl." + k for k in NEAR})
    assert int(end.lights.current_phase.max()) >= 0


@pytest.mark.parametrize("algo", ["NEIGHBOR_RL", "NEIGHBOR_RL_BATCHED",
                                  "RL_A2C_BATCHED", "GAT_DQN",
                                  "GAT_DQN_BATCHED"])
def test_every_rl_algorithm_runs_through_traffic_sim(algo):
    """`TrafficSim.step(n)` (run_chunk, demand regenerated as JAX's
    `TrafficSim` does) and `step(1)` (step_world) train each algorithm on
    the crossroad."""
    cfg = Config(**CROSS, TRAFFIC_LIGHT_AGENT_ALGORITHM=algo,
                 SRL_UPDATE_EVERY=1, SRL_BATCH_SIZE=8, A2C_UPDATE_EVERY=3,
                 GAT_BATCH_SIZE=1)
    ts = sim.TrafficSim.from_world(cfg, synth.crossroad_world(cfg,
                                                              device="cpu"))
    ts.step(5)
    ts.step(1)
    assert int(ts.world.tick) == 6 and ts.stats()["tick"] == 6
    assert int(ts.world.rl.opt_state.count) >= 2
    with pytest.raises(ValueError, match="no RL train state"):
        sim.run_chunk(cfg, ts.world.replace(rl=None), 1)


def test_batch_runners_refuse_rl():
    cfg = Config(**CROSS, TRAFFIC_LIGHT_AGENT_ALGORITHM="RL_A2C_BATCHED")
    for call in (lambda: mesh.run_batch_shared(cfg, None, 5),
                 lambda: mesh.run_batch(cfg, None, 5),
                 lambda: mesh.run_chunk_batch(cfg, None, 5),
                 lambda: mesh.init_world_batch(cfg, prng.PRNGKey(0), 2,
                                               device="cpu")):
        with pytest.raises(NotImplementedError, match="item 14b"):
            call()


def test_trip_penalty_matches_jitted_jax():
    """GAT-DQN's reward penalty (JAX `step_engine`, `engine.py:701-708`,
    transcribed and jitted: XLA contracts it to an FMA) on random
    metrics, bit for bit."""
    def jax_penalty(sdi, sdt, ci, ct, si, st):
        avg_dur = 0.5 * (sdi / jnp.maximum(ci, 1) + sdt / jnp.maximum(ct, 1))
        avg_tpc = 0.5 * (sdi / jnp.maximum(si, 1) + sdt / jnp.maximum(st, 1))
        return 0.01 * avg_dur + 1.0 * avg_tpc

    f = jax.jit(jax.vmap(jax_penalty))
    rng = np.random.default_rng(3)
    n = 4000
    ints = [rng.integers(0, 5000, n).astype(np.int32) for _ in range(4)]
    ints[0][:50] = 0
    sums = [(rng.random(n) * 1e6).astype(np.float32) for _ in range(2)]
    ref = np.asarray(f(*sums, *ints))
    got = np.array([engine.trip_penalty(NS(
        sum_duration_internal=T(sums[0][i]), sum_duration_through=T(
            sums[1][i]), completed_internal=T(ints[0][i]),
        completed_through=T(ints[1][i]), sum_steps_internal=T(ints[2][i]),
        sum_steps_through=T(ints[3][i]))).item() for i in range(n)],
        np.float32)
    assert np.array_equal(ref, got), f"{int((ref != got).sum())} differ"
