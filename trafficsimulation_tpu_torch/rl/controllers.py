"""RL traffic-light controllers: REINFORCE (NEIGHBOR_RL*), A2C, GAT-DQN
(the JAX package's `rl/controllers.py`, flax and optax there).

Each controller is a function
    (train_state, world pieces, this tick's RL inputs)
        -> (train_state', lights', want, phase_req)
whose (want, phase_req) plugs into `fsm.run_controllers`.  All groups act
in one batched forward pass.  The JAX module docstring gives the shared
phase mechanics and the three parity notes, which hold here as they are:
REINFORCE's reward is -(local_ns + local_ew) (the reference's cross
pressure sum is identically zero); A2C's GAE runs per group along time
unless A2C_INTERLEAVED_GAE; GAT-DQN stores a transition at the NEXT
invocation, when its post-action state is observable.

The train states are the JAX structs with the same fields.  Parameters
are a dict of tensors keyed by flax's names (`rl/nets.py`), the
optimizer state is optax's `ScaleByAdamState` (`Adam`: count, mu, nu),
and `adam_update` is optax's Adam (b1 0.9, b2 0.999, eps 1e-8, bias
corrected) on explicit tensors with a few `torch._foreach_*` calls.
Gradients come from `torch.autograd`; GAT's target network runs under
`no_grad`, where JAX has `stop_gradient`.

The training branch without a host sync per tick: JAX picks it with
`lax.cond` on device counters, which move deterministically (REINFORCE's
`since_train` grows by the number of valid groups a tick, A2C's `t` by
one, GAT's `filled` by the completed transitions, capped).  `plan_ticks`
reads the counters once at chunk entry, mirrors them on the host tick
by tick and decides each tick's branch there, with the tick's random
draws: the Gumbel noise of `categorical` ([G, 2]), GAT's explore
uniforms and random actions ([G] each), and the replay batch's indices,
whose `randint` maxval (`maximum(filled, 1)`) the mirror knows.  The
device counters move as JAX's do.  The draws come from the tick's RL key
(`engine.tick_chain`) through `prng`, bit for bit JAX's bits; the
Gumbel transform uses numpy's f32 `log` (`prng.gumbel`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import prng
from ..config import Config
from ..core.state import _Struct
from . import features, nets

Tensor = torch.Tensor
SRL_ALGOS = ("NEIGHBOR_RL", "NEIGHBOR_RL_BATCHED")
A2C_ALGOS = ("RL_A2C_BATCHED",)
GAT_ALGOS = ("GAT_DQN", "GAT_DQN_BATCHED")
A2C_DIM = 13
GAT_LR = 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class Adam(_Struct):
    """optax's `ScaleByAdamState`."""
    count: Tensor          # i32 [] updates taken
    mu: dict               # first moments, keyed as the params
    nu: dict               # second moments


@dataclasses.dataclass
class SRLTrain(_Struct):
    params: dict
    opt_state: Adam
    buf_s: Tensor          # f32 [CAP, DIM]
    buf_a: Tensor          # i32 [CAP]
    buf_r: Tensor          # f32 [CAP]
    cursor: Tensor         # i32 write position
    filled: Tensor         # i32 number of valid rows
    since_train: Tensor    # i32


@dataclasses.dataclass
class A2CTrain(_Struct):
    params: dict
    opt_state: Adam
    roll_s: Tensor         # f32 [R, G, DIM]
    roll_a: Tensor         # i32 [R, G]
    roll_r: Tensor         # f32 [R, G]
    roll_v: Tensor         # f32 [R, G]
    roll_m: Tensor         # bool [R, G] valid mask
    t: Tensor              # i32 rollout cursor
    global_step: Tensor    # i32


@dataclasses.dataclass
class GATTrain(_Struct):
    params: dict
    target_params: dict
    opt_state: Adam
    buf_s: Tensor          # f32 [CAP, 5, 9]
    buf_m: Tensor          # f32 [CAP, 5]
    buf_a: Tensor          # i32 [CAP]
    buf_r: Tensor          # f32 [CAP]
    buf_ns: Tensor         # f32 [CAP, 5, 9]
    buf_nm: Tensor         # f32 [CAP, 5]
    cursor: Tensor
    filled: Tensor
    epsilon: Tensor        # f32 [G]
    train_steps: Tensor
    # the pending (s, a) that waits for its next state
    pend_s: Tensor         # f32 [G, 5, 9]
    pend_m: Tensor         # f32 [G, 5]
    pend_a: Tensor         # i32 [G]
    pend_valid: Tensor     # bool [G]


TRAIN_TYPES = (SRLTrain, A2CTrain, GATTrain)


@dataclasses.dataclass
class RLTick(_Struct):
    """One tick's RL inputs, decided on the host by `plan_ticks`."""
    gumbel: Optional[Tensor] = None     # f32 [G, 2]: categorical's noise
    explore_u: Optional[Tensor] = None  # f32 [G]: GAT's explore uniforms
    rand_a: Optional[Tensor] = None     # i32 [G]: GAT's random actions
    train: bool = False                 # take the training branch
    bidx: Optional[Tensor] = None       # i64 [B]: the replay batch
    count: int = 0                      # Adam's count after the update
    sync: bool = False                  # GAT: target <- params after it


def net_of(cfg: Config):
    """The module of the config's controller family (`rl/nets.py`)."""
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    if algo in SRL_ALGOS:
        return nets.build("policy", cfg.SRL_INPUT_DIMENSIONS,
                          cfg.SRL_HIDDEN_LAYER_SIZE, cfg.SRL_HIDDEN_LAYERS)
    if algo in A2C_ALGOS:
        return nets.build("actor_critic", A2C_DIM, cfg.A2C_HIDDEN_LAYER_SIZE,
                          cfg.A2C_HIDDEN_LAYERS)
    if algo in GAT_ALGOS:
        return nets.build("gat")
    raise ValueError(algo)


def adam_init(params: dict) -> Adam:
    dev = next(iter(params.values())).device
    return Adam(count=torch.zeros((), dtype=torch.int32, device=dev),
                mu={k: torch.zeros_like(v) for k, v in params.items()},
                nu={k: torch.zeros_like(v) for k, v in params.items()})


def init_rl_state(cfg: Config, num_groups: int, key, device) -> Any:
    """The train state of the config's RL controller for `num_groups`
    groups, its parameters drawn from `key` (uint32 [2];
    `nets.init_params`), on `device`; None for the FSM algorithms."""
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    if algo not in SRL_ALGOS + A2C_ALGOS + GAT_ALGOS:
        return None
    G = num_groups
    dev = torch.device(device)
    params = nets.init_params(net_of(cfg), key, dev)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)
    i32 = torch.int32
    if algo in SRL_ALGOS:
        cap = max(4 * cfg.SRL_BATCH_SIZE, 2 * G)
        return SRLTrain(
            params=params, opt_state=adam_init(params),
            buf_s=z(cap, cfg.SRL_INPUT_DIMENSIONS), buf_a=z(cap, dtype=i32),
            buf_r=z(cap), cursor=z(dtype=i32), filled=z(dtype=i32),
            since_train=z(dtype=i32))
    if algo in A2C_ALGOS:
        R = cfg.A2C_UPDATE_EVERY
        return A2CTrain(
            params=params, opt_state=adam_init(params),
            roll_s=z(R, G, A2C_DIM), roll_a=z(R, G, dtype=i32),
            roll_r=z(R, G), roll_v=z(R, G), roll_m=z(R, G, dtype=torch.bool),
            t=z(dtype=i32), global_step=z(dtype=i32))
    cap = cfg.GAT_MEMORY_CAPACITY
    return GATTrain(
        params=params, target_params=dict(params),
        opt_state=adam_init(params),
        buf_s=z(cap, 5, 9), buf_m=z(cap, 5), buf_a=z(cap, dtype=i32),
        buf_r=z(cap), buf_ns=z(cap, 5, 9), buf_nm=z(cap, 5),
        cursor=z(dtype=i32), filled=z(dtype=i32),
        epsilon=torch.full((G,), cfg.EPS_INITIAL, dtype=torch.float32,
                           device=dev),
        train_steps=z(dtype=i32), pend_s=z(G, 5, 9), pend_m=z(G, 5),
        pend_a=z(G, dtype=i32), pend_valid=z(G, dtype=torch.bool))


# ---------------------------------------------------------------------------
# The host plan of a chunk's ticks
# ---------------------------------------------------------------------------

def plan_ticks(cfg: Config, ts, valid: Tensor, rl_keys: np.ndarray):
    """The RL inputs of n ticks (`RLTick` each) from their RL keys
    (uint32 [n, 2], `engine.tick_chain`): one read of the train state's
    counters, the counters mirrored on the host tick by tick, the draws
    of all n ticks taken at once (the replay indices' maxval per tick)
    and shipped to the state's device in one copy per kind."""
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    dev = valid.device
    G = valid.shape[0]
    n = rl_keys.shape[0]
    vals = [valid.sum(), ts.opt_state.count]
    if algo in SRL_ALGOS:
        vals += [ts.filled, ts.since_train]
    elif algo in A2C_ALGOS:
        vals += [ts.t]
    else:
        vals += [ts.filled, ts.train_steps, (ts.pend_valid & valid).sum()]
    host = torch.stack([v.to(torch.int64) for v in vals]).cpu().tolist()
    nv, count = host[0], host[1]
    train = np.zeros(n, bool)
    counts = np.zeros(n, np.int64)
    if algo in SRL_ALGOS:
        cap, B = ts.buf_s.shape[0], cfg.SRL_BATCH_SIZE
        k_act, k_samp = np.moveaxis(prng.split(rl_keys, 2), 1, 0)
        filled, since = host[2], host[3]
        fills = np.zeros(n, np.int64)
        for i in range(n):
            filled, since = min(filled + nv, cap), since + nv
            if since >= cfg.SRL_UPDATE_EVERY:
                since, count, train[i] = 0, count + 1, True
            fills[i], counts[i] = filled, count
        gum_t, bidx_t = _to(dev, prng.gumbel(k_act, (G, 2)), prng.randint(
            k_samp, 0, np.maximum(fills, 1), (B,)).astype(np.int64))
        return [RLTick(gumbel=gum_t[i], train=bool(train[i]), bidx=bidx_t[i],
                       count=int(counts[i])) for i in range(n)]
    if algo in A2C_ALGOS:
        R, t = ts.roll_s.shape[0], host[2]
        for i in range(n):
            t += 1
            if t >= R:
                t, count, train[i] = 0, count + 1, True
            counts[i] = count
        (gum_t,) = _to(dev, prng.gumbel(prng.split(rl_keys, 2)[:, 0],
                                        (G, 2)))
        return [RLTick(gumbel=gum_t[i], train=bool(train[i]),
                       count=int(counts[i])) for i in range(n)]
    cap, B = ts.buf_s.shape[0], cfg.GAT_BATCH_SIZE
    k_eps, k_rand, k_samp = np.moveaxis(prng.split(rl_keys, 3), 1, 0)
    filled, steps, put = host[2], host[3], host[4]
    fills = np.zeros(n, np.int64)
    sync = np.zeros(n, bool)
    for i in range(n):
        filled, put = min(filled + put, cap), nv
        if filled >= B:
            steps, count, train[i] = steps + 1, count + 1, True
            sync[i] = steps % cfg.GAT_TARGET_UPDATE_EVERY == 0
        fills[i], counts[i] = filled, count
    eu_t, ra_t, bidx_t = _to(
        dev, prng.uniform(k_eps, (G,)), prng.randint(k_rand, 0, 2, (G,)),
        prng.randint(k_samp, 0, np.maximum(fills, 1), (B,)).astype(np.int64))
    return [RLTick(explore_u=eu_t[i], rand_a=ra_t[i], train=bool(train[i]),
                   bidx=bidx_t[i], count=int(counts[i]), sync=bool(sync[i]))
            for i in range(n)]


def _to(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def interleaved_gae(gamma: float, lam: float, r: Tensor, v: Tensor,
                    m: Tensor) -> Tensor:
    """GAE over one flat interleaved pseudo-trajectory (the JAX
    `interleaved_gae`: the reference's `compute_gae` over buffer order);
    masked entries pass the (gae, next_v) chain through and get 0.  The
    recurrence is sequential over R x G entries, so it runs on the host
    in f32 (one copy each way per update)."""
    f32 = np.float32
    rn, vn, mn = (x.detach().cpu().numpy() for x in (r.float(), v.float(),
                                                      m.bool()))
    g, gl = f32(gamma), f32(gamma * lam)
    gae = next_v = f32(0.0)
    adv = np.zeros(rn.shape, f32)
    for i in range(rn.shape[0] - 1, -1, -1):
        if mn[i]:
            delta = rn[i] + g * next_v - vn[i]
            gae = delta + gl * gae
            next_v = vn[i]
            adv[i] = gae
    return torch.from_numpy(adv).to(r.device)


def group_gae(gamma: float, lam: float, r: Tensor, v: Tensor) -> Tensor:
    """Per-group GAE along time (the JAX scan at `controllers.py:
    297-308`): r, v [R, G] -> advantages [R, G]."""
    v_next = torch.cat([v[1:], torch.zeros_like(v[:1])])
    delta = r + gamma * v_next - v
    gae = torch.zeros_like(r[0])
    out = [None] * r.shape[0]
    for i in range(r.shape[0] - 1, -1, -1):
        gae = torch.add(delta[i], gae, alpha=gamma * lam)
        out[i] = gae
    return torch.stack(out)


def _phase_mechanics(cfg: Config, lights, active, action, min_green):
    """Shared rl_timer / rl_phase bookkeeping.  Returns (lights',
    want_apply, phase_req)."""
    timer = torch.where(active, lights.rl_timer + 1, lights.rl_timer)
    want = active & (timer == 1)
    phase_req = lights.ft_phase
    toggle = active & (action == 1) & (timer >= min_green)
    new_phase = torch.where(toggle, 1 - lights.ft_phase, lights.ft_phase)
    timer = torch.where(toggle, 0, timer)
    return lights.replace(rl_timer=timer, ft_phase=new_phase), want, phase_req


def _ring_write(buf: Tensor, cursor: Tensor, vals: Tensor, n: int) -> Tensor:
    """Write n rows into a ring buffer at cursor (wrapping; n <= its
    length)."""
    cap = buf.shape[0]
    idx = (cursor + torch.arange(n, device=buf.device)) % cap
    return buf.index_put((idx.long(),), vals.to(buf.dtype))


def _drop_write(buf: Tensor, widx: Tensor, vals: Tensor) -> Tensor:
    """`buf.at[widx].set(vals, mode="drop")`, where a row with index
    len(buf) is dropped (a sink row sliced off)."""
    ext = torch.cat([buf, buf.new_zeros((1,) + buf.shape[1:])])
    return ext.index_put((widx.long(),), vals.to(buf.dtype))[:buf.shape[0]]


def _store_rows(ts, put: Tensor, rows: dict):
    """Write group g's row at (cursor + g) % cap where put[g] (the JAX
    index, holes and all); the cursor moves by the rows written.
    Returns the buffers, cursor and filled as replacements, and that
    count."""
    cap = ts.buf_s.shape[0]
    G = put.shape[0]
    idx = (ts.cursor + torch.arange(G, device=put.device)) % cap
    widx = torch.where(put, idx, cap)
    nput = put.sum().to(torch.int32)
    out = {k: _drop_write(getattr(ts, k), widx, v) for k, v in rows.items()}
    out.update(cursor=(ts.cursor + nput) % cap,
               filled=torch.clamp(ts.filled + nput, max=cap))
    return out, nput


def _grads(loss_fn, params: dict) -> dict:
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        g = torch.autograd.grad(loss_fn(p), list(p.values()))
    return dict(zip(p, g))


def adam_update(opt: Adam, params: dict, grads: dict, lr: float,
                count: int):
    """optax's `adam(lr)` update and `apply_updates`: returns (params',
    opt').  `count` is the update's count (opt.count + 1), mirrored on
    the host, for the bias corrections 1 - b**count."""
    f32 = np.float32
    names = list(params)
    g = [grads[k] for k in names]
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                            torch._foreach_mul([opt.mu[k] for k in names],
                                               B1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
        torch._foreach_mul([opt.nu[k] for k in names], B2))
    bc1 = float(f32(1.0) - f32(B1) ** f32(count))
    bc2 = float(f32(1.0) - f32(B2) ** f32(count))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                             EPS)
    upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    new = torch._foreach_add([params[k] for k in names],
                             torch._foreach_mul(upd, -lr))
    return dict(zip(names, new)), Adam(count=opt.count + 1,
                                       mu=dict(zip(names, mu)),
                                       nu=dict(zip(names, nu)))


# ---------------------------------------------------------------------------
# REINFORCE (NEIGHBOR_RL / NEIGHBOR_RL_BATCHED)
# ---------------------------------------------------------------------------

def srl_step(cfg: Config, ts: SRLTrain, grid, gs, lights, occupancy,
             stuck_map, tick: RLTick):
    G = gs.valid.shape[0]
    net = net_of(cfg)
    s = features.srl_state(cfg, grid, gs, lights, occupancy, stuck_map)
    with torch.no_grad():
        logits = nets.apply(net, ts.params, s)
    action = torch.argmax(logits + tick.gumbel, dim=-1).to(torch.int32)
    active = gs.valid & (lights.pending_phase == -1)
    lights, want, phase_req = _phase_mechanics(
        cfg, lights, active, action, cfg.SRL_MIN_GREEN)

    # reward: -(queue) [+ stuck penalty] (the JAX module docstring)
    ln, le = features.group_flows(grid, occupancy, G)
    neg = ln + le
    if cfg.SRL_PUNISH_STUCK:
        sn, se = features.group_flows(grid, stuck_map, G)
        neg = neg + (sn + se) * cfg.SRL_PUNISH_STUCK_FACTOR
    rows, nput = _store_rows(ts, gs.valid, dict(buf_s=s, buf_a=action,
                                                buf_r=-neg))
    ts = ts.replace(since_train=ts.since_train + nput, **rows)
    if tick.train:
        ts = _srl_train(cfg, net, ts, tick)
    return ts, lights, want, phase_req


def _srl_train(cfg: Config, net, ts: SRLTrain, tick: RLTick) -> SRLTrain:
    bs, ba, br = ts.buf_s[tick.bidx], ts.buf_a[tick.bidx], ts.buf_r[tick.bidx]

    def loss_fn(p):
        lg = nets.apply(net, p, bs)
        logp = torch.log_softmax(lg, dim=-1)
        nll = -torch.gather(logp, 1, ba[:, None].long())[:, 0]
        ent = -torch.sum(torch.softmax(lg, dim=-1) * logp, dim=1)
        return torch.mean(nll * br) - 0.01 * torch.mean(ent)

    params, opt = adam_update(ts.opt_state, ts.params,
                              _grads(loss_fn, ts.params),
                              cfg.SRL_LEARNING_RATE, tick.count)
    return ts.replace(params=params, opt_state=opt,
                      since_train=torch.zeros_like(ts.since_train))


# ---------------------------------------------------------------------------
# A2C (RL_A2C_BATCHED)
# ---------------------------------------------------------------------------

def a2c_step(cfg: Config, ts: A2CTrain, grid, gs, lights, occupancy,
             tick: RLTick):
    G = gs.valid.shape[0]
    net = net_of(cfg)
    s = features.a2c_state(cfg, grid, gs, lights, occupancy)
    with torch.no_grad():
        logits, value = nets.apply(net, ts.params, s)
    action = torch.argmax(logits + tick.gumbel, dim=-1).to(torch.int32)
    active = gs.valid & (lights.pending_phase == -1)
    lights, want, phase_req = _phase_mechanics(
        cfg, lights, active, action,
        cfg.TRAFFIC_LIGHT_PRESSURE_CONTROL_MIN_GREEN)

    # reward = -(queue + 0.25 * pressure^2) (`rl_a2c.py:160-164`)
    ln, le = features.group_flows(grid, occupancy, G)
    reward = -(ln + le + 0.25 * (ln - le) ** 2)

    t = (ts.t.reshape(1).long(),)
    ts = ts.replace(
        roll_s=ts.roll_s.index_put(t, s[None]),
        roll_a=ts.roll_a.index_put(t, action[None]),
        roll_r=ts.roll_r.index_put(t, reward[None]),
        roll_v=ts.roll_v.index_put(t, value[None]),
        roll_m=ts.roll_m.index_put(t, gs.valid[None]),
        t=ts.t + 1)
    if tick.train:
        ts = _a2c_update(cfg, net, ts, tick)
    return ts, lights, want, phase_req


def _a2c_update(cfg: Config, net, ts: A2CTrain, tick: RLTick) -> A2CTrain:
    R, G = ts.roll_r.shape
    if cfg.A2C_INTERLEAVED_GAE:
        adv = interleaved_gae(cfg.A2C_GAMMA, cfg.A2C_LAMBDA,
                              ts.roll_r.reshape(-1), ts.roll_v.reshape(-1),
                              ts.roll_m.reshape(-1)).reshape(R, G)
    else:
        adv = group_gae(cfg.A2C_GAMMA, cfg.A2C_LAMBDA, ts.roll_r, ts.roll_v)
    ret = adv + ts.roll_v
    m = ts.roll_m.reshape(-1).to(torch.float32)
    msum = torch.clamp(ts.roll_m.sum(), min=1)
    advf = adv.reshape(-1)
    mean = torch.sum(advf * m) / msum
    var = torch.sum((advf - mean) ** 2 * m) / msum
    advf = (advf - mean) / (torch.sqrt(var) + 1e-8)
    ent_coef = cfg.A2C_ENTROPY_MIN + (
        cfg.A2C_ENTROPY_MAX - cfg.A2C_ENTROPY_MIN) * torch.exp(
            -ts.global_step.to(torch.float32) / cfg.A2C_ENTROPY_DECAY_STEPS)
    bs = ts.roll_s.reshape(R * G, -1)
    ba = ts.roll_a.reshape(-1, 1).long()
    bret = ret.reshape(-1)

    def loss_fn(p):
        lg, v = nets.apply(net, p, bs)
        logp = torch.log_softmax(lg, dim=-1)
        alp = torch.gather(logp, 1, ba)[:, 0]
        pg = -torch.sum(alp * advf * m) / msum
        vl = torch.sum((bret - v) ** 2 * m) / msum
        ent = -torch.sum(torch.sum(torch.exp(logp) * logp, dim=1) * m) / msum
        return pg + 0.5 * vl - ent_coef * ent

    params, opt = adam_update(ts.opt_state, ts.params,
                              _grads(loss_fn, ts.params),
                              cfg.SRL_LEARNING_RATE, tick.count)
    return ts.replace(params=params, opt_state=opt,
                      t=torch.zeros_like(ts.t),
                      global_step=ts.global_step + 1)


# ---------------------------------------------------------------------------
# GAT-DQN (GAT_DQN / GAT_DQN_BATCHED)
# ---------------------------------------------------------------------------

def gat_step(cfg: Config, ts: GATTrain, grid, gs, lights, occupancy,
             trip_penalty, tick: RLTick):
    """trip_penalty: the scalar global reward penalty
    0.01 * avg_trip_duration + 1.0 * avg_time_per_cell."""
    G = gs.valid.shape[0]
    net = net_of(cfg)
    feats, mask = features.gat_state(cfg, grid, gs, lights, occupancy)

    # complete last tick's pending (s, a) with the now observable
    # post-action state and reward
    ln, le = features.group_flows(grid, occupancy, G)
    reward = -(ln + le + trip_penalty)
    rows, _ = _store_rows(ts, ts.pend_valid & gs.valid, dict(
        buf_s=ts.pend_s, buf_m=ts.pend_m, buf_a=ts.pend_a, buf_r=reward,
        buf_ns=feats, buf_nm=mask))
    ts = ts.replace(**rows)

    with torch.no_grad():
        q = nets.apply(net, ts.params, feats, mask)
    greedy = torch.argmax(q, dim=1).to(torch.int32)
    explore = tick.explore_u < ts.epsilon
    action = torch.where(explore, tick.rand_a, greedy)
    epsilon = torch.clamp(ts.epsilon - cfg.EPS_DECAY_RATE, min=cfg.EPS_MIN)

    active = gs.valid & (lights.pending_phase == -1)
    lights, want, phase_req = _phase_mechanics(
        cfg, lights, active, action, cfg.GAT_TRAFFIC_RL_MIN_GREEN)
    ts = ts.replace(pend_s=feats, pend_m=mask, pend_a=action,
                    pend_valid=gs.valid, epsilon=epsilon)
    if tick.train:
        ts = _gat_train(cfg, net, ts, tick)
    return ts, lights, want, phase_req


def _gat_train(cfg: Config, net, ts: GATTrain, tick: RLTick) -> GATTrain:
    b = tick.bidx
    bs, bm, ba, br = ts.buf_s[b], ts.buf_m[b], ts.buf_a[b], ts.buf_r[b]
    with torch.no_grad():
        qn = nets.apply(net, ts.target_params, ts.buf_ns[b], ts.buf_nm[b])
        tgt = br + cfg.GAT_GAMMA * torch.amax(qn, dim=1)

    def loss_fn(p):
        qp = nets.apply(net, p, bs, bm)
        qsa = torch.gather(qp, 1, ba[:, None].long())[:, 0]
        return torch.mean((qsa - tgt) ** 2)

    params, opt = adam_update(ts.opt_state, ts.params,
                              _grads(loss_fn, ts.params), GAT_LR, tick.count)
    return ts.replace(params=params, opt_state=opt,
                      target_params=(dict(params) if tick.sync
                                     else ts.target_params),
                      train_steps=ts.train_steps + 1)


def rl_controller_step(cfg: Config, rl_state, grid, gs, lights, occupancy,
                       stuck_map, trip_penalty, tick: RLTick):
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    if algo in SRL_ALGOS:
        return srl_step(cfg, rl_state, grid, gs, lights, occupancy,
                        stuck_map, tick)
    if algo in A2C_ALGOS:
        return a2c_step(cfg, rl_state, grid, gs, lights, occupancy, tick)
    if algo in GAT_ALGOS:
        return gat_step(cfg, rl_state, grid, gs, lights, occupancy,
                        trip_penalty, tick)
    raise ValueError(algo)
