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
are a dict of tensors keyed by flax's names (`rl/nets.py`, drawn as flax
draws them), the optimizer state is optax's `ScaleByAdamState` (`Adam`:
count, mu, nu), and `adam_update` is optax's Adam (b1 0.9, b2 0.999, eps
1e-8, bias corrected) on one flat vector.  Gradients come from
`torch.func.grad`; GAT's target network runs under `no_grad`, where JAX
has `stop_gradient`.

The training branch without a host sync per tick: JAX picks it with
`lax.cond` on device counters, which move deterministically (REINFORCE's
`since_train` grows by the number of valid groups a tick, A2C's `t` by
one, GAT's `filled` by the completed transitions, capped).  `plan_ticks`
reads the counters once at chunk entry, for one world or for every world
of a batch as one [B, k] copy, mirrors them on the host tick by tick and
decides each world's branch there, with the tick's random draws: the
Gumbel noise of `categorical` ([G, 2]), GAT's explore uniforms and random
actions ([G] each), the replay batch's indices, whose `randint` maxval
(`maximum(filled, 1)`) the mirror knows, and Adam's bias corrections.
The device counters move as JAX's do.  The draws come from each world's
RL key of the tick (`engine.tick_chain`) through `prng`, bit for bit
JAX's (the Gumbel transform with XLA's CPU f32 `log`).

A world batch runs the controllers under `torch.func.vmap`, where JAX's
`lax.cond` on a batched predicate is a select: when some world trains in
a tick, every world computes the update and keeps it where its `train`
flag is set (`_maybe_train`); when none does, the host skips the branch.
One world is the same code with one world's flags.
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
    """One tick's RL inputs, decided on the host by `plan_ticks`: per
    world tensors (0-d where one value a world) and two host flags for
    the whole batch."""
    gumbel: Optional[Tensor] = None     # f32 [G, 2]: categorical's noise
    explore_u: Optional[Tensor] = None  # f32 [G]: GAT's explore uniforms
    rand_a: Optional[Tensor] = None     # i32 [G]: GAT's random actions
    bidx: Optional[Tensor] = None       # i64 [BS]: the replay batch
    train: Optional[Tensor] = None      # bool []: this world trains
    sync: Optional[Tensor] = None       # bool []: GAT target <- params
    bc1: Optional[Tensor] = None        # f32 []: 1 - b1^count
    bc2: Optional[Tensor] = None        # f32 []: 1 - b2^count
    train_any: bool = False             # some world trains this tick
    train_all: bool = False             # every world trains this tick


@dataclasses.dataclass
class RLPlan:
    """The RL inputs of a chunk's n ticks (`plan_ticks`): `tensors`, each
    [n, ...] for one world or [B, n, ...] for a batch (the vmapped bodies
    of the world batches take them with in-dim 0 and rebuild the plan
    with `of`), the batch's host flags of each tick, and the host's
    mirror of each world's Adam count after each tick."""
    tensors: dict
    train_any: np.ndarray               # bool [n]
    train_all: np.ndarray               # bool [n]
    counts: np.ndarray                  # i64 [n] or [B, n]

    def of(self, tensors: dict) -> "RLPlan":
        return RLPlan(tensors, self.train_any, self.train_all, self.counts)

    def tick(self, i: int) -> RLTick:
        return RLTick(train_any=bool(self.train_any[i]),
                      train_all=bool(self.train_all[i]),
                      **{k: v[i] for k, v in self.tensors.items()})


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
    """optax's `adam().init`: zero moments and count, the count with the
    parameters' leading world dims (a kernel's last two dims are its
    own)."""
    p = next(v for k, v in params.items() if k.endswith("kernel"))
    return Adam(count=torch.zeros(p.shape[:-2], dtype=torch.int32,
                                  device=p.device),
                mu={k: torch.zeros_like(v) for k, v in params.items()},
                nu={k: torch.zeros_like(v) for k, v in params.items()})


def init_rl_state(cfg: Config, num_groups: int, key, device) -> Any:
    """The train state of the config's RL controller for `num_groups`
    groups, its parameters drawn from `key` as flax draws them
    (`nets.init_params`), on `device`; None for the FSM algorithms.
    `key`: uint32 [2], or [B, 2] for B worlds (every leaf then with a
    leading B, world b's as from key b alone, as JAX's `init_world`
    under `jax.vmap`)."""
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    if algo not in SRL_ALGOS + A2C_ALGOS + GAT_ALGOS:
        return None
    G = num_groups
    dev = torch.device(device)
    lead = np.shape(key)[:-1]
    params = nets.init_params(net_of(cfg), key, dev)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)
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
        epsilon=torch.full(lead + (G,), cfg.EPS_INITIAL, dtype=torch.float32,
                           device=dev),
        train_steps=z(dtype=i32), pend_s=z(G, 5, 9), pend_m=z(G, 5),
        pend_a=z(G, dtype=i32), pend_valid=z(G, dtype=torch.bool))


# ---------------------------------------------------------------------------
# The host plan of a chunk's ticks
# ---------------------------------------------------------------------------

def plan_ticks(cfg: Config, ts, valid: Tensor, rl_keys: np.ndarray
               ) -> RLPlan:
    """The RL inputs of n ticks from their RL keys (`engine.tick_chain`):
    uint32 [n, 2] for one world, [B, n, 2] for a batch, whose train state
    `ts` has a leading B on every leaf and whose `valid` is [G] (shared
    geometry) or [B, G].  One [B, k] read of the counters, the counters
    mirrored on the host tick by tick for every world at once, the draws
    of all worlds and ticks taken at once and hashed where the state lies
    (`prng.bits_on`; the replay indices' maxval per world and tick),
    Adam's bias corrections 1 - b^count in f32 per world and tick, the
    host's masks and corrections shipped in one copy per kind."""
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    dev = valid.device
    G = valid.shape[-1]
    lead = rl_keys.shape[:-2]               # () or (B,)
    n = rl_keys.shape[-2]
    vals = [valid.sum(-1).expand(lead), ts.opt_state.count]
    if algo in SRL_ALGOS:
        vals += [ts.filled, ts.since_train]
    elif algo in A2C_ALGOS:
        vals += [ts.t]
    else:
        vals += [ts.filled, ts.train_steps,
                 (ts.pend_valid & valid).sum(-1)]
    host = torch.stack([v.to(torch.int64) for v in vals], -1).cpu().numpy()
    nv, count = host[..., 0], host[..., 1].copy()
    train = np.zeros(lead + (n,), bool)
    counts = np.zeros(lead + (n,), np.int64)
    out = {}
    if algo in SRL_ALGOS:
        cap, B = ts.buf_s.shape[-2], cfg.SRL_BATCH_SIZE
        k_act, k_samp = np.moveaxis(prng.split(rl_keys, 2), -2, 0)
        filled, since = host[..., 2], host[..., 3]
        fills = np.zeros(lead + (n,), np.int64)
        for i in range(n):
            filled, since = np.minimum(filled + nv, cap), since + nv
            tr = since >= cfg.SRL_UPDATE_EVERY
            since, count = np.where(tr, 0, since), count + tr
            train[..., i], fills[..., i], counts[..., i] = tr, filled, count
        out.update(gumbel=prng.gumbel(k_act, (G, 2), dev), bidx=prng.randint(
            k_samp, 0, np.maximum(fills, 1), (B,), dev))
    elif algo in A2C_ALGOS:
        R, t = ts.roll_s.shape[-3], host[..., 2]
        for i in range(n):
            t = t + 1
            tr = t >= R
            t, count = np.where(tr, 0, t), count + tr
            train[..., i], counts[..., i] = tr, count
        out.update(gumbel=prng.gumbel(prng.split(rl_keys, 2)[..., 0, :],
                                      (G, 2), dev))
    else:
        cap, B = ts.buf_s.shape[-3], cfg.GAT_BATCH_SIZE
        k_eps, k_rand, k_samp = np.moveaxis(prng.split(rl_keys, 3), -2, 0)
        filled, steps, put = host[..., 2], host[..., 3], host[..., 4]
        fills = np.zeros(lead + (n,), np.int64)
        sync = np.zeros(lead + (n,), bool)
        for i in range(n):
            filled, put = np.minimum(filled + put, cap), nv
            tr = filled >= B
            steps, count = steps + tr, count + tr
            train[..., i], fills[..., i], counts[..., i] = tr, filled, count
            sync[..., i] = tr & (steps % cfg.GAT_TARGET_UPDATE_EVERY == 0)
        out.update(explore_u=prng.uniform(k_eps, (G,), dev),
                   rand_a=prng.randint(k_rand, 0, 2, (G,), dev),
                   bidx=prng.randint(k_samp, 0, np.maximum(fills, 1), (B,),
                                     dev),
                   sync=sync)
    out.update(train=train, **_bias_corrections(counts))
    flat = train.reshape(-1, n)
    dtypes = {"bidx": torch.int64, "rand_a": torch.int32}
    return RLPlan({k: (v if isinstance(v, Tensor) else torch.from_numpy(
                       np.ascontiguousarray(v))).to(dev, dtypes.get(k))
                   for k, v in out.items()},
                  flat.any(axis=0), flat.all(axis=0), counts)


def _bias_corrections(counts: np.ndarray) -> dict:
    """Adam's 1 - b1^count and 1 - b2^count in f32 (numpy's scalar f32
    power, one per distinct count; a count of 0, where no update is
    kept, as 1)."""
    f32 = np.float32
    uniq, inv = np.unique(np.maximum(counts, 1), return_inverse=True)
    bc = np.array([[f32(1.0) - f32(b) ** f32(c) for b in (B1, B2)]
                   for c in uniq], f32).reshape(-1, 2)
    return {"bc1": np.asarray(bc[inv, 0]).reshape(counts.shape),
            "bc2": np.asarray(bc[inv, 1]).reshape(counts.shape)}


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def interleaved_gae(gamma: float, lam: float, r: Tensor, v: Tensor,
                    m: Tensor) -> Tensor:
    """GAE over one flat interleaved pseudo-trajectory (the JAX
    `interleaved_gae`: the reference's `compute_gae` over buffer order);
    masked entries pass the (gae, next_v) chain through and get 0.  The
    recurrence is sequential over R x G entries, so it runs on the host
    in f32, one copy each way per update: a custom op whose vmap rule
    calls it once for the batch ([B, R*G], the worlds' recurrences side
    by side)."""
    return torch.ops.tsim.interleaved_gae(r.float(), v.float(), m.bool(),
                                          gamma, lam)


@torch.library.custom_op("tsim::interleaved_gae", mutates_args=())
def _interleaved_gae_op(r: Tensor, v: Tensor, m: Tensor, gamma: float,
                        lam: float) -> Tensor:
    """`interleaved_gae` over the last dim of r, v, m ([..., N]), every
    leading row its own trajectory."""
    f32 = np.float32
    rn, vn, mn = (x.detach().cpu().numpy() for x in (r, v, m))
    g, gl = f32(gamma), f32(gamma * lam)
    gae = np.zeros(rn.shape[:-1], f32)
    next_v = np.zeros(rn.shape[:-1], f32)
    adv = np.zeros(rn.shape, f32)
    for i in range(rn.shape[-1] - 1, -1, -1):
        mi = mn[..., i]
        g2 = (rn[..., i] + g * next_v - vn[..., i]) + gl * gae
        gae = np.where(mi, g2, gae)
        next_v = np.where(mi, vn[..., i], next_v)
        adv[..., i] = np.where(mi, g2, f32(0.0))
    return torch.from_numpy(adv).to(r.device)


@_interleaved_gae_op.register_fake
def _(r, v, m, gamma, lam):
    return torch.empty_like(r)


def _interleaved_gae_vmap(info, in_dims, r, v, m, gamma, lam):
    r, v, m = (x.movedim(d, 0) if d is not None
               else x.expand((info.batch_size,) + x.shape)
               for x, d in zip((r, v, m), in_dims[:3]))
    return _interleaved_gae_op(r, v, m, gamma, lam), 0


torch.library.register_vmap("tsim::interleaved_gae", _interleaved_gae_vmap)


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
    """d loss / d params by `torch.func.grad`: a function transform, so
    it runs for one world and under the batches' vmap alike."""
    return torch.func.grad(loss_fn)(params)


def adam_update(opt: Adam, params: dict, grads: dict, lr: float,
                bc1: Tensor, bc2: Tensor):
    """optax's `adam(lr)` update and `apply_updates`: returns (params',
    opt').  `bc1`, `bc2`: the bias corrections 1 - b^count of the
    update's count (opt.count + 1), f32 [] tensors from the host plan
    (`plan_ticks`).  Every parameter, gradient and moment is flattened
    into one vector, so that the update is a dozen launches whatever the
    number of layers (functorch has no batching rule for the `_foreach`
    ops); each element sees the f32 operations of optax's tree map, in
    its order, and the results are views of the vectors."""
    names = list(params)

    def flat(d):
        return torch.cat([d[k].reshape(-1) for k in names])
    g = flat(grads)
    mu = g * (1 - B1) + flat(opt.mu) * B1
    nu = (g * g) * (1 - B2) + flat(opt.nu) * B2
    new = flat(params) + ((mu / bc1) / (torch.sqrt(nu / bc2) + EPS)) * (-lr)
    sizes = [params[k].numel() for k in names]

    def unflat(v):
        return {k: t.view(params[k].shape)
                for k, t in zip(names, torch.split(v, sizes))}
    return unflat(new), Adam(count=opt.count + 1, mu=unflat(mu),
                             nu=unflat(nu))


def tree(x):
    """A train state as nested dicts of tensors (the pytrees that
    `torch.func.vmap` maps over)."""
    if dataclasses.is_dataclass(x):
        return {f.name: tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return {k: tree(v) for k, v in x.items()} if isinstance(x, dict) else x


def untree(like, d):
    """`tree` undone: the nested dicts `d` as a train state shaped as
    `like`."""
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: untree(getattr(like, f.name),
                                            d[f.name])
                             for f in dataclasses.fields(like)})
    return d


def _keep(flag: Tensor, new, old):
    """`torch.where(flag, new, old)` leaf by leaf over a train state
    (structs, dicts of tensors, tensors): JAX's `lax.cond` on a batched
    predicate, which vmap turns into a select."""
    if isinstance(new, Tensor):
        return torch.where(flag, new, old)
    if isinstance(new, dict):
        return {k: _keep(flag, v, old[k]) for k, v in new.items()}
    return type(new)(**{f.name: _keep(flag, getattr(new, f.name),
                                      getattr(old, f.name))
                        for f in dataclasses.fields(new)})


def _maybe_train(ts, tick: RLTick, update):
    """Take the training branch for the worlds whose `tick.train` is
    set: skipped on the host when no world trains this tick, the update
    kept whole when every world does, else computed for every world and
    kept where its flag is set."""
    if not tick.train_any:
        return ts
    new = update(ts)
    return new if tick.train_all else _keep(tick.train, new, ts)


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
    ts = _maybe_train(ts, tick, lambda t: _srl_train(cfg, net, t, tick))
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
                              cfg.SRL_LEARNING_RATE, tick.bc1, tick.bc2)
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
    ts = _maybe_train(ts, tick, lambda t: _a2c_update(cfg, net, t, tick))
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
                              cfg.SRL_LEARNING_RATE, tick.bc1, tick.bc2)
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
    ts = _maybe_train(ts, tick, lambda t: _gat_train(cfg, net, t, tick))
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
                              _grads(loss_fn, ts.params), GAT_LR, tick.bc1,
                              tick.bc2)
    return ts.replace(params=params, opt_state=opt,
                      target_params=_keep(tick.sync, params,
                                          ts.target_params),
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
