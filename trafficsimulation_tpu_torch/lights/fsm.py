"""Traffic-light control: queue reductions, the five FSM controllers and
the phase commit (the JAX package's `lights/fsm.py`; see its docstring
for the reference semantics of each controller).

The queue counts come from two prefix-sum gathers per axis-aligned run
(K4 builds the prefix planes), the stop map from a run diff-array and
one `cumsum` per axis.  The dense forms (`build_dense_reducers`) turn
both into one matrix product against a one-hot geometry matrix, which
under vmap becomes one batched product for all worlds of a
shared-geometry batch (`parallel/mesh.run_batch_shared`).  The RL
controllers live in `rl/controllers.py` and hand their phase requests
to `run_controllers`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config

from ..core.state import LightsState, LightStatic, GroupStatic, Grid
from ..ops import hopper_engine as HE

NS_IN, NS_OUT, EW_IN, EW_OUT = 0, 1, 2, 3

FSM_ALGOS = ("DISABLED", "FIXED_TIME", "QUEUE_ACTUATED", "PRESSURE_CONTROL",
             "NEIGHBOR_PRESSURE_CONTROL", "NEIGHBOR_GREEN_WAVE")
RL_ALGOS = ("NEIGHBOR_RL", "NEIGHBOR_RL_BATCHED", "RL_A2C_BATCHED",
            "GAT_DQN", "GAT_DQN_BATCHED")


def init_lights_state(cfg: Config, num_groups: int, num_lights: int,
                      group_valid: torch.Tensor) -> LightsState:
    G, L = num_groups, num_lights
    dev = group_valid.device
    pending = torch.where(
        group_valid & (cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM != "DISABLED"),
        0, -1).to(torch.int32)
    z = torch.zeros((G,), dtype=torch.int32, device=dev)
    return LightsState(
        current_phase=torch.full((G,), -1, dtype=torch.int32, device=dev),
        pending_phase=pending,
        transition_timer=z, clearance_timer=z.clone(), ft_phase=z.clone(),
        fixed_time_timer=z.clone(), queue_timer=z.clone(),
        gap_timer=z.clone(), last_arrival=z.clone(),
        ns_pressure=torch.zeros((G,), dtype=torch.float32, device=dev),
        ew_pressure=torch.zeros((G,), dtype=torch.float32, device=dev),
        rl_timer=z.clone(),
        light_stop=torch.zeros((L,), dtype=torch.bool, device=dev))


def _prefix_planes(occupancy: torch.Tensor) -> torch.Tensor:
    """Flat exclusive prefix buffer [H*(W+1) + (H+1)*W]: row prefixes
    Ph[y, j] = sum(occ[y, :j]), then column prefixes Pv[k, x] =
    sum(occ[:k, x]).  The inclusive prefixes come from K4."""
    incH, incV = HE.prefix_planes(occupancy.to(torch.int32).contiguous())
    Ph = F.pad(incH, (1, 0))          # [H, W+1]
    Pv = F.pad(incV, (0, 0, 1, 0))    # [H+1, W]
    return torch.cat([Ph.reshape(-1), Pv.reshape(-1)])


def build_dense_reducers(cfg: Config, grid: Grid, ls: LightStatic,
                         build_m: bool = True, build_a: bool = True):
    """Dense one-hot matrices for the two per-tick geometry reductions,
    built once per chunk from the static geometry (the JAX
    `build_dense_reducers`):

      M [HW, G*5+1] — M[c, g*5+b] = 1 iff cell c carries queue label
        (g, b); the queue counts are occ @ M.
      A [L, HW] bf16 — A[l, c] = 1 iff light l stops cell c (its own
        cell and its assigned controlled roads); the stop map is
        light_stop @ A > 0.5.

    Exact: the operands are 0/1.  M is f32, so the counts are exact
    integers below 2^24 on every device; the stop map only asks whether
    a count is positive, which a bf16 product of 0/1 operands answers
    exactly."""
    H, W = grid.cell_type.shape
    HW = H * W
    G = int(cfg.capacities().max_groups)
    L = ls.valid.shape[0]
    dev = ls.valid.device
    M = A = None
    if build_m:
        qg = grid.queue_group.reshape(-1).to(torch.int32)
        qb = grid.queue_bucket.reshape(-1).to(torch.int32)
        seg = torch.where(qg >= 0, qg * 5 + qb, G * 5)
        M = (seg[:, None] == torch.arange(G * 5 + 1, dtype=torch.int32,
                                          device=dev)[None, :]
             ).to(torch.float32)
    if build_a:
        # column HW is the sink of the dropped writes
        A = torch.zeros((L, HW + 1), dtype=torch.bfloat16, device=dev)
        pc = torch.where(ls.assign_valid, ls.assign_road, HW).long()
        A[torch.clamp(ls.assign_light, 0, L - 1).long(), pc] = 1
        A[torch.arange(L, device=dev),
          torch.where(ls.valid, ls.pos, HW).long()] = 1
        A = A[:, :HW].contiguous()
    return M, A


def dense_reducer_modes(cfg: Config) -> tuple:
    """(use_dense_M, use_dense_A), the JAX package's rule: each dense
    matrix pays only while its per-tick read stays small (M at most 64
    MB, A at most 192 MB in bf16) and the grid is at least 256x256."""
    caps = cfg.capacities()
    HW = cfg.HEIGHT * cfg.WIDTH
    m_ok = HW >= 256 * 256 and \
        (caps.max_groups * 5 + 1) * HW * 2 <= 64 * 1024 * 1024
    a_ok = HW >= 256 * 256 and \
        HW * caps.max_lights * 2 <= 192 * 1024 * 1024
    return m_ok, a_ok


def dense_reducers_profitable(cfg: Config) -> bool:
    return any(dense_reducer_modes(cfg))


def group_reductions(grid: Grid, occupancy: torch.Tensor, num_groups: int,
                     gs: GroupStatic, dense_m: torch.Tensor = None,
                     slab=None):
    """Per-group (ns_in, ns_out, ew_in, ew_out) queue counts and the
    intersection-occupied flag (bucket 4), from the run tables or, with
    `dense_m`, as one matrix product.  `slab` (`parallel/spatial.Slab`;
    the run tables only): `occupancy` is a rank's own rows; each rank
    counts the parts of the runs in its rows (a row run lies in one
    rank's rows; a column run is clipped to them, `Slab.prepare`), and
    one all-reduce sums them."""
    G = num_groups
    if dense_m is not None:
        q = torch.matmul(occupancy.reshape(-1).to(torch.float32), dense_m)
        q = q[:G * 5].to(torch.int32).reshape(G, 5)
        return (q[:, NS_IN], q[:, NS_OUT], q[:, EW_IN], q[:, EW_OUT],
                q[:, 4] > 0)
    P = _prefix_planes(occupancy)
    lo, hi = ((gs.run_lo.long(), gs.run_hi.long()) if slab is None
              else (slab.maps["run_lo"], slab.maps["run_hi"]))
    cnt = P[hi] - P[lo]
    seg = torch.where(gs.run_seg >= 0, gs.run_seg, G * 5).long()
    # scatter_add, not index_add: vmap batches it in one op where each
    # world has its own runs (index_add's rule loops over the worlds)
    sums = torch.zeros((G * 5 + 1,), dtype=torch.int32,
                       device=occupancy.device).scatter_add(0, seg, cnt)
    q = sums[:G * 5]
    if slab is not None:
        q, = slab.all_sum([q])
    q = q.reshape(G, 5)
    return (q[:, NS_IN], q[:, NS_OUT], q[:, EW_IN], q[:, EW_OUT],
            q[:, 4] > 0)


def _apply_phase(state: LightsState, want, phase) -> LightsState:
    """Register the request unless it matches current or pending."""
    ok = want & (phase != state.current_phase) & (state.pending_phase == -1)
    return state.replace(pending_phase=torch.where(
        ok, phase, state.pending_phase).to(torch.int32))


def run_controllers(cfg: Config, grid: Grid, gs: GroupStatic,
                    state: LightsState, occupancy: torch.Tensor,
                    rl_phase_request=None, reductions=None) -> LightsState:
    """One control decision per group (only where no phase is pending).
    Under an RL algorithm, `rl_phase_request` is the controller's (want,
    phase) (`rl/controllers.py`)."""
    algo = cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM
    G = gs.valid.shape[0]
    dev = gs.valid.device
    active = gs.valid & (state.pending_phase == -1)

    if algo == "DISABLED":
        return state

    if algo == "FIXED_TIME":
        timer = torch.where(active, state.fixed_time_timer + 1,
                            state.fixed_time_timer)
        state = state.replace(fixed_time_timer=timer)
        state = _apply_phase(state, active & (timer == 1), state.ft_phase)
        flip = active & (timer >= cfg.TRAFFIC_LIGHT_GREEN_DURATION)
        return state.replace(
            ft_phase=torch.where(flip, 1 - state.ft_phase, state.ft_phase),
            fixed_time_timer=torch.where(flip, 0, state.fixed_time_timer))

    if reductions is None:
        reductions = group_reductions(grid, occupancy, G, gs)[:4]
    ns_in, ns_out, ew_in, ew_out = reductions

    if algo == "QUEUE_ACTUATED":
        timer = torch.where(active, state.queue_timer + 1, state.queue_timer)
        cur_is_ns = state.current_phase == 0
        cur_q = torch.where(cur_is_ns, ns_in, ew_in)
        opp_q = torch.where(cur_is_ns, ew_in, ns_in)
        first = active & (timer == 1)
        grew = active & (cur_q > state.last_arrival)
        last_arrival = torch.where(first | grew, cur_q, state.last_arrival)
        gap = torch.where(first, 0, torch.where(grew, 0, torch.where(
            active, state.gap_timer + 1, state.gap_timer)))
        switch = active & \
            (timer >= cfg.TRAFFIC_LIGHT_QUEUE_ACTUATED_MIN_GREEN) & (
                (gap >= cfg.TRAFFIC_LIGHT_QUEUE_ACTUATED_GAP) |
                (timer >= cfg.TRAFFIC_LIGHT_QUEUE_ACTUATED_MAX_GREEN) |
                ((opp_q > cur_q) & (cur_q == 0)))
        state = state.replace(queue_timer=torch.where(switch, 0, timer),
                              gap_timer=gap, last_arrival=last_arrival)
        return _apply_phase(state, switch, 1 - state.current_phase)

    if algo in ("PRESSURE_CONTROL", "NEIGHBOR_PRESSURE_CONTROL"):
        ns_p = (ns_in - ns_out).to(torch.float32)
        ew_p = (ew_in - ew_out).to(torch.float32)
        zf = torch.zeros((), dtype=torch.float32, device=dev)
        if algo == "NEIGHBOR_PRESSURE_CONTROL":
            for d in range(4):
                nb = gs.neighbor[:, d]
                has = nb >= 0
                nbs = torch.clamp(nb, 0, G - 1).long()
                if d in (0, 2):      # N, S
                    ns_p = ns_p - torch.where(has, state.ns_pressure[nbs], zf)
                else:                # E, W
                    ew_p = ew_p - torch.where(has, state.ew_pressure[nbs], zf)
        state = state.replace(
            ns_pressure=torch.where(active, ns_p, state.ns_pressure),
            ew_pressure=torch.where(active, ew_p, state.ew_pressure))
        return _apply_phase(state, active, torch.where(ns_p > ew_p, 0, 1))

    if algo == "NEIGHBOR_GREEN_WAVE":
        favor_ns = torch.zeros((G,), dtype=torch.bool, device=dev)
        favor_ew = torch.zeros((G,), dtype=torch.bool, device=dev)
        for d in range(4):
            nb = gs.neighbor[:, d]
            has = nb >= 0
            ph = state.current_phase[torch.clamp(nb, 0, G - 1).long()]
            if d in (0, 2):
                favor_ns = favor_ns | (has & (ph == 0))
            else:
                favor_ew = favor_ew | (has & (ph == 1))
        phase = torch.where(favor_ns & ~favor_ew, 0,
                            torch.where(favor_ew & ~favor_ns, 1,
                                        torch.where(ns_in > ew_in, 0, 1)))
        return _apply_phase(state, active, phase)

    if algo in RL_ALGOS:
        if rl_phase_request is None:
            raise ValueError(
                f"algorithm {algo} requires an RL controller; pass its "
                "phase request (see trafficsimulation_tpu_torch.rl)")
        want, phase = rl_phase_request
        return _apply_phase(state, active & want, phase)

    raise ValueError(f"unknown TRAFFIC_LIGHT_AGENT_ALGORITHM {algo!r}")


def execute_phase_change(cfg: Config, ls: LightStatic, gs: GroupStatic,
                         state: LightsState,
                         intersection_occupied: torch.Tensor) -> LightsState:
    """Phase commit with all-red transition and the clearance rule."""
    G = gs.valid.shape[0]
    has_pending = gs.valid & (state.pending_phase >= 0)

    in_transition = torch.zeros_like(has_pending)
    transition_timer = state.transition_timer
    if cfg.TRAFFIC_LIGHT_TRANSITION_DURATION_ENABLED:
        in_transition = has_pending & (transition_timer > 0)
        transition_timer = torch.where(in_transition, transition_timer - 1,
                                       transition_timer)
    blocked_clear = torch.zeros_like(has_pending)
    if cfg.TRAFFIC_LIGHT_TRANSITION_CLEARANCE_ENABLED:
        blocked_clear = has_pending & ~in_transition & intersection_occupied
    all_red = in_transition | blocked_clear
    commit = has_pending & ~all_red

    lg = torch.clamp(ls.group, 0, G - 1).long()
    l_has_group = ls.valid & (ls.group >= 0)
    l_all_red = l_has_group & all_red[lg]
    l_commit = l_has_group & commit[lg]
    commit_phase = state.pending_phase[lg]
    go = (ls.axis >= 0) & (ls.axis == commit_phase)
    stop = (ls.axis >= 0) & (ls.axis != commit_phase)
    light_stop = state.light_stop | l_all_red
    light_stop = light_stop & ~(l_commit & go)
    light_stop = light_stop | (l_commit & stop)
    return state.replace(
        transition_timer=transition_timer,
        current_phase=torch.where(commit, state.pending_phase,
                                  state.current_phase),
        pending_phase=torch.where(commit, -1, state.pending_phase),
        light_stop=light_stop)


def build_stop_map(grid: Grid, ls: LightStatic, state: LightsState,
                   dense_a: torch.Tensor = None, slab=None) -> torch.Tensor:
    """stop_map from per-light stop flags: each stopped run adds +1 / -1
    to a diff buffer and one cumsum per axis covers the run; cells owned
    by another light's run keep OR semantics through the extras.  With
    `dense_a`, one product light_stop @ A instead.  `slab`
    (`parallel/spatial.Slab`; the run tables only; `grid` the route
    window's): the route window's rows, the runs clipped to them
    (`Slab.prepare`)."""
    H, W = grid.cell_type.shape
    HW = H * W
    L = ls.valid.shape[0]
    dev = ls.valid.device
    if dense_a is not None:
        cnt = torch.matmul(state.light_stop.to(torch.bfloat16), dense_a)
        return (cnt > 0.5).reshape(H, W)
    NH = H * (W + 1)
    NV = (H + 1) * W

    srun_lo, srun_hi, sextra = ((ls.srun_lo, ls.srun_hi, ls.sextra_cell)
                                if slab is None else (
        slab.maps["srun_lo"], slab.maps["srun_hi"], slab.maps["sextra"]))
    stopped = (ls.srun_light >= 0) & \
        state.light_stop[torch.clamp(ls.srun_light, 0, L - 1).long()]
    one = stopped.to(torch.int32)
    sink = NH + NV
    diff = torch.zeros((NH + NV + 1,), dtype=torch.int32, device=dev)
    # scatter_add for vmap, as in `group_reductions` (exact in any order)
    diff = diff.scatter_add(0, torch.where(stopped, srun_lo, sink).long(),
                            one)
    diff = diff.scatter_add(0, torch.where(stopped, srun_hi, sink).long(),
                            -one)
    cov_h = torch.cumsum(diff[:NH].reshape(H, W + 1), 1,
                         dtype=torch.int32)[:, :W]
    cov_v = torch.cumsum(diff[NH:NH + NV].reshape(H + 1, W), 0,
                         dtype=torch.int32)[:H]
    stop = (cov_h + cov_v) > 0

    ex_ok = sextra >= 0
    ex_stop = ex_ok & state.light_stop[
        torch.clamp(ls.sextra_light, 0, L - 1).long()]
    extra = torch.zeros((HW + 1,), dtype=torch.int32,
                        device=dev).scatter_add(
        0, torch.where(ex_stop, sextra, HW).long(),
        ex_stop.to(torch.int32))
    return stop | (extra[:HW] > 0).reshape(H, W)


def apply_light_overrides(state: LightsState,
                          light_force: torch.Tensor) -> LightsState:
    """Host-bridge Go/Stop: -1 none, 0 force go, 1 force stop."""
    ls = state.light_stop & ~(light_force == 0)
    ls = ls | (light_force == 1)
    return state.replace(light_stop=ls)
