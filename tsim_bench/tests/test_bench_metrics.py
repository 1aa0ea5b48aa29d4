"""The per-layer readers on canned profiler events, the byte counters
against `chip_smoke.py`'s, and the K9 byte count from the reference
against the program's own K9 inputs (CPU, the megakernel's plain
version)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tsim_bench import costs
from tsim_bench.common import PROGRAM, REFERENCE, Pkg, config_values, module
from tsim_bench.devtrace import Trace, kernel_base

K1 = "void dm_worlds<GridSelect>(DMParams, Inputs, Outputs, int*, int, Sel)"
EW = "void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)"
CP = "Memcpy DtoH (Device -> Pinned)"
K5 = "void sdir_batched_kernel(int const*, int const*, int, int)"
K3 = "void wf_tiled(unsigned char const*, unsigned char const*, int)"
K9 = "void mega_kernel<(K9Form)1>(MegaParams, MegaArgs, int)"


def canned(extra=None):
    device = [(K1, 100, 50), (EW, 120, 40), (CP, 300, 10), (K5, 400, 20),
              (K3, 500, 30), (K9, 600, 100), (K1, 800, 70)]
    host = [("tsim_bench.chunk", 0, 1000), ("aten::add", 150, 100),
            ("cudaLaunchKernel", 160, 5), ("aten::nonzero", 700, 90),
            ("cudaStreamSynchronize", 710, 80)]
    return Trace(device, host, 0, 1000, ticks=2, worlds=3,
                 extra=extra or {})


def test_kernel_base():
    assert kernel_base(K1) == "dm_worlds"
    assert kernel_base(K9) == "mega_kernel"
    assert kernel_base(EW) == "vectorized_elementwise_kernel"
    assert kernel_base(CP) == "Memcpy DtoH"


def test_readers_on_canned_events():
    t = canned()
    read = {m: module("metrics", m).read for m in (
        "launches_per_tick", "device_idle_share", "torch_op_ms_per_tick",
        "routing_ms_per_tick")}
    assert read["launches_per_tick"](t) == 7 / 2
    # busy: [100, 160], [300, 310], [400, 420], [500, 530], [600, 700],
    # [800, 870]
    assert t.busy_s == pytest.approx(290e-9)
    assert read["device_idle_share"](t) == pytest.approx(100 * (1 - 0.29))
    assert read["torch_op_ms_per_tick"](t) == pytest.approx(50 / 1e6 / 2)
    assert read["routing_ms_per_tick"](t) == pytest.approx(50 / 1e6 / 2)
    empty = Trace([], [], 0, 1000, 2, 3)
    for fn in read.values():
        assert fn(empty) is None
    for m in ("k1_roofline_share", "k9_roofline_share"):
        assert module("metrics", m).read(empty) is None


def test_breakdown():
    b = canned().breakdown()
    assert b["device_ops"][0] == ["dm_worlds", pytest.approx(120e-9)]
    gaps = dict(b["idle_gaps"])
    # the gap [700, 800] lies in aten::nonzero's synchronise
    assert gaps["aten::nonzero"] == pytest.approx(100e-9)
    assert gaps["aten::add"] == pytest.approx(140e-9)
    assert gaps["tsim_bench.chunk"] == pytest.approx(
        (100 + 90 + 80 + 70 + 130) * 1e-9)
    assert sum(gaps.values()) == pytest.approx(1e-6 - 290e-9)


def test_k1_share_counts_the_state():
    vm = torch.full((3, 8, 8), -1, dtype=torch.int32)
    vm[0, 1, 1] = vm[1, 2, 2] = vm[2, 3, 3] = 0
    end = vm.clone()
    end[0, 4, 4] = 1
    cfg = SimpleNamespace(VEHICLE_MAX_SPEED=5)
    t = canned({"states": [(SimpleNamespace(veh_map=vm),
                            SimpleNamespace(veh_map=end))], "cfg": cfg})
    nbytes = costs.k1_cost(((vm >= 0).int(),), cfg)[0]
    assert nbytes == 3 * 64 * 52 + 3 * (23 + 5 + 4)
    share = module("metrics", "k1_roofline_share").read(t)
    assert share == pytest.approx(100 * nbytes / costs.PEAK_BYTES / 60e-9)


def test_costs_are_chip_smokes():
    import chip_smoke
    g = torch.Generator().manual_seed(5)
    planes = torch.randint(0, 1 << 30, (4, 16, 24), generator=g,
                           dtype=torch.int32)
    kcfg = SimpleNamespace(VEHICLE_MAX_SPEED=5)
    for shared in (False, True):
        assert costs.k1_cost((planes,), kcfg, shared) == \
            chip_smoke.k1_cost((planes,), kcfg, shared)
    H, W, R, B = 6, 7, 5, 3
    a = {n: torch.randint(-2, 3, (B, H, W), generator=g, dtype=torch.int32)
         for n in costs.MEGA_STATE + costs.MEGA_BLOCK
         + ("b_mask", "wnd", "g_destid")}
    a.update(ticks=torch.zeros(B, R, 8, dtype=torch.int32),
             spawn_pe=torch.randint(-1, 2, (B, R, H, W), generator=g),
             rain=torch.zeros(B, R, H, W, dtype=torch.bool),
             inter=torch.zeros(H, W, dtype=torch.bool))
    for n in costs.MEGA_TABLES:
        a.setdefault(n, torch.zeros(4, 3, dtype=torch.int32))
    got = {"pa": a["pa"].roll(1, -1), "stats": torch.zeros(B, R, 9)}
    batched = ("pa", "wnd", "rain", "spawn_pe")
    assert costs.mega_cost(a, got, batched) == \
        chip_smoke.mega_cost(a, got, batched)
    assert costs.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_k9_bytes_from_the_reference_are_the_programs(monkeypatch):
    """K9's inputs that the reference builds from one world of the
    program's chunk start state are that world's part of those the
    program hands its batched K9 wrapper; an input the reader counts
    once a world is one the program batches; the count is that of
    `mega_cost` on them."""
    monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    prog, ref = Pkg(PROGRAM), Pkg(REFERENCE)
    roll = module("rollouts", "shared")
    cfg = prog.make_config(dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6,
                                SIDEWALK_RING_WIDTH=2, MAX_FIELD_DESTS=32,
                                MAX_VEHICLES=256))
    w = prog.sim.init_world(cfg, prog.prng.PRNGKey(11), "cpu")
    w = prog.sim.inject_vehicles(cfg, w, 120)
    keys = np.arange(6, dtype=np.uint32).reshape(3, 2)
    start = roll.begin(prog, cfg, w, keys)
    seen = []
    real = prog.HE.mega_segment_batched

    def spy(cfg_, a, B, batched, form=None):
        out = real(cfg_, a, B, batched, form)
        if not seen:
            seen.append((a, frozenset(batched)))
        return out
    monkeypatch.setattr(prog.HE, "mega_segment_batched", spy)
    end = roll.chunk(prog, cfg, start, 10)
    monkeypatch.setattr(prog.HE, "mega_segment_batched", real)
    a, batched = seen[0]
    m = module("metrics", "k9_roofline_share")
    t = canned({"states": [(start, end)], "pkg": prog, "ref": ref,
                "cfg_values": config_values(cfg), "rollout": roll})
    _, a0 = m.world_inputs(t, start, 0)
    _, a1 = m.world_inputs(t, start, 1)
    assert set(a0) == set(a)
    for k, v in a.items():
        assert torch.equal(a0[k], v[0] if k in batched else v), k
        if not torch.equal(a0[k], a1[k]):
            assert k in batched, k
    nb = m.segment_bytes(t, start, end)
    assert 0 < nb <= costs.mega_cost(
        dict(a, pa=(start.veh_map >= 0).to(torch.int32)),
        {k: v.expand(3, *v.shape) for k, v in
         ref.megakernel.segment_plain(ref.make_config(config_values(cfg)),
                                      a0).items()}
        | {"pa": (end.veh_map >= 0).to(torch.int32)}, batched | {"pa"})
    assert m.read(t) == pytest.approx(100 * nb / costs.PEAK_BYTES / 100e-9)
