"""The check refuses a broken timed path and the control: the harness's
run, with the look for a chip skipped, at a size a CPU test holds (a
64x64 configuration, small batches, short horizons), first as it is
(correct), then with the program's chunk runner broken underneath, then
with the reference in a lower precision put in the program's place.
The limits are the cells' own."""

import pytest

from tsim_bench import harness
from tsim_bench.common import PROGRAM, Pkg, load

SMALL = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
             MAX_FIELD_DESTS=32, MAX_VEHICLES=256)
CASES = {
    "sweep64x1024.tick": ("run_chunk_batch", dict(horizon=4, chunk=2),
                          [{"step": "init_world_batch", "n_worlds": 4}]),
    "headline256.b40-mega": ("run_batch_shared",
                             dict(horizon=10, chunk=5, batch=4),
                             [{"step": "init_world"},
                              {"step": "measure_and_shrink"},
                              {"step": "inject_vehicles", "n": 150}]),
}


def small(name):
    entry, cell_over, steps = CASES[name]
    cell = load("cells", name)
    cell.update(cell_over, check={"worlds": 2})
    cfgj = load("configs", cell["config"])
    cfgj.update(config=SMALL, steps=steps)
    return entry, cell, cfgj


def go(monkeypatch, name, control=None):
    entry, cell, cfgj = small(name)
    monkeypatch.delenv("TSIM_MEGA_FORCE", raising=False)
    monkeypatch.delenv("TSIM_NO_MEGAKERNEL", raising=False)
    if "TSIM_MEGA_FORCE" in cell["path"]["env"]:
        monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    else:
        monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    return harness.run(name, 2**31 + 77, 0.0, False, "cpu", cell=cell,
                       cfgj=cfgj, pin=False, control=control)


def unchanged(real):
    return lambda cfg, batch, n, *a, **k: batch


def half_left_out(real):
    """The second half of the batch's worlds come back as they went in."""
    prog = Pkg(PROGRAM)

    def fn(cfg, batch, n, *a, **k):
        out = real(cfg, batch, n, *a, **k)
        lo = prog.transfer.world_leaves(out)
        li = prog.transfer.world_leaves(batch)
        B = int(batch.key.shape[0])
        for p, t in lo.items():
            if t.dim() and t.shape[0] == B and li[p].shape == t.shape:
                t = t.clone()
                t[B // 2:] = li[p][B // 2:]
                lo[p] = t
        return prog.transfer.world_from_leaves(lo)
    return fn


def altered(real):
    """One answer of every world altered where the chunk produces it: its
    first vehicle's stuck-tick count."""
    prog = Pkg(PROGRAM)

    def fn(cfg, batch, n, *a, **k):
        out = real(cfg, batch, n, *a, **k)
        v = out.vehicles
        st = v.stuck_ticks.clone()
        st[:, 0] += 1
        return out.replace(vehicles=v.replace(stuck_ticks=st))
    return fn


@pytest.mark.parametrize("name", sorted(CASES))
def test_sound_run_is_correct(monkeypatch, name):
    out = go(monkeypatch, name)
    assert out["correct"], out["checks"]
    assert list(out)[-3] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("name", sorted(CASES))
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    entry = CASES[name][0]
    mesh = Pkg(PROGRAM).mesh
    monkeypatch.setattr(mesh, entry, fault(getattr(mesh, entry)))
    out = go(monkeypatch, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_control_is_not_correct(monkeypatch, name):
    """The reference in bfloat16 in the program's place (its carried f32
    state stored in bf16 at every chunk's end) fails the cell's limits,
    where the program passes them."""
    out = go(monkeypatch, name, control="bf16")
    assert out["correct"], out["checks"]
    r = out["_control"]
    limits = load("cells", name)["limits"]
    assert any(r[k] > limits[k] for k in limits), r
