"""The frozen reference against the port's plain path, on a 64x64 city
on the CPU: the generated world, the shrunk and injected world, and a
few ticks of the per-tick path and of the megakernel path (its plain
K9), leaf for leaf; and a batch of the port's cities against the
reference's worlds one at a time.  The test imports the port; the
reference does not."""

import numpy as np
import pytest

from tsim_bench.common import PROGRAM, REFERENCE, Pkg, config_values

SMALL = dict(WIDTH=64, HEIGHT=64, WALL_THICKNESS=6, SIDEWALK_RING_WIDTH=2,
             MAX_FIELD_DESTS=32, MAX_VEHICLES=256)


def same(pa, wa, pb, wb):
    la = pa.transfer.world_leaves(wa)
    lb = pb.transfer.world_leaves(wb)
    assert set(la) == set(lb)
    for k in la:
        assert np.array_equal(la[k].numpy(), lb[k].numpy(),
                              equal_nan=la[k].dtype.is_floating_point), k


@pytest.mark.parametrize("mega", [False, True])
def test_reference_is_the_plain_path(monkeypatch, mega):
    if mega:
        monkeypatch.setenv("TSIM_MEGA_INTERPRET", "1")
    else:
        monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    out = []
    for pkg in (Pkg(PROGRAM), Pkg(REFERENCE)):
        cfg = pkg.make_config(SMALL)
        w = pkg.sim.init_world(cfg, pkg.prng.PRNGKey(2**31 + 9), "cpu")
        w0 = w
        cfg, w = pkg.sim.measure_and_shrink(cfg, w)
        w = pkg.sim.inject_vehicles(cfg, w, 150)
        end = pkg.sim.run_chunk(cfg, w, 7)
        out.append((pkg, cfg, w0, w, end))
    (p, pc, *pw), (r, rc, *rw) = out
    assert config_values(pc) == config_values(rc)
    for a, b in zip(pw, rw):
        same(p, a, r, b)


def test_reference_worlds_are_the_programs_batch(monkeypatch):
    """World b of the port's batch of cities, at the start and after a
    chunk, is the reference's world from key b alone."""
    monkeypatch.setenv("TSIM_NO_MEGAKERNEL", "1")
    p, r = Pkg(PROGRAM), Pkg(REFERENCE)
    cfg = p.make_config(SMALL)
    w = p.mesh.init_world_batch(cfg, p.prng.PRNGKey(5), 3, device="cpu")
    end = p.mesh.run_chunk_batch(cfg, w, 5)
    rcfg = r.make_config(SMALL)
    for b, key in enumerate(r.prng.split(r.prng.PRNGKey(5), 3)):
        rw = r.sim.init_world(rcfg, key, "cpu")
        same(p, p.mesh.world_at(w, b), r, rw)
        same(p, p.mesh.world_at(end, b), r, r.sim.run_chunk(rcfg, rw, 5))
