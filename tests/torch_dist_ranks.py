"""The rank body of `test_torch_dist.py`'s demand-window guard test, for
`parallel/launch.spawn` (its children import it from this directory,
which spawn puts on their `sys.path`)."""

import torch.distributed as dist

from trafficsimulation_tpu_torch import prng
from trafficsimulation_tpu_torch.config import Config
from trafficsimulation_tpu_torch.core import synth
from trafficsimulation_tpu_torch.parallel import mesh as M


def guard(mesh: M.Mesh, cfg: Config, n_worlds: int, shift: int) -> dict:
    """The demand-window guard over the group: the crossroad broadcast to
    the rank's worlds, rank r's `r * shift` ticks later.  A rollout that
    rank 0's worlds alone would cover but the last rank's would not must
    raise on every rank, after a check in the group's window passed: per
    rank its own coverage, the group's, and the error's text (None where
    it did not raise)."""
    w0 = synth.crossroad_world(cfg, device=mesh.device)
    keys = prng.split(prng.PRNGKey(0), n_worlds)[mesh.worlds(n_worlds)]
    batch = M.tile_world(w0, keys)
    batch = batch.replace(tick=batch.tick + mesh.rank * shift)
    rem = M.demand_ticks_remaining(w0) - (mesh.size - 1) * shift
    M.assert_demand_window(cfg, batch, rem, mesh)
    out = {"rank": mesh.rank, "local": M.demand_ticks_remaining(batch),
           "group": rem, "raised": None}
    try:
        M.run_batch(cfg, batch, rem + 1, mesh)
    except RuntimeError as e:
        out["raised"] = str(e)
    dist.barrier(group=mesh.group)
    return out
