"""Start the ranks of a sharded run: one process a GPU under
`torch.distributed` (the JAX package is single-controller and has no
counterpart).

`spawn(fn, n_ranks, backend, device=None, args=())` starts n_ranks
processes with the spawn start method (never a fork, so the parent may
hold a CUDA context), joins them in a process group whose rendezvous is
a `file://` store in a fresh temporary directory (parallel callers never
race for a TCP port), gives each its `parallel.mesh.Mesh` and runs
`fn(mesh, *args)`; it returns each rank's result in rank order.  `fn`
must be importable by the children: a function of this package, never
of a script's `__main__`.  An exception in any rank fails the spawn:
torch's spawn terminates the other ranks and raises in the caller.

`backend` is explicit: "gloo" (CPU tensors, and CUDA tensors for
`all_reduce` and `broadcast`, which is all the mesh's collectives send
on the card) or "nccl", which needs a GPU of its own for every rank
(NCCL refuses two ranks on one GPU).  Nothing switches backend by
itself.  On the card the parent builds the kernel library
(`ops/build.load`) before spawning, so that the ranks only load it.

On a host with several GPUs, rank r runs on `cuda:r`:

    from trafficsimulation_tpu_torch.parallel import launch, ranks
    out = launch.spawn(ranks.run_jobs, torch.cuda.device_count(), "nccl",
                       args=(jobs,))
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def check_backend(backend: str, n_ranks: int, device, n_gpus: int) -> None:
    """Refuse a backend that cannot run these ranks: an unknown one, or
    "nccl" on the CPU or with more ranks than GPUs."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if n_ranks < 1:
        raise ValueError(f"{n_ranks} ranks")
    if backend != "nccl":
        return
    if device is not None and torch.device(device).type == "cpu":
        raise ValueError("backend 'nccl' runs on GPUs only: pass 'gloo' for "
                         "ranks on the CPU")
    if n_ranks > n_gpus:
        raise ValueError(f"{n_ranks} ranks on {n_gpus} GPU(s) with backend "
                         "'nccl': NCCL refuses two ranks on one GPU; pass "
                         "backend='gloo' to share a GPU between ranks")


def _rank_main(rank: int, fn, n_ranks: int, backend: str, device,
               store_dir: str, args: tuple, threads: int,
               timeout_s: float) -> None:
    torch.set_num_threads(threads)
    os.environ["LOCAL_RANK"] = str(rank)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(store_dir, 'store')}",
        world_size=n_ranks, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        from .mesh import make_mesh
        out = fn(make_mesh(device=device), *args)
        with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, backend: str, device=None, args: tuple = (),
          threads: int | None = None, timeout_s: float = 600.0) -> list:
    """Run `fn(mesh, *args)` in n_ranks new processes joined in one
    process group (see the module docstring); their results in rank
    order.  `device`: "cpu", or None / "cuda" for `cuda:{rank % GPUs}`.
    `threads`: torch's CPU threads a rank (by default the host's cores
    shared out).  `timeout_s`: how long a collective may wait."""
    cuda = torch.cuda.is_available()
    check_backend(backend, n_ranks, device,
                  torch.cuda.device_count() if cuda else 0)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not cuda:
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the ranks on the CPU")
        from ..ops import build
        build.load()
    threads = threads or max(1, (os.cpu_count() or 1) // n_ranks)
    with tempfile.TemporaryDirectory(prefix="tsim_ranks_") as tmp:
        mp.start_processes(_rank_main, nprocs=n_ranks, join=True,
                           start_method="spawn",
                           args=(fn, n_ranks, backend, device, tmp,
                                 tuple(args), threads, timeout_s))
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
