"""Near ties of the RL controllers' actions, counted for parity checks.

A categorical draw (REINFORCE, A2C: the logits plus Gumbel noise) or
GAT-DQN's greedy action is the argmax of two scores a group.  Where the
two lie closer than a rounding of the nets' products can move them, a
run whose products sum in another order (a batched matrix product, a
library's other algorithm) may take the other action, and its integer
state then parts from the reference's.  `TieSpy` stands in for `torch`
in `rl/controllers.py` (`spying`) and keeps every argmax's gaps, so that
a check can tell such a tie from a fault.  It syncs the device once a
call: for correctness runs, not for timed ones.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import labels
from . import controllers

TIE = 1e-4          # two scores of a group closer than this: a near tie


class TieSpy:
    """`torch` as the controllers see it, with `argmax` keeping, for
    each call (a tick), the gap between the two scores of every group of
    every world ([n_worlds, G] a call; A2C keeps the actions of padded
    groups too)."""

    def __init__(self, n_worlds: int = 1):
        self.n, self.gaps = n_worlds, []

    def __getattr__(self, name):
        return getattr(torch, name)

    def argmax(self, x, dim=None):
        w = labels._whole(x).detach()
        self.gaps.append((w[..., 0] - w[..., 1]).abs().reshape(
            self.n, -1).cpu().numpy())
        return torch.argmax(x, dim=dim)

    def ties(self, cfg, plan, tie: float = TIE) -> np.ndarray:
        """Per world, the near ties (gap < tie) among the scores that
        chose an action, over the ticks of `plan` (the plan of the run
        spied on): for GAT-DQN those of the groups that did not explore
        (their uniform at or above epsilon, which starts at EPS_INITIAL
        and falls by EPS_DECAY_RATE a tick in f32)."""
        gaps = np.stack(self.gaps, 1)                   # [B, ticks, G]
        if cfg.TRAFFIC_LIGHT_AGENT_ALGORITHM in controllers.GAT_ALGOS:
            f32, eps, e = np.float32, [], np.float32(cfg.EPS_INITIAL)
            for _ in range(gaps.shape[1]):
                eps.append(e)
                e = max(f32(e - f32(cfg.EPS_DECAY_RATE)), f32(cfg.EPS_MIN))
            u = plan.tensors["explore_u"].cpu().numpy().reshape(
                self.n, -1, gaps.shape[-1])[:, :gaps.shape[1]]
            gaps = np.where(u >= np.array(eps, f32)[:, None], gaps, np.inf)
        return (gaps < tie).sum((1, 2))


@contextlib.contextmanager
def spying(n_worlds: int = 1):
    """A `TieSpy` in the controllers for the block's runs."""
    spy = TieSpy(n_worlds)
    controllers.torch = spy
    try:
        yield spy
    finally:
        controllers.torch = torch
