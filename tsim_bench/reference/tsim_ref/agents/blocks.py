# Frozen copy of trafficsimulation_tpu_torch/agents/blocks.py at commit 20130c3 (the plain
# reference of the benchmark; tsim_ref/__init__.py says what was kept).
"""City-block food/waste tanks (the JAX package's `agents/blocks.py`):
gradual mode carries a fractional per-tick rate and applies whole units;
burst mode consumes/produces `inner_count` units every
FOOD_CONSUMPTION_TICKS / WASTE_PRODUCTION_TICKS ticks.

XLA rewrites an f32 division by a constant into a multiply by the f32
reciprocal; the rates are computed that way here, so the fractional
carries match the JAX package bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config

from ..core.state import BlocksState, BlockStatic


def init_blocks_state(bs: BlockStatic) -> BlocksState:
    z = torch.zeros_like(bs.food_cap)
    return BlocksState(food=torch.where(bs.valid, bs.food_cap, z),
                       waste=torch.zeros_like(bs.waste_cap),
                       food_rem=z.clone(), waste_rem=z.clone())


def step_blocks(cfg: Config, bs: BlockStatic, st: BlocksState,
                tick) -> BlocksState:
    inner = bs.inner_count.to(torch.float32)
    z = torch.zeros((), dtype=torch.float32, device=inner.device)
    if cfg.GRADUAL_CITY_BLOCK_RESOURCES:
        frate = inner * float(np.float32(1.0 / cfg.FOOD_CONSUMPTION_TICKS))
        wrate = inner * float(np.float32(1.0 / cfg.WASTE_PRODUCTION_TICKS))
        frem = st.food_rem + torch.where(bs.needs_food, frate, z)
        fwhole = torch.floor(frem)
        food = torch.clamp(st.food - fwhole, min=0.0)
        frem = frem - fwhole
        wrem = st.waste_rem + torch.where(bs.produces_waste, wrate, z)
        wwhole = torch.floor(wrem)
        waste = torch.minimum(st.waste + wwhole, bs.waste_cap)
        wrem = wrem - wwhole
        return BlocksState(food=food, waste=waste, food_rem=frem,
                           waste_rem=wrem)
    fdue = (tick % cfg.FOOD_CONSUMPTION_TICKS) == 0
    wdue = (tick % cfg.WASTE_PRODUCTION_TICKS) == 0
    food = torch.where(bs.needs_food & fdue,
                       torch.clamp(st.food - inner, min=0.0), st.food)
    waste = torch.where(bs.produces_waste & wdue,
                        torch.minimum(st.waste + inner, bs.waste_cap),
                        st.waste)
    return st.replace(food=food, waste=waste)


def food_shortage(bs: BlockStatic, st: BlocksState) -> torch.Tensor:
    return torch.where(bs.valid & bs.needs_food, bs.food_cap - st.food,
                       -1.0)


def waste_surplus(bs: BlockStatic, st: BlocksState) -> torch.Tensor:
    return torch.where(bs.valid & bs.produces_waste, st.waste, -1.0)
