"""Policy networks of the RL light controllers (the JAX package's
`rl/nets.py`, flax modules there), as `torch.nn` modules with flax's
parameter names and layout.

A `Dense` kernel is stored [in, out] as flax stores it (`nn.Linear`
keeps [out, in]), so the state dict of a module here has the keys and
shapes of the flax params dict flattened with dots ("Dense_0.kernel",
"LayerNorm_0.scale", "GraphAttention_0.W.kernel", ...), and a flax
parameter tree carries across unchanged (`core/transfer.py`).

The controllers keep their parameters as such a dict of tensors in the
train state and call a module with them (`apply`), so a tick builds new
tensors and never updates a module in place.  The modules are built on
the meta device: their own parameters are never used.

`LayerNorm` is flax's: epsilon 1e-6 and the fast variance
max(0, E[x^2] - E[x]^2) (`F.layer_norm` uses 1e-5 and another variance).
`GraphAttention`'s leaky ReLU has slope 0.2 (torch's default is 0.01).

`init_params` draws the initial parameters: flax's initializers (LeCun
normal kernels, truncated at two standard deviations; zero biases;
LayerNorm scale 1, bias 0), but from a `torch.Generator` seeded from the
world's key, not from flax's per-module JAX keys, so the draws differ
from flax's.  A JAX world's trained or initial parameters carry across
through `core/transfer.py`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

# the standard deviation of a standard normal truncated to (-2, 2)
# (flax's `variance_scaling` constant)
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.empty(d_out)) if use_bias else None

    def forward(self, x):
        y = torch.matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


class LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class _Trunk(nn.Module):
    """`layers` Dense-ReLU layers then a LayerNorm (the shared body of
    `PolicyMLP` and `ActorCritic`)."""

    def __init__(self, d_in: int, hidden: int, layers: int):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"Dense_{i}", Dense(d_in if i == 0 else hidden,
                                                hidden))
        self.LayerNorm_0 = LayerNorm(hidden)

    def body(self, x):
        for i in range(self.layers):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return self.LayerNorm_0(x)


class PolicyMLP(_Trunk):
    """SRL_HIDDEN_LAYERS Dense-ReLU layers, LayerNorm, then `out`
    logits."""

    def __init__(self, d_in: int, hidden: int = 128, layers: int = 10,
                 out: int = 2):
        super().__init__(d_in, hidden, layers)
        self.add_module(f"Dense_{layers}", Dense(hidden, out))

    def forward(self, x):
        return getattr(self, f"Dense_{self.layers}")(self.body(x))


class ActorCritic(_Trunk):
    """The shared trunk, then policy logits and the state value."""

    def __init__(self, d_in: int, hidden: int = 256, layers: int = 10):
        super().__init__(d_in, hidden, layers)
        self.policy_logits = Dense(hidden, 2)
        self.state_value = Dense(hidden, 1)

    def forward(self, x):
        x = self.body(x)
        return self.policy_logits(x), self.state_value(x)[..., 0]


class GraphAttention(nn.Module):
    """Single-head star-graph attention: the center node (index 0)
    attends over itself and its neighbours."""

    def __init__(self, d_in: int, out_dim: int = 16):
        super().__init__()
        self.W = Dense(d_in, out_dim, use_bias=False)
        self.attn = Dense(2 * out_dim, 1, use_bias=False)

    def forward(self, feats, mask):
        # feats [B, N, F]; mask [B, N]
        wf = self.W(feats)
        cat = torch.cat([wf[:, 0:1, :].expand_as(wf), wf], dim=-1)
        e = F.leaky_relu(self.attn(cat)[..., 0], negative_slope=0.2)
        e = e + (1.0 - mask) * -1e9
        alpha = torch.softmax(e, dim=1)[..., None]
        return torch.sum(alpha * wf, dim=1)


class GATQNet(nn.Module):
    def __init__(self, d_in: int = 9, gat_dim: int = 16, hidden: int = 32,
                 actions: int = 2):
        super().__init__()
        self.GraphAttention_0 = GraphAttention(d_in, gat_dim)
        self.Dense_0 = Dense(gat_dim, hidden)
        self.Dense_1 = Dense(hidden, hidden)
        self.Dense_2 = Dense(hidden, actions)

    def forward(self, feats, mask):
        x = torch.relu(self.GraphAttention_0(feats, mask))
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


@functools.cache
def build(kind: str, *args) -> nn.Module:
    """The module of a controller family ("policy", "actor_critic" or
    "gat") with its constructor arguments, on the meta device (one per
    shape, shared by every caller: it holds no state of its own)."""
    cls = {"policy": PolicyMLP, "actor_critic": ActorCritic,
           "gat": GATQNet}[kind]
    with torch.device("meta"):
        return cls(*args)


def apply(net: nn.Module, params: dict, *args):
    """`net(*args)` with the parameter tensors `params` (flax's names)."""
    return torch.func.functional_call(net, params, args)


def init_params(net: nn.Module, key, device) -> dict:
    """Initial parameters of `net` by flax's initializers, drawn from a
    `torch.Generator` seeded from `key` (uint32 [2]) in the order of the
    module's parameters, on `device`."""
    k = np.asarray(key, np.uint32).reshape(2)
    gen = torch.Generator().manual_seed((int(k[0]) << 32) | int(k[1]))
    out = {}
    for name, p in net.named_parameters():
        leaf = name.rsplit(".", 1)[1]
        if leaf == "kernel":
            std = float(np.sqrt(1.0 / p.shape[0]) / _TRUNC_STD)
            t = torch.empty(p.shape)
            nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t = t * std
        elif leaf == "scale":
            t = torch.ones(p.shape)
        else:
            t = torch.zeros(p.shape)
        out[name] = t.to(device)
    return out
