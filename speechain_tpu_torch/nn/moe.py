"""Switch-style mixture-of-experts feed-forward (counterpart of
``speechain_tpu/nn/moe.py``, :33-104).

Each token goes to its top-1 expert (Switch Transformer):

- capacity ``cap = min(max(8, ceil8(ceil(S * capacity_factor / E))), S)``
  over all S = B * T tokens, padding included, as the reference's static
  capacity;
- the router is a float32 Dense on x in float32; softmax, then argmax,
  gives the route and the top probability is the gate;
- slots go by order over the flattened tokens, first come first served;
  a token past its expert's capacity outputs 0 (the residual carries it);
- the load-balancing loss ``aux_loss_weight * E * sum_e f_e P_e``, with
  f_e the share of tokens routed to e BEFORE the capacity drop and P_e the
  mean router probability;
- the expert products and bias adds in the compute dtype, dropout on the
  hidden h, and the gate rounded to the compute dtype before it scales
  the expert output (``combine.astype(self.dtype)``, :101-103);
- the activation is ``getattr(flax.linen, name.lower())``: for "GELU" the
  tanh-approximate GELU, unlike the dense FFN's exact one.

The reference dispatches and combines with one-hot einsums over an (S,
E, cap) tensor; each of its sums has one nonzero term, so an index
gather and a scaled gather give the same values in float32 and bf16
without that tensor (25.2 M entries a layer at the 960-bpe5k recipe's
step). The gathers are ``index_select``s, whose backward adds each row's
gradient once (atomics meet only on the empty slot's row, which is
discarded), where advanced indexing's backward sorts its indices. The
expert products run in ``torch.bmm``: the reference computes them outside
any Pallas kernel.

The loss is handed to the innermost :func:`collect_losses` block, which
the training steps open around one forward; outside such a block (a
decode step, evaluation) it is dropped.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch
import torch.nn.functional as F
from torch import nn

from speechain_tpu_torch.nn.dense import Dense
from speechain_tpu_torch.ops.dropout import dropout

# getattr(flax.linen, name.lower()) for the names flax resolves
ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "softplus": F.softplus,
}

_COLLECTORS: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def collect_losses() -> Iterator[List[torch.Tensor]]:
    """Collect the auxiliary losses of every :class:`SwitchFFN` forward
    inside the block into the yielded list (the reference's sown
    ``losses`` collection)."""
    losses: List[torch.Tensor] = []
    _COLLECTORS.append(losses)
    try:
        yield losses
    finally:
        _COLLECTORS.pop()


def capacity(S: int, num_experts: int, capacity_factor: float) -> int:
    """The reference's static per-expert capacity (:48-50)."""
    cap = int(-(-S * capacity_factor // num_experts))
    cap = max(8, -(-cap // 8) * 8)
    return min(cap, S)


def queue_positions(expert: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each token's 1-based position in its expert's queue, in token
    order: running counts along the tokens, one row an expert (a scan
    along the contiguous axis)."""
    counts = F.one_hot(expert, num_experts).t().contiguous().cumsum(1)
    return counts.gather(0, expert[None])[0]


def route(probs: torch.Tensor, cap: int):
    """Top-1 routes of (S, E) router probabilities: (expert (S,), gate
    (S,), the token's position in its expert's queue (S,), kept (S,)
    bool: position <= cap)."""
    gate, expert = probs.max(-1)
    pos = queue_positions(expert, probs.shape[-1])
    return expert, gate, pos, pos <= cap


class SwitchFFN(nn.Module):
    """Parameters: ``router`` (a float32 Dense), ``expert_wi`` (E, D, F),
    ``expert_bi`` (E, 1, F), ``expert_wo`` (E, F, D), ``expert_bo`` (E,
    1, D), in the compute dtype unless the network keeps float32 master
    weights (cast at use)."""

    def __init__(self, d_model: int, fdfwd_dim: int, num_experts: int = 4,
                 capacity_factor: float = 1.25,
                 fdfwd_activation: str = "GELU", dropout: float = 0.1,
                 aux_loss_weight: float = 1e-2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fdfwd_activation.lower() not in ACTIVATIONS:
            raise KeyError(f"unknown MoE activation {fdfwd_activation!r}; "
                           f"known: {sorted(ACTIVATIONS)}")
        E, D, Fd = num_experts, d_model, fdfwd_dim
        self.num_experts, self.capacity_factor = E, capacity_factor
        self.activation = ACTIVATIONS[fdfwd_activation.lower()]
        self.dropout = dropout
        self.aux_loss_weight = aux_loss_weight
        self.dtype = dtype
        self.router = Dense(D, E, dtype=torch.float32)
        self.expert_wi = nn.Parameter(torch.zeros(E, D, Fd, dtype=dtype))
        self.expert_bi = nn.Parameter(torch.zeros(E, 1, Fd, dtype=dtype))
        self.expert_wo = nn.Parameter(torch.zeros(E, Fd, D, dtype=dtype))
        self.expert_bo = nn.Parameter(torch.zeros(E, 1, D, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        E, cd = self.num_experts, self.dtype
        S = B * T
        cap = capacity(S, E, self.capacity_factor)
        probs = torch.softmax(self.router(x.float()), -1).reshape(S, E)
        expert, gate, pos, keep = route(probs, cap)
        if _COLLECTORS:
            f = F.one_hot(expert, E).float().mean(0)
            aux = E * (f * probs.mean(0)).sum()
            _COLLECTORS[-1].append(self.aux_loss_weight * aux)

        # slot e * cap + pos - 1 of a kept token; E * cap is an empty slot
        empty = E * cap
        slot = torch.where(keep, expert * cap + pos - 1,
                           torch.full_like(expert, empty))
        token = torch.full((empty + 1,), S, dtype=torch.int64,
                           device=x.device)
        token.scatter_(0, slot, torch.arange(S, device=x.device))
        flat = torch.cat([x.reshape(S, D).to(cd), x.new_zeros(1, D, dtype=cd)])
        expert_in = flat.index_select(0, token[:empty]).reshape(E, cap, D)

        h = torch.bmm(expert_in, self.expert_wi.to(cd)) + \
            self.expert_bi.to(cd)
        h = dropout(self.activation(h), self.dropout, self.training)
        out = torch.bmm(h, self.expert_wo.to(cd)) + self.expert_bo.to(cd)
        out = torch.cat([out.reshape(empty, D), out.new_zeros(1, D)])
        return (out.index_select(0, slot) * gate.to(cd)[:, None]).reshape(
            B, T, D)
