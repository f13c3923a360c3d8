"""Dense MLP and Mixture-of-Experts — ``repro.models.moe`` on one
device.

MoE dispatch is the reference's token-choice top-k: router logits in
float32, ``top_k``, a softmax over the k gates, the ``(token, expert)``
pairs sorted by expert (stable, as ``jnp.argsort``), a grouped SwiGLU
over the sorted rows, each row against its own expert's weights, and
each token's k gated contributions summed in sorted-expert order in
the rows' dtype.

Where the reference calls ``lax.ragged_dot`` (XLA, not a Pallas
kernel), :func:`_expert_compute` runs ordinary torch ops on a static
layout: the sorted rows are scattered into one ``(E, capacity, d)``
buffer, a row to its expert's group, where ``capacity`` is the token
count (top-k picks an expert at most once a token, so no group is
larger and no row is dropped); one batched matmul per projection runs
every group against its expert; the rows are gathered back.  Padding
rows are zeros and stay out of the result.  Nothing sizes a tensor
from the routing on the host, so the step stays capturable in a CUDA
graph, and nothing adds with atomics, so the output is the same bits
on every run.  The price: every group is computed at full capacity, E/k
times the work of the rows in use, and a forward over T tokens holds
``E·T·(d + 3·moe_d_ff)`` activations (a prefill of 128 tokens at
deepseek-v2's widths: about 0.4 GB a layer).

The router and the expert stacks enter as weights, not matmuls: a
packed leaf is decoded on dispatch (``dense_weight``), the router in
float32, the experts straight into the rows' dtype (the bits of the
float32 decode, cast — what ``_expert_compute``'s casts give in the
reference).  The expert-parallel ``shard_map`` branches and the 2-D
decode sharding of the reference need a mesh and wait for ROADMAP
"A10, model half"; with no mesh the reference takes the local branch, as
the port does.
"""
from __future__ import annotations

import torch

from repro_torch.core.codr_linear import PackedLinear
from repro_torch.models.common import act_fn, dense_init, dense_weight, linear

__all__ = ["mlp_init", "mlp_forward", "moe_init", "moe_forward"]

# router logits + expert stacks consume raw weight arrays rather than a
# single matmul a backend could intercept — packed leaves are decoded
# once per forward (decode-on-dispatch)
_PACKABLE_KEYS = ("router", "w_experts_gate", "w_experts_in",
                  "w_experts_out")
_EXPERT_KEYS = _PACKABLE_KEYS[1:]


def _dense_moe_params(p, dtype):
    """The router decoded in float32 and the expert stacks in ``dtype``
    (plain tensors cast the same way)."""
    if not any(isinstance(p.get(k), PackedLinear) for k in _PACKABLE_KEYS):
        return p
    out = dict(p)
    out["router"] = dense_weight(p["router"], torch.float32)
    for k in _EXPERT_KEYS:
        out[k] = dense_weight(p[k], dtype)
    return out


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU-style gate/up/down or plain act(up)·down)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, lead: tuple = ()) -> dict:
    """SwiGLU-style gate/up/down (or plain act(up)·down) params; ``lead``
    stacks them (the layer stack)."""
    p = {"up_proj": dense_init(gen, d_model, d_ff, lead=lead)}
    if gated:
        p["gate_proj"] = dense_init(gen, d_model, d_ff, lead=lead)
    p["down_proj"] = dense_init(gen, d_ff, d_model, lead=lead)
    return p


def mlp_forward(p, x, act: str = "silu"):
    up = linear(x, p["up_proj"])
    if "gate_proj" in p:
        up = act_fn(act)(linear(x, p["gate_proj"])) * up
    else:
        up = act_fn(act)(up)
    return linear(up, p["down_proj"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, cfg, *, lead: tuple = ()) -> dict:
    """Router, ``(*lead, E, d, f)`` expert stacks and, with
    ``n_shared_experts``, one shared SwiGLU of width ``moe_d_ff ·
    n_shared_experts``."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, d, e, scale=0.02, lead=lead),
        "w_experts_gate": dense_init(gen, d, f, lead=lead + (e,)),
        "w_experts_in": dense_init(gen, d, f, lead=lead + (e,)),
        "w_experts_out": dense_init(gen, f, d, lead=lead + (e,)),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(gen, d, cfg.moe_d_ff * cfg.n_shared_experts,
                               lead=lead)
    return p


def _expert_compute(xs: torch.Tensor, expert: torch.Tensor,
                    slot: torch.Tensor, capacity: int, wg, wi, wo,
                    act: str) -> torch.Tensor:
    """Grouped SwiGLU over sorted rows: row ``r`` of ``xs`` (R, d) against
    expert ``expert[r]``'s weights (E, d, f), in ``xs``' dtype.  Row
    ``r`` sits at ``slot[r]`` of its expert's group in an ``(E,
    capacity, d)`` buffer."""
    e = wg.shape[0]
    buf = xs.new_zeros((e, capacity, xs.shape[-1]))
    buf[expert, slot] = xs
    h = act_fn(act)(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    return torch.bmm(h, wo)[expert, slot]


def _moe_local(x2d: torch.Tensor, p, cfg) -> torch.Tensor:
    """Token-choice top-k over every expert.  x2d (T, d) → (T, d) in
    ``x2d``'s dtype; ``p`` holds dense weights."""
    t = x2d.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = torch.matmul(x2d.to(torch.float32),
                          p["router"].to(torch.float32))
    gates, idx = torch.topk(logits, k, dim=-1)             # (T, k)
    gates = torch.softmax(gates, dim=-1)

    flat_idx = idx.reshape(-1)                             # (T*k,)
    order = torch.argsort(flat_idx, stable=True)
    token_of = order // k                                  # source token
    expert = flat_idx[order]                               # ascending
    xs = x2d[token_of]                                     # (T*k, d)
    experts = torch.arange(e, device=x2d.device)
    group_sizes = (flat_idx[:, None] == experts).sum(0)    # (E,)
    starts = torch.cumsum(group_sizes, 0) - group_sizes
    slot = torch.arange(t * k, device=x2d.device) - starts[expert]
    wg, wi, wo = (p[name].to(xs.dtype) for name in _EXPERT_KEYS)
    ys = _expert_compute(xs, expert, slot, t, wg, wi, wo, cfg.act)
    ys = ys * gates.reshape(-1)[order].to(ys.dtype)[:, None]
    # back to (token, choice) order, then each token's k rows summed in
    # the order the sort met them (ascending expert), one add at a time
    per_pair = torch.empty_like(ys)
    per_pair[order] = ys
    per_pair = per_pair.reshape(t, k, -1)
    by_expert = torch.argsort(idx, dim=-1, stable=True)
    per_pair = torch.gather(per_pair, 1, by_expert[..., None].expand(
        per_pair.shape))
    out = torch.zeros_like(per_pair[:, 0])
    for i in range(k):
        out = out + per_pair[:, i]
    return out


def moe_forward(p, x, cfg, mode: str = "train"):
    """x (B, S, d) → (B, S, d): routed experts plus the shared SwiGLU.
    ``mode`` is the reference's (it picks a sharded decode lane under a
    mesh); one device runs the local branch for every mode."""
    del mode
    p = _dense_moe_params(p, x.dtype)
    b, s, d = x.shape
    out = _moe_local(x.reshape(-1, d), p, cfg).reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        out = out + mlp_forward(p["shared"], x, cfg.act)
    return out
