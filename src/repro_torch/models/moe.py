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
reference).

Under a mesh context the reference's ``shard_map`` branches run on the
port's single-controller mesh, each position's compute on the device of
its expert blocks (:func:`repro_torch.sharding.rules.region`: views of a
:class:`~repro_torch.sharding.rules.ShardedTensor`'s blocks, or of a
whole stack):

* expert parallel (``model`` > 1, E divisible): model position j routes
  every token against its ``E/m`` experts at offset ``j·E/m``
  (:func:`_moe_local` with ``n_local``), and the partial outputs are
  summed in shard order — the reference's ``psum`` over ``model``;
* 2-D (decode with ``cfg.moe_decode_2d``, ``model`` and ``data`` > 1,
  E and ``moe_d_ff`` divisible): position (data i, model j) holds
  expert slice j and FFN slice i of every expert (``w_experts_{gate,in}``
  under ``P("model", None, "data")``, ``w_experts_out`` under
  ``P("model", "data", None)``) and computes its partial over all token
  rows (the reference's all-gather over ``data``); one sum over both
  axes, in position order, gives every row its output.

The combines' bytes are counted per device
(:func:`~repro_torch.sharding.rules.record_collective`).
"""
from __future__ import annotations

import torch

from repro_torch.core.codr_linear import PackedLinear
from repro_torch.models.common import act_fn, dense_init, dense_weight, linear
from repro_torch.sharding import rules
from repro_torch.sharding.rules import current_ctx

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


def _moe_local(x2d: torch.Tensor, p, cfg, n_local: int | None = None,
               expert_offset: int = 0) -> torch.Tensor:
    """Token-choice top-k against the ``n_local`` experts (default: all)
    starting at ``expert_offset``, whose stacks ``p`` holds (dense).
    x2d (T, d) → (T, d) partial output in ``x2d``'s dtype: a token's
    choices outside the slice contribute zero."""
    t = x2d.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    n_local = e if n_local is None else n_local
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
    if n_local == e:
        ys = _expert_compute(xs, expert, slot, t, wg, wi, wo, cfg.act)
    else:
        # rows of other slices go to a spare slot (t) of group 0, which
        # no row of the slice uses, and are zeroed after
        local = expert - expert_offset
        mine = (local >= 0) & (local < n_local)
        ys = _expert_compute(xs, torch.where(mine, local, 0),
                             torch.where(mine, slot, t), t + 1, wg, wi, wo,
                             cfg.act)
        ys = torch.where(mine[:, None], ys, torch.zeros_like(ys))
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


def _rows_per_device(ctx, rows: int) -> int:
    """Token rows one device holds: split over the batch axes where they
    divide, else all (replicated)."""
    return rows // rules.batch_split(ctx, rows)


def _sum_parts(parts, device) -> torch.Tensor:
    """The partial outputs summed in the order given, on ``device``."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = out + part.to(device)
    return out


def _moe_ep(p, x2d, cfg, ctx) -> torch.Tensor:
    """Expert parallel over ``model``: position j against its ``E/m``
    experts, every token row, then the sum over ``model``."""
    msize = ctx.axis_size("model")
    n_local = cfg.n_experts // msize
    parts = []
    for j in range(msize):
        es = slice(j * n_local, (j + 1) * n_local)
        pl = {k: rules.region(p[k], (es,)) for k in _EXPERT_KEYS}
        dev = pl["w_experts_gate"].device
        pl["router"] = p["router"].to(dev)
        parts.append(_moe_local(x2d.to(dev), pl, cfg, n_local, es.start))
    out = _sum_parts(parts, x2d.device)
    rules.record_collective("all-reduce", (_rows_per_device(
        ctx, x2d.shape[0]), x2d.shape[1]), out.dtype)
    return out


def _moe_2d(p, x2d, cfg, ctx) -> torch.Tensor:
    """Decode-time 2-D expert sharding: position (data i, model j) holds
    experts ``j·E/m …`` with FFN columns ``i·f/d …`` and computes its
    partial for every token row; one sum over (data, model)."""
    msize, dsize = ctx.axis_size("model"), ctx.axis_size("data")
    n_local = cfg.n_experts // msize
    f_local = cfg.moe_d_ff // dsize
    parts = []
    for pos in rules.positions(ctx, "data", "model"):
        es = slice(pos["model"] * n_local, (pos["model"] + 1) * n_local)
        fs = slice(pos["data"] * f_local, (pos["data"] + 1) * f_local)
        pl = {"w_experts_gate": rules.region(p["w_experts_gate"],
                                             (es, slice(None), fs)),
              "w_experts_in": rules.region(p["w_experts_in"],
                                           (es, slice(None), fs)),
              "w_experts_out": rules.region(p["w_experts_out"], (es, fs))}
        dev = pl["w_experts_gate"].device
        pl["router"] = p["router"].to(dev)
        parts.append(_moe_local(x2d.to(dev), pl, cfg, n_local, es.start))
    out = _sum_parts(parts, x2d.device)
    gathered = (_rows_per_device(ctx, x2d.shape[0]) * dsize, x2d.shape[1])
    rules.record_collective("all-gather", gathered, x2d.dtype)
    rules.record_collective("all-reduce", gathered, out.dtype)
    return out


def moe_forward(p, x, cfg, mode: str = "train"):
    """x (B, S, d) → (B, S, d): routed experts plus the shared SwiGLU.
    Expert parallel over ``model`` under a mesh context; 2-D expert
    sharding for decode with ``cfg.moe_decode_2d``; the local branch
    otherwise (the reference's conditions)."""
    p = _dense_moe_params(p, x.dtype)
    b, s, d = x.shape
    ctx = current_ctx()
    e = cfg.n_experts
    x2d = x.reshape(-1, d)
    if (cfg.moe_decode_2d and mode == "decode" and ctx is not None
            and ctx.axis_size("model") > 1 and ctx.axis_size("data") > 1
            and e % ctx.axis_size("model") == 0
            and cfg.moe_d_ff % ctx.axis_size("data") == 0):
        out = _moe_2d(p, x2d, cfg, ctx)
    elif (ctx is None or ctx.axis_size("model") == 1
          or e % ctx.axis_size("model")):
        if any(isinstance(p[k], rules.ShardedTensor) for k in _EXPERT_KEYS):
            raise ValueError("sharded expert stacks need an expert lane's "
                             "mesh")
        out = _moe_local(x2d, p, cfg)
    else:
        out = _moe_ep(p, x2d, cfg, ctx)
    out = out.reshape(b, s, d).to(x.dtype)
    if "shared" in p:
        out = out + mlp_forward(p["shared"], x, cfg.act)
    return out
