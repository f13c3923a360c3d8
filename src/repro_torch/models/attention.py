"""Attention — ``repro.models.attention`` on one device: GQA (bias /
qk-norm options), chunked flash-style softmax attention for prefill,
KV-cache decode, and DeepSeek-V2's Multi-head Latent Attention (MLA:
the materialized form for prefill, the absorbed form for decode over a
compressed ``(ckv, krot)`` cache).

The model's attention is plain PyTorch here, as the reference's is plain
JAX: the reference models never call the Pallas attention kernel, so
neither does the port (``repro_torch.kernels.flash_attention`` ports
that kernel behind its own entry point).  Score and accumulator math
runs in float32 over bfloat16 operands (the reference's ``_einsum_f32``
on an executing backend).
Decode runs against a contiguous cache or a paged one
(:class:`repro_torch.models.cache.PagedKV`, the continuous batcher's
pool).  The sequence-parallel ``decode_attn="dist"`` lane of the
reference needs a mesh and waits for ROADMAP "A10, model half"; with one
device the reference takes the standard lane, and so does the port.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models.common import (apply_rope, dense_init,
                                       dense_weight, linear, norm_apply,
                                       norm_init, rms_norm)

__all__ = ["flash_attention", "decode_positions", "cache_update",
           "decode_attention", "gqa_init", "gqa_forward", "gqa_decode",
           "gqa_cache_init", "gqa_cache_init_paged", "mla_init",
           "mla_forward", "mla_decode", "mla_cache_init",
           "mla_cache_init_paged"]


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with float32 operands and accumulation."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# chunked (flash-style) attention — online softmax
# ---------------------------------------------------------------------------

def _pick_chunk(s: int, preferred: int) -> int:
    """Largest divisor of ``s`` that is ≤ preferred."""
    c = min(preferred, s)
    while s % c:
        c -= 1
    return c


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_chunk: int = 512, kv_chunk: int = 1024,
                    scale: float | None = None,
                    acc_dtype=torch.float32) -> torch.Tensor:
    """q (B,Sq,Hq,Dk), k (B,Skv,Hkv,Dk), v (B,Skv,Hkv,Dv) → (B,Sq,Hq,Dv).

    Online softmax over kv chunks inside a loop over q chunks, with the
    reference's chunking and ``-1e30`` mask; GQA by head grouping (no kv
    repeat).  ``acc_dtype`` is the dtype of the score/accumulator
    buffers."""
    b, sq, hq, dk = q.shape
    _, skv, hkv, dv = v.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qc = _pick_chunk(sq, q_chunk)
    kc = _pick_chunk(skv, kv_chunk)
    n_q, n_k = sq // qc, skv // kc

    qr = q.reshape(b, n_q, qc, hkv, g, dk).permute(1, 0, 3, 4, 2, 5)
    kr = k.reshape(b, n_k, kc, hkv, dk).permute(1, 0, 3, 2, 4)
    vr = v.reshape(b, n_k, kc, hkv, dv).permute(1, 0, 3, 2, 4)

    outs = []
    for qi in range(n_q):
        q_blk = qr[qi].to(acc_dtype)                 # (B,Hkv,G,qc,Dk)
        m = torch.full((b, hkv, g, qc), -1e30, dtype=acc_dtype,
                       device=q.device)
        l = torch.zeros((b, hkv, g, qc), dtype=acc_dtype, device=q.device)
        acc = torch.zeros((b, hkv, g, qc, dv), dtype=acc_dtype,
                          device=q.device)
        for ki in range(n_k):
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_blk,
                             kr[ki].to(acc_dtype)) * scale
            if causal:
                qpos = qi * qc + torch.arange(qc, device=q.device)
                kpos = ki * kc + torch.arange(kc, device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vr[ki].to(acc_dtype))
            m = m_new
        out = acc / torch.clamp(l, min=1e-8)[..., None]
        outs.append(out.to(q.dtype))
    # (n_q, B, Hkv, G, qc, Dv) → (B, Sq, Hq, Dv)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, sq, hq, dv)


def decode_positions(pos, b: int, device=None) -> torch.Tensor:
    """Decode-step position → the ``(B, 1)`` int32 matrix RoPE consumes;
    ``pos`` is a scalar (every row at the same position) or per-row
    ``(B,)``."""
    if isinstance(pos, int):             # no host→device copy
        return torch.full((b, 1), pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return torch.broadcast_to(p[:, None] if p.dim() else p, (b, 1))


def cache_update(cache: torch.Tensor, new: torch.Tensor, pos
                 ) -> torch.Tensor:
    """Write the single-token block ``new`` (B, 1, ...) into the (B, S,
    ...) ``cache`` at ``pos`` (scalar or per-row ``(B,)``).  The port
    writes in place (the reference returns a new array) and returns
    ``cache``.  A Python int slices (eager callers); a tensor position,
    0-dim or ``(B,)``, scatters per row without leaving the device, so
    a captured step can take it from a static buffer.  Both write the
    same bits."""
    new = new.to(cache.dtype)
    if isinstance(pos, int):
        cache[:, pos:pos + 1] = new
        return cache
    p = torch.as_tensor(pos, device=cache.device)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, p.expand(cache.shape[0]) if p.dim() == 0 else p] = new[:, 0]
    return cache


def _visible(pos, b: int, s: int, device) -> torch.Tensor:
    """``(B, S)`` mask of the cache positions ``<= pos`` (scalar or per
    row)."""
    idx = torch.arange(s, device=device)
    if isinstance(pos, int):             # no host→device copy
        return (idx <= pos)[None, :].expand(b, s)
    posb = torch.broadcast_to(torch.as_tensor(pos, device=device), (b,))
    return idx[None, :] <= posb[:, None]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token attention against a (B,S,Hkv,D) cache, masked to
    positions ≤ pos (pos per-batch (B,) or scalar)."""
    b, sq, hq, dk = q.shape
    _, s, hkv, dv = v_cache.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, sq, hkv, g, dk)
    scores = _einsum_f32("bqhgd,bshd->bhgqs", qg,
                         k_cache.to(qg.dtype)) * scale
    mask = _visible(pos, b, s, q.device)
    scores = torch.where(mask[:, None, None, None, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = _einsum_f32("bhgqs,bshd->bqhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, sq, hq, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg, *, lead: tuple = ()) -> dict:
    """GQA params; ``lead`` stacks them (the layer stack)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "q_proj": dense_init(gen, d, hq * hd, lead=lead),
        "k_proj": dense_init(gen, d, hkv * hd, lead=lead),
        "v_proj": dense_init(gen, d, hkv * hd, lead=lead),
        "o_proj": dense_init(gen, hq * hd, d, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("q_bias", hq * hd), ("k_bias", hkv * hd),
                            ("v_bias", hkv * hd)):
            p[name] = torch.zeros(tuple(lead) + (width,),
                                  dtype=torch.float32, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, "rmsnorm", lead=lead, device=gen.device)
        p["k_norm"] = norm_init(hd, "rmsnorm", lead=lead, device=gen.device)
    return p


def _qkv(p, x, cfg, positions):
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = linear(x, p["q_proj"], p.get("q_bias")).reshape(b, s, hq, hd)
    k = linear(x, p["k_proj"], p.get("k_bias")).reshape(b, s, hkv, hd)
    v = linear(x, p["v_proj"], p.get("v_bias")).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["w"])
        k = rms_norm(k, p["k_norm"]["w"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p, x, cfg, positions, *, causal=True):
    """Full-sequence GQA (prefill).  Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = flash_attention(q, k, v, causal=causal,
                          q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk,
                          acc_dtype=torch.float32 if cfg.attn_f32
                          else torch.bfloat16)
    b, s = x.shape[:2]
    out = linear(out.reshape(b, s, -1), p["o_proj"])
    return out, (k, v)


def gqa_decode(p, x, cfg, cache, pos):
    """Single-token decode.  cache = (k, v), each (B, S, Hkv, hd) or a
    :class:`~repro_torch.models.cache.PagedKV`, updated in place at
    ``pos`` (scalar, or per-row (B,) when the batch is a continuous-
    batching slot pool whose rows sit at different positions)."""
    k_cache, v_cache = cache
    positions = decode_positions(pos, x.shape[0], device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    if isinstance(k_cache, cache_lib.PagedKV):
        # paged lane: write the new row into the slot's page, then run
        # the standard masked attention over the gathered dense view —
        # bf16 pages reproduce the contiguous cache byte for byte
        k_cache = k_cache.update(k_new, pos)
        v_cache = v_cache.update(v_new, pos)
        out = decode_attention(q, k_cache.gather(), v_cache.gather(), pos)
    else:
        k_cache = cache_update(k_cache, k_new, pos)
        v_cache = cache_update(v_cache, v_new, pos)
        out = decode_attention(q, k_cache, v_cache, pos)
    b = x.shape[0]
    out = linear(out.reshape(b, 1, -1), p["o_proj"])
    return out, (k_cache, v_cache)


def gqa_cache_init(cfg, batch: int, seq: int, dtype=torch.bfloat16, *,
                   lead: tuple = (), device=None):
    shape = tuple(lead) + (batch, seq, cfg.n_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def gqa_cache_init_paged(cfg, spec, dtype=torch.bfloat16, *,
                         lead: tuple = (), device=None):
    """Paged (k, v) for a :class:`~repro_torch.models.cache.PagedSpec`."""
    feat = (cfg.n_kv_heads, cfg.head_dim)
    return (cache_lib.paged_kv_init(spec, feat, dtype, lead=lead,
                                    device=device),
            cache_lib.paged_kv_init(spec, feat, dtype, lead=lead,
                                    device=device))


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2) — compressed KV cache
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, *, lead: tuple = ()) -> dict:
    """MLA params; ``lead`` stacks them (the layer stack)."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "q_a_proj": dense_init(gen, d, qr, lead=lead),
        "q_a_norm": norm_init(qr, "rmsnorm", lead=lead, device=gen.device),
        "q_b_proj": dense_init(gen, qr, h * (dn + dr), lead=lead),
        "kv_a_proj": dense_init(gen, d, kr + dr, lead=lead),
        "kv_a_norm": norm_init(kr, "rmsnorm", lead=lead, device=gen.device),
        "kv_b_proj": dense_init(gen, kr, h * (dn + dv), lead=lead),
        "o_proj": dense_init(gen, h * dv, d, lead=lead),
    }


def _mla_q(p, x, cfg, positions):
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
    qa = norm_apply(linear(x, p["q_a_proj"]), p["q_a_norm"], "rmsnorm")
    q = linear(qa, p["q_b_proj"]).reshape(b, s, h, dn + dr)
    qn, qrot = q[..., :dn], q[..., dn:]
    qrot = apply_rope(qrot, positions, cfg.rope_theta)
    return qn, qrot


def _mla_ckv(p, x, cfg, positions):
    kr = cfg.kv_lora_rank
    kv_a = linear(x, p["kv_a_proj"])
    ckv = norm_apply(kv_a[..., :kr], p["kv_a_norm"], "rmsnorm")
    krot = kv_a[..., kr:][:, :, None, :]                 # (B,S,1,dr)
    krot = apply_rope(krot, positions, cfg.rope_theta)[:, :, 0]
    return ckv, krot


def mla_forward(p, x, cfg, positions, *, causal=True):
    """Materialized form (prefill): the latent is expanded through
    ``kv_b_proj`` into per-head keys and values and attended with the
    plain chunked :func:`flash_attention` (Dk = nope + rope, Dv = v), as
    the reference does.  Returns (out, (ckv, krot))."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    qn, qrot = _mla_q(p, x, cfg, positions)
    ckv, krot = _mla_ckv(p, x, cfg, positions)
    kv = linear(ckv, p["kv_b_proj"]).reshape(b, s, h, dn + dv)
    kn, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([kn, torch.broadcast_to(
        krot[:, :, None, :], (b, s, h, dr)).to(kn.dtype)], dim=-1)
    q = torch.cat([qn, qrot], dim=-1)
    out = flash_attention(q, k, v, causal=causal,
                          q_chunk=cfg.attn_q_chunk,
                          kv_chunk=cfg.attn_kv_chunk,
                          scale=1.0 / math.sqrt(dn + dr),
                          acc_dtype=torch.float32 if cfg.attn_f32
                          else torch.bfloat16)
    out = linear(out.reshape(b, s, -1), p["o_proj"])
    return out, (ckv, krot)


def mla_decode(p, x, cfg, cache, pos):
    """Absorbed decode: attention runs in the kv_lora latent space.
    ``cache`` is ``(ckv (B,S,c), krot (B,S,dr))`` or two
    :class:`~repro_torch.models.cache.PagedKV`, written in place at
    ``pos`` (scalar or per-row ``(B,)``); per-token cache traffic is
    ``c + dr`` per position instead of ``H·(dn+dv)``.  ``kv_b_proj``
    enters as a weight, not a matmul: a packed leaf is decoded on
    dispatch (``dense_weight``)."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    c = cfg.kv_lora_rank
    ckv_cache, krot_cache = cache
    positions = decode_positions(pos, b, device=x.device)
    qn, qrot = _mla_q(p, x, cfg, positions)              # (B,1,H,dn/dr)
    ckv_new, krot_new = _mla_ckv(p, x, cfg, positions)
    if isinstance(ckv_cache, cache_lib.PagedKV):
        ckv_cache = ckv_cache.update(ckv_new, pos)
        krot_cache = krot_cache.update(krot_new, pos)
        ckv_dense, krot_dense = ckv_cache.gather(), krot_cache.gather()
    else:
        ckv_cache = cache_update(ckv_cache, ckv_new, pos)
        krot_cache = cache_update(krot_cache, krot_new, pos)
        ckv_dense, krot_dense = ckv_cache, krot_cache

    w_kv_b = dense_weight(p["kv_b_proj"]).reshape(c, h, dn + dv)
    w_uk, w_uv = w_kv_b[..., :dn], w_kv_b[..., dn:]
    q_lat = _einsum_f32("bqhd,chd->bqhc", qn, w_uk.to(qn.dtype))
    scores = (_einsum_f32("bqhc,bsc->bhqs", q_lat.to(ckv_dense.dtype),
                          ckv_dense)
              + _einsum_f32("bqhd,bsd->bhqs", qrot.to(krot_dense.dtype),
                            krot_dense))
    scores = scores / math.sqrt(dn + dr)
    mask = _visible(pos, b, ckv_dense.shape[1], x.device)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    attn = torch.softmax(scores, dim=-1)
    out_lat = _einsum_f32("bhqs,bsc->bqhc", attn.to(ckv_dense.dtype),
                          ckv_dense)
    out = torch.einsum("bqhc,chd->bqhd", out_lat, w_uv.to(torch.float32))
    out = linear(out.reshape(b, 1, h * dv).to(x.dtype), p["o_proj"])
    return out, (ckv_cache, krot_cache)


def mla_cache_init(cfg, batch: int, seq: int, dtype=torch.bfloat16, *,
                   lead: tuple = (), device=None):
    """Zeroed ``(ckv, krot)``: ``(*lead, batch, seq, kv_lora_rank)`` and
    ``(*lead, batch, seq, rope_head_dim)``."""
    lead = tuple(lead)
    return (torch.zeros(lead + (batch, seq, cfg.kv_lora_rank), dtype=dtype,
                        device=device),
            torch.zeros(lead + (batch, seq, cfg.rope_head_dim), dtype=dtype,
                        device=device))


def mla_cache_init_paged(cfg, spec, dtype=torch.bfloat16, *,
                         lead: tuple = (), device=None):
    """Paged ``(ckv, krot)`` for a
    :class:`~repro_torch.models.cache.PagedSpec`."""
    return (cache_lib.paged_kv_init(spec, (cfg.kv_lora_rank,), dtype,
                                    lead=lead, device=device),
            cache_lib.paged_kv_init(spec, (cfg.rope_head_dim,), dtype,
                                    lead=lead, device=device))
