"""Attention, the GQA half of ``repro.models.attention``: GQA (bias /
qk-norm options), chunked flash-style softmax attention for prefill, and
KV-cache decode.

The model's attention is plain PyTorch here, as the reference's is plain
JAX: the reference models never call the Pallas attention kernel, so
neither does the port (ROADMAP B3 ports that kernel through its own
entry point).  Score and accumulator math runs in float32 over bfloat16
operands (the reference's ``_einsum_f32`` on an executing backend).
The MLA half waits for ROADMAP A5; the paged cache for A6.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (apply_rope, dense_init, linear,
                                       norm_init, rms_norm)

__all__ = ["flash_attention", "decode_positions", "cache_update",
           "decode_attention", "gqa_init", "gqa_forward", "gqa_decode",
           "gqa_cache_init"]


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
    ``cache``."""
    new = new.to(cache.dtype)
    if isinstance(pos, int) or torch.as_tensor(pos).dim() == 0:
        p = int(pos)
        cache[:, p:p + 1] = new
    else:
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, torch.as_tensor(pos, device=cache.device)] = new[:, 0]
    return cache


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
    idx = torch.arange(s, device=q.device)
    if isinstance(pos, int):             # no host→device copy
        mask = (idx <= pos)[None, :].expand(b, s)               # (B, S)
    else:
        posb = torch.broadcast_to(torch.as_tensor(pos, device=q.device),
                                  (b,))
        mask = idx[None, :] <= posb[:, None]
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
    """Single-token decode.  cache = (k, v), each (B, S, Hkv, hd), updated
    in place at ``pos`` (scalar, or per-row (B,))."""
    k_cache, v_cache = cache
    positions = decode_positions(pos, x.shape[0], device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
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
