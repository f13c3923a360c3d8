"""State-space and recurrent mixers — ``repro.models.ssm`` on one
device: Mamba (Jamba's SSM layers) and the xLSTM sLSTM / mLSTM blocks.

Mamba's selective scan runs chunkwise, as in the reference: a loop over
sequence chunks carries the ``(B, d_inner, N)`` state, and within a
chunk a log-depth doubling scan (ordinary torch ops in place of
``lax.associative_scan``) gives every step's state, so only one chunk's
``(B, chunk, d_inner, N)`` decay tensor is live.  sLSTM and mLSTM use
the stabilized exponential gating of the xLSTM paper and step through
the sequence one token at a time (``lax.scan`` in the reference).  The
scans are XLA in the reference, not Pallas kernels, so they stay on
ordinary torch ops here.

States and statistics are float32 (the mamba conv tail excepted, which
is in the cache's dtype), the stabilizers start at ``-1e30``, and a
packed sLSTM ``r_proj`` is decoded once per forward.  Where the
reference returns a new state from a decode step, the port writes it
into the cache's buffers in place, each value cast to the buffer's
dtype (the reference's scan carry casts the same way): a captured decode
step replays over fixed addresses.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, dense_weight, linear

__all__ = ["mamba_init", "mamba_forward", "mamba_decode", "mamba_state_init",
           "mlstm_init", "mlstm_forward", "mlstm_state_init", "slstm_init",
           "slstm_forward", "slstm_state_init"]


def _write(state: tuple, new: tuple) -> tuple:
    """Copy ``new`` into the buffers of ``state`` (cast to their dtypes);
    returns ``state``."""
    for buf, value in zip(state, new):
        buf.copy_(value)
    return state


# ---------------------------------------------------------------------------
# Mamba (S6) block
# ---------------------------------------------------------------------------

def _dt_rank(d: int) -> int:
    return max(1, math.ceil(d / 16))


def mamba_init(gen: torch.Generator, cfg, *, lead: tuple = ()) -> dict:
    """Mamba params; ``lead`` stacks them (the layer stack)."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    n = cfg.ssm_d_state
    dt_rank = _dt_rank(d)
    lead, dev = tuple(lead), gen.device
    return {
        "in_proj": dense_init(gen, d, 2 * d_in, lead=lead),
        "conv_w": torch.randn(lead + (cfg.ssm_d_conv, d_in), generator=gen,
                              device=dev).mul_(0.1),
        "conv_b": torch.zeros(lead + (d_in,), device=dev),
        "x_proj": dense_init(gen, d_in, dt_rank + 2 * n, lead=lead),
        "dt_proj": dense_init(gen, dt_rank, d_in, lead=lead),
        "dt_bias": torch.zeros(lead + (d_in,), device=dev),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).expand(
            lead + (d_in, n)).clone(),
        "D": torch.ones(lead + (d_in,), device=dev),
        "out_proj": dense_init(gen, d_in, d, lead=lead),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over seq: x (B,S,C), w (K,C)."""
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _ssm_scan_chunked(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1; a/b (B,S,d,N), h0 (B,d,N).
    Returns all h_t (B,S,d,N).  ``chunk = min(chunk, S)`` must divide S,
    as the reference asserts."""
    s = a.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"scan chunk {chunk}")
    h, out = h0, []
    for c0 in range(0, s, chunk):
        pa, pb = a[:, c0:c0 + chunk], b[:, c0:c0 + chunk]
        # inclusive doubling scan of (a, b) under the reference's combine
        # (l, r) -> (r.a·l.a, r.a·l.b + r.b): after the pass of width w,
        # step t holds the composition of steps max(0, t-2w+1) .. t
        w = 1
        while w < chunk:
            pb = torch.cat([pb[:, :w], pa[:, w:] * pb[:, :-w] + pb[:, w:]],
                           dim=1)
            pa = torch.cat([pa[:, :w], pa[:, w:] * pa[:, :-w]], dim=1)
            w *= 2
        hs = pa * h[:, None] + pb
        h = hs[:, -1]
        out.append(hs)
    return torch.cat(out, dim=1)


def _mamba_inner(p, xi_conv, x_dtype, d: int, n: int):
    """The selective-scan inputs of ``xi_conv`` (B,S,d_in): ``(dt f32,
    B f32, C f32, A)``."""
    dt_rank = _dt_rank(d)
    xdb = linear(xi_conv, p["x_proj"])
    dt = F.softplus(linear(xdb[..., :dt_rank], p["dt_proj"])
                    + p["dt_bias"].to(x_dtype))
    bmat = xdb[..., dt_rank:dt_rank + n].to(torch.float32)
    cmat = xdb[..., dt_rank + n:].to(torch.float32)
    a_cont = -torch.exp(p["A_log"])                        # (d_in, N)
    return dt.to(torch.float32), bmat, cmat, a_cont


def mamba_forward(p, x: torch.Tensor, cfg, *, chunk: int = 256):
    """x (B,S,d) → (y (B,S,d), state (conv_tail, h_last))."""
    bsz, s, d = x.shape
    n = cfg.ssm_d_state
    d_in = cfg.ssm_expand * d
    xi, z = torch.chunk(linear(x, p["in_proj"]), 2, dim=-1)
    xi_conv = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    dtf, bmat, cmat, a_cont = _mamba_inner(p, xi_conv, x.dtype, d, n)
    decay = torch.exp(dtf[..., None] * a_cont[None, None])   # (B,S,d_in,N)
    drive = (dtf * xi_conv.to(torch.float32))[..., None] \
        * bmat[:, :, None, :]
    h0 = torch.zeros((bsz, d_in, n), dtype=torch.float32, device=x.device)
    hs = _ssm_scan_chunked(decay, drive, h0, chunk)
    y = torch.einsum("bsdn,bsn->bsd", hs, cmat)
    y = y + p["D"].to(torch.float32) * xi_conv.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, p["out_proj"])
    conv_tail = xi[:, -(cfg.ssm_d_conv - 1):]              # raw pre-conv tail
    return out, (conv_tail, hs[:, -1])


def mamba_decode(p, x: torch.Tensor, cfg, state):
    """Single-token step.  state = (conv_tail (B,K-1,d_in), h (B,d_in,N)),
    both rewritten in place and returned."""
    conv_tail, h = state
    d = x.shape[-1]
    n = cfg.ssm_d_state
    xi, z = torch.chunk(linear(x, p["in_proj"]), 2, dim=-1)  # (B,1,d_in)
    # a new tensor: the shifted tail is copied out of it, never out of
    # the buffer it lands in
    window = torch.cat([conv_tail.to(xi.dtype), xi], dim=1)
    conv = (window * p["conv_w"].to(xi.dtype)).sum(dim=1, keepdim=True) \
        + p["conv_b"].to(xi.dtype)
    xi_conv = F.silu(conv)
    dtf, bmat, cmat, a_cont = _mamba_inner(p, xi_conv, x.dtype, d, n)
    dtf = dtf[:, 0]                                        # (B,d_in)
    decay = torch.exp(dtf[..., None] * a_cont[None])
    drive = (dtf * xi_conv[:, 0].to(torch.float32))[..., None] \
        * bmat[:, 0, None, :]
    h_new = decay * h + drive
    y = torch.einsum("bdn,bn->bd", h_new, cmat[:, 0])[:, None]
    y = y + p["D"].to(torch.float32) * xi_conv.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    out = linear(y, p["out_proj"])
    return out, _write(state, (window[:, 1:], h_new))


def mamba_state_init(cfg, batch: int, dtype=torch.bfloat16, *,
                     lead: tuple = (), device=None):
    """Zeroed ``(conv_tail (*lead, B, K-1, d_in) in dtype, h (*lead, B,
    d_in, N) float32)``."""
    d_in = cfg.ssm_expand * cfg.d_model
    lead = tuple(lead)
    return (torch.zeros(lead + (batch, cfg.ssm_d_conv - 1, d_in),
                        dtype=dtype, device=device),
            torch.zeros(lead + (batch, d_in, cfg.ssm_d_state),
                        dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory, recurrent mix)
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, cfg, *, lead: tuple = ()) -> dict:
    """mLSTM params; ``lead`` stacks them (the layer stack)."""
    d, h = cfg.d_model, cfg.n_heads
    d_up = 2 * d
    lead = tuple(lead)
    if_bias = torch.cat([torch.zeros(h), torch.full((h,), 3.0)])
    return {
        "up_proj": dense_init(gen, d, 2 * d_up, lead=lead),
        "q_proj": dense_init(gen, d_up, d_up, lead=lead),
        "k_proj": dense_init(gen, d_up, d_up, lead=lead),
        "v_proj": dense_init(gen, d_up, d_up, lead=lead),
        "if_proj": dense_init(gen, d_up, 2 * h, scale=0.02, lead=lead),
        "if_bias": if_bias.to(gen.device).expand(lead + (2 * h,)).clone(),
        "out_proj": dense_init(gen, d_up, d, lead=lead),
    }


def _mlstm_step(carry, q, k, v, ig, fg):
    c, n, m = carry                        # C (B,H,dk,dv), n (B,H,dk), m (B,H)
    m_new = torch.maximum(fg + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(fg + m - m_new)
    c = f_p[..., None, None] * c + i_p[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhkv,bhk->bhv", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    return (c, n, m_new), num / den[..., None]


def mlstm_forward(p, x: torch.Tensor, cfg, state=None):
    """x (B,S,d) → (out, state), stepping through S.  A given ``state``
    (decode) is read and rewritten in place; without one (prefill) the
    scan starts from :func:`mlstm_state_init` and returns its own."""
    bsz, s, d = x.shape
    h = cfg.n_heads
    d_up = 2 * d
    dk = d_up // h
    xin, z = torch.chunk(linear(x, p["up_proj"]), 2, dim=-1)  # (B,S,d_up)
    q = linear(xin, p["q_proj"]).reshape(bsz, s, h, dk) / math.sqrt(dk)
    k = linear(xin, p["k_proj"]).reshape(bsz, s, h, dk)
    v = linear(xin, p["v_proj"]).reshape(bsz, s, h, dk)
    ifg = linear(xin, p["if_proj"]).to(torch.float32) \
        + p["if_bias"].to(torch.float32)
    ig, fg = ifg[..., :h], F.logsigmoid(ifg[..., h:])
    carry = (state if state is not None
             else mlstm_state_init(cfg, bsz, device=x.device))
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    hs = []
    for t in range(s):
        carry, h_out = _mlstm_step(carry, qf[:, t], kf[:, t], vf[:, t],
                                   ig[:, t], fg[:, t])
        hs.append(h_out)
    hs = torch.stack(hs, dim=1).reshape(bsz, s, d_up).to(x.dtype)
    hs = hs * F.silu(z)
    if state is not None:
        carry = _write(state, carry)
    return linear(hs, p["out_proj"]), carry


def mlstm_state_init(cfg, batch: int, *, lead: tuple = (), device=None):
    """Zeroed float32 ``(C (*lead, B, H, dk, dk), n (*lead, B, H, dk), m
    (*lead, B, H) at -1e30)``."""
    h = cfg.n_heads
    dk = 2 * cfg.d_model // h
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(lead + (batch, h, dk, dk), **f32),
            torch.zeros(lead + (batch, h, dk), **f32),
            torch.full(lead + (batch, h), -1e30, **f32))


def slstm_init(gen: torch.Generator, cfg, *, lead: tuple = ()) -> dict:
    """sLSTM params; ``lead`` stacks them (the layer stack)."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    lead = tuple(lead)
    return {
        "w_proj": dense_init(gen, d, 4 * d, lead=lead),
        "r_proj": torch.randn(lead + (h, dh, 4 * dh), generator=gen,
                              device=gen.device).div_(math.sqrt(dh)),
        "bias": torch.zeros(lead + (4 * d,), device=gen.device),
        "out_proj": dense_init(gen, d, d, lead=lead),
    }


def _slstm_step(r: torch.Tensor, cfg, carry, wx_t: torch.Tensor):
    c, n, hprev, m = carry                   # each (B, d) / m (B, H)
    bsz, d = c.shape
    h = cfg.n_heads
    dh = d // h
    hh = hprev.reshape(bsz, h, dh)
    rec = torch.einsum("bhd,hde->bhe", hh, r).reshape(bsz, 4 * d)
    raw = (wx_t + rec).to(torch.float32)
    zt, it, ft, ot = torch.chunk(raw, 4, dim=-1)
    ith = it.reshape(bsz, h, dh)
    fth = F.logsigmoid(ft).reshape(bsz, h, dh)
    m_new = torch.maximum(fth.mean(-1) + m, ith.mean(-1))  # per-head stabilizer
    i_p = torch.exp(ith - m_new[..., None]).reshape(bsz, d)
    f_p = torch.exp(fth + (m - m_new)[..., None]).reshape(bsz, d)
    c_new = f_p * c + i_p * torch.tanh(zt)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def slstm_forward(p, x: torch.Tensor, cfg, state=None):
    """x (B,S,d) → (out, state), stepping through S; ``state`` as in
    :func:`mlstm_forward`."""
    bsz, s, _ = x.shape
    # the recurrent mix consumes r_proj inside the step: a packed leaf is
    # decoded once per forward, not once per timestep
    r = dense_weight(p["r_proj"])
    wx = linear(x, p["w_proj"]) + p["bias"].to(x.dtype)
    carry = (state if state is not None
             else slstm_state_init(cfg, bsz, device=x.device))
    hs = []
    for t in range(s):
        carry, h_new = _slstm_step(r, cfg, carry, wx[:, t])
        hs.append(h_new)
    hs = torch.stack(hs, dim=1).to(x.dtype)
    if state is not None:
        carry = _write(state, carry)
    return linear(hs, p["out_proj"]), carry


def slstm_state_init(cfg, batch: int, *, lead: tuple = (), device=None):
    """Zeroed float32 ``(c, n, h (*lead, B, d), m (*lead, B, H) at
    -1e30)``."""
    d = cfg.d_model
    lead = tuple(lead)
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(lead + (batch, d), **f32),
            torch.zeros(lead + (batch, d), **f32),
            torch.zeros(lead + (batch, d), **f32),
            torch.full(lead + (batch, cfg.n_heads), -1e30, **f32))
