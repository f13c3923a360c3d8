"""The plain reference of the DeepSeek-V2 cells: the decoder's full
forward pass in float32 over each sampled request's prompt and served
tokens, from the same float parameters as the program, with the 4-bit
codec's quantization worked out again here.

What it computes, as the configuration states it (and as the port runs
it; ``PERF.md`` lists where both depart from the published model):

* every matrix leaf (projections, router, expert stacks, both embedding
  tables) quantized once over the whole leaf, stack and experts
  included: symmetric int8 (``scale = amax / 127`` in float32, round
  half to even, clip ±127), then restricted to U levels including zero;
  the weight is ``q · scale`` in float32;
* RMSNorm (eps 1e-6) before each mixer and each MLP, and on the q and kv
  latents; rotary embeddings on the 64 rope dimensions (rotate-half,
  theta 1e4, no YaRN);
* MLA materialized: causal softmax attention over 128 heads of
  ``nope + rope`` keys, ``1 / sqrt(192)`` scale;
* the dense layer's SwiGLU; each MoE layer's router in float32, the top
  6 of 160 experts, gates a softmax over the 6 chosen logits, each
  expert's SwiGLU, plus the shared SwiGLU of width 2 · 1536;
* the final RMSNorm and the logits against the output table.

``act="fp8"`` casts every matrix product's activation operand to
float8 e4m3 under a per-tensor scale first: the control, a precision
below the bf16 the configuration serves in.  Imports neither the program
nor JAX; runs layer by layer over all sampled requests together, one
leaf drawn at a time.
"""
from __future__ import annotations

import math

__all__ = ["dequantize_", "Reference"]

_CHUNK = 1 << 26


def dequantize_(w, n_unique: int):
    """Replace float32 ``w`` in place by the codec's ``q · scale``."""
    import torch
    amax = w.abs().max()
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).to(torch.float32)
    flat = w.view(-1)
    step = -(-256 // (n_unique - 1))
    for s in range(0, flat.numel(), _CHUNK):
        part = flat[s:s + _CHUNK]
        q = torch.round(part / scale).clamp_(-127, 127)
        if n_unique < 256:
            qi = q.to(torch.int32)
            r = torch.div(qi + 128, step, rounding_mode="floor") * step \
                - 128 + step // 2
            q = torch.where(qi == 0, 0, r.clamp(-127, 127)).to(q.dtype)
        part.copy_(q * scale)
    return w


def _rms(x, w, eps: float = 1e-6):
    import torch
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x, theta: float):
    """x (T, H, D): rotate-half rotary embedding at positions 0 … T-1."""
    import torch
    t, d = x.shape[0], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                          device=x.device) / d))
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs.to(torch.float32)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    """The forward pass over a set of token sequences.

    ``leaf(path)`` returns a matrix leaf, dequantized, float32 (its whole
    stack) or a norm's weights; the caller draws it from the seed.
    ``act`` is ``"fp32"`` or ``"fp8"`` (the control)."""

    def __init__(self, config: dict, leaf, *, act: str = "fp32"):
        self.c, self._draw, self.act = config, leaf, act
        self._held: dict = {}

    def leaf(self, path):
        """A leaf, drawn once and held until :meth:`drop`."""
        if path not in self._held:
            self._held[path] = self._draw(path)
        return self._held[path]

    def drop(self) -> None:
        """Let go of the leaves held so far."""
        import torch
        self._held.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _a(self, x):
        """A matrix product's activation operand at the run's precision."""
        if self.act == "fp32":
            return x
        import torch
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    def _mm(self, x, w):
        return self._a(x) @ w

    def _swiglu(self, x, up, gate, down):
        import torch.nn.functional as F
        return self._mm(F.silu(self._mm(x, gate)) * self._mm(x, up), down)

    def _mla(self, x, p):
        import torch
        c = self.c
        t = x.shape[0]
        h, dn = c["num_attention_heads"], c["qk_nope_head_dim"]
        dr, dv, kr = c["qk_rope_head_dim"], c["v_head_dim"], \
            c["kv_lora_rank"]
        qa = _rms(self._mm(x, p("q_a_proj")), p("q_a_norm", "w"))
        q = self._mm(qa, p("q_b_proj")).reshape(t, h, dn + dr)
        q = torch.cat([q[..., :dn], _rope(q[..., dn:], c["rope_theta"])], -1)
        kv_a = self._mm(x, p("kv_a_proj"))
        ckv = _rms(kv_a[:, :kr], p("kv_a_norm", "w"))
        krot = _rope(kv_a[:, None, kr:], c["rope_theta"])
        kv = self._mm(ckv, p("kv_b_proj")).reshape(t, h, dn + dv)
        k = torch.cat([kv[..., :dn], krot.expand(t, h, dr)], -1)
        v = kv[..., dn:]
        out = torch.empty(t, h, dv, dtype=torch.float32, device=x.device)
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        for h0 in range(0, h, 32):
            hs = slice(h0, h0 + 32)
            qh, kh = self._a(q[:, hs]), self._a(k[:, hs])
            s = torch.einsum("qhd,khd->hqk", qh, kh) / math.sqrt(dn + dr)
            s = torch.where(mask, s, float("-inf")).softmax(-1)
            out[:, hs] = torch.einsum("hqk,khd->qhd", self._a(s),
                                      self._a(v[:, hs]))
        return self._mm(out.reshape(t, h * dv), p("o_proj"))

    def _moe(self, x, p):
        import torch
        c = self.c
        k = c["num_experts_per_tok"]
        logits = self._mm(x, p("router"))
        top, idx = torch.topk(logits, k, dim=-1)
        gates = torch.softmax(top, dim=-1)
        out = torch.zeros_like(x)
        wg, wi, wo = p("w_experts_gate"), p("w_experts_in"), \
            p("w_experts_out")
        for e in torch.unique(idx).tolist():
            rows, slot = (idx == e).nonzero(as_tuple=True)
            y = self._swiglu(x[rows], wi[e], wg[e], wo[e])
            out.index_add_(0, rows, y * gates[rows, slot][:, None])
        sh = lambda n: p("shared", n)  # noqa: E731
        return out + self._swiglu(x, sh("up_proj"), sh("gate_proj"),
                                  sh("down_proj"))

    def _layers(self):
        """``(params getter, is MoE)`` for each layer in order."""
        c = self.c
        for j in range(c["first_k_dense_replace"]):
            yield (lambda *k, j=j: self.leaf(("prologue", j) + k)), False
        n_stack = c["num_hidden_layers"] - c["first_k_dense_replace"]
        for i in range(n_stack):
            yield (lambda *k, i=i: self.leaf(("stack", "b0") + k)[i]), True

    def logits(self, sequences, positions):
        """Float32 logits ``(len(positions[r]), vocab)`` for each token
        sequence ``sequences[r]`` (1-D int tensor) at its positions, with
        TF32 off."""
        import torch
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return self._logits(sequences, positions)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def _logits(self, sequences, positions):
        import torch
        emb = self.leaf(("embed",))
        xs = [emb[s].clone() for s in sequences]
        del emb
        self.drop()
        was_moe = None
        for get, moe in self._layers():
            if moe != was_moe:
                self.drop()           # the stack's leaves serve its layers
            was_moe = moe
            for r, x in enumerate(xs):
                x = x + self._mla(_rms(x, get("norm1", "w")),
                                  lambda *k: get("mixer", *k))
                h = _rms(x, get("norm2", "w"))
                if moe:
                    x = x + self._moe(h, lambda *k: get("mlp", *k))
                else:
                    x = x + self._swiglu(h, get("mlp", "up_proj"),
                                         get("mlp", "gate_proj"),
                                         get("mlp", "down_proj"))
                xs[r] = x
        self.drop()
        norm, table = self.leaf(("final_norm", "w")), self.leaf(("out_embed",))
        out = [self._mm(_rms(x[pos], norm), table.T)
               for x, pos in zip(xs, positions)]
        self.drop()
        return out
