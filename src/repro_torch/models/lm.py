"""Decoder-only language model — ``repro.models.lm`` for the attention
mixers.

Params keep the reference's tree layout: the layers of one period live
under ``params["stack"]`` with a leading ``n_periods`` axis, and the
non-scanned prologue layers (DeepSeek's leading dense layer) in the list
``params["prologue"]``, so the '/'-joined paths ``compile_params``
matches on are the reference's.  Where the reference scans the stack
with ``lax.scan``, the port loops over layers in Python and slices layer
``i`` out of every stacked leaf (``packed[i]``, ``table[i]``,
``scale[i]`` for a packed projection).  The same forward serves prefill
(returns the KV cache) and decode (single token against a preallocated
cache, written in place).  Where the reference runs
``jax.jit(decode_step)``, the port captures one decode step over one
cache as a CUDA graph and replays it (:class:`CapturedDecode`); prefill
stays eager.

Layers are organized in *periods*: one period is ``cfg.block_pattern``
(Jamba's ``(m, m, m, attn, m, m, m, m)``, xLSTM's ``(mlstm, slstm)``),
repeated ``n_periods`` times.  Ported: the GQA and MLA attention mixers,
the SSM mixers (mamba, mLSTM, sLSTM; :mod:`repro_torch.models.ssm`),
dense MLPs and MoE layers (routed plus shared experts), prologue layers
and a ``prefix`` of precomputed frontend embeddings.  An SSM mixer's
cache is its recurrent state, stacked over the periods like a KV pair
and, like it, rewritten in place by a decode step.  The training forward
(``mode="train"``: every position's logits, no cache) runs the stack's
periods under ``torch.utils.checkpoint`` when ``cfg.remat`` is set,
where the reference wraps its scan body in ``jax.checkpoint``;
:func:`train_loss` is the reference's next-token cross entropy.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.core.tree import leaves, map_leaves, unflatten_like
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.common import (DEFAULT_DTYPE, embed_init,
                                       embedding_lookup, norm_apply,
                                       norm_init, softmax_xent, unembed)

__all__ = ["init_params", "init_cache", "forward", "train_loss", "prefill",
           "decode_step", "recurrent_state", "CapturedDecode"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_mixer(gen: torch.Generator, kind: str, cfg, lead: tuple):
    if kind == "attn":
        fn = attn.mla_init if cfg.use_mla else attn.gqa_init
    else:
        fn = {"mamba": ssm.mamba_init, "mlstm": ssm.mlstm_init,
              "slstm": ssm.slstm_init}.get(kind)
        if fn is None:
            raise ValueError(kind)
    return fn(gen, cfg, lead=lead)


def _init_layer(gen: torch.Generator, spec, cfg, lead: tuple) -> dict:
    """One layer's params (stacked over ``lead``): the mixer of ``spec``
    and its MLP or MoE, if the plan gives it one."""
    kind, ffn = spec
    p = {"norm1": norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                            device=gen.device),
         "mixer": _init_mixer(gen, kind, cfg, lead)}
    if ffn in ("dense", "moe"):
        p["norm2"] = norm_init(cfg.d_model, cfg.norm_type, lead=lead,
                               device=gen.device)
        p["mlp"] = (moe_mod.moe_init(gen, cfg, lead=lead) if ffn == "moe"
                    else moe_mod.mlp_init(gen, cfg.d_model, cfg.d_ff,
                                          lead=lead))
    return p


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, drawn from ``gen``."""
    lead = (cfg.n_periods,)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model),
        "final_norm": norm_init(cfg.d_model, cfg.norm_type,
                                device=gen.device),
        "stack": {f"b{i}": _init_layer(gen, spec, cfg, lead)
                  for i, spec in enumerate(cfg.layer_plan())},
    }
    if not cfg.tied_embeddings:
        params["out_embed"] = embed_init(gen, cfg.vocab_size, cfg.d_model)
    if cfg.n_dense_layers:
        params["prologue"] = [_init_layer(gen, ("attn", "dense"), cfg, ())
                              for _ in range(cfg.n_dense_layers)]
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _mixer_cache(kind: str, cfg, batch: int, seq: int, dtype, paged,
                 device, lead: tuple):
    """One mixer's cache (stacked over ``lead``): GQA ``(k, v)`` or MLA
    ``(ckv, krot)``, contiguous or paged, or an SSM mixer's state."""
    if kind == "attn":
        if paged is not None:
            fn = (attn.mla_cache_init_paged if cfg.use_mla
                  else attn.gqa_cache_init_paged)
            return fn(cfg, paged, dtype, lead=lead, device=device)
        fn = attn.mla_cache_init if cfg.use_mla else attn.gqa_cache_init
        return fn(cfg, batch, seq, dtype, lead=lead, device=device)
    if paged is not None:
        raise NotImplementedError(
            f"paged KV cache covers attention mixers only, got {kind!r} "
            f"({cfg.name}) — SSM states have no sequence axis to page")
    if kind == "mamba":
        return ssm.mamba_state_init(cfg, batch, dtype, lead=lead,
                                    device=device)
    if kind == "mlstm":
        return ssm.mlstm_state_init(cfg, batch, lead=lead, device=device)
    if kind == "slstm":
        return ssm.slstm_state_init(cfg, batch, lead=lead, device=device)
    raise ValueError(kind)


def init_cache(cfg, batch: int, seq: int, dtype=DEFAULT_DTYPE, paged=None,
               device=None) -> dict:
    """Zeroed cache on ``device`` (the card unless the caller names
    another): ``{"stack": {"b<i>": state}}`` with each layer's state
    stacked over ``n_periods`` — GQA ``(k, v)`` of shape ``(n_periods,
    batch, seq, n_kv_heads, head_dim)``, MLA ``(ckv, krot)`` of
    ``(n_periods, batch, seq, kv_lora_rank / rope_head_dim)``, mamba
    ``(conv_tail, h)``, mLSTM ``(C, n, m)``, sLSTM ``(c, n, h, m)`` (the
    SSM states float32, the conv tail in ``dtype``) — plus
    ``"prologue"``, a list of unstacked pairs, when the model has
    prologue layers.  With ``paged`` (a
    :class:`repro_torch.models.cache.PagedSpec`) every attention pair is
    two :class:`PagedKV` pools (``batch`` must equal ``paged.n_slots``,
    ``seq`` its ``max_len``); an SSM mixer raises
    ``NotImplementedError``."""
    if paged is not None and (batch != paged.n_slots
                              or seq != paged.max_len):
        raise ValueError(
            f"paged cache geometry mismatch: batch={batch}/seq={seq} vs "
            f"spec n_slots={paged.n_slots}/max_len={paged.max_len}")
    dev = resolve_device(device)
    out = {"stack": {f"b{i}": _mixer_cache(kind, cfg, batch, seq, dtype,
                                           paged, dev, (cfg.n_periods,))
                     for i, (kind, _) in enumerate(cfg.layer_plan())}}
    if cfg.n_dense_layers:
        out["prologue"] = [_mixer_cache("attn", cfg, batch, seq, dtype,
                                        paged, dev, ())
                           for _ in range(cfg.n_dense_layers)]
    return out


def recurrent_state(cfg, cache) -> list[torch.Tensor]:
    """The buffers of ``cache`` that a decode step both reads and
    rewrites whole: the SSM mixers' states.  Running a step twice
    advances them twice (a KV row is only stored again), so a caller that
    re-runs a step saves them first and puts them back."""
    if cfg.family == "encdec":
        return []
    return [t for i, (kind, _) in enumerate(cfg.layer_plan())
            if kind != "attn" for t in cache["stack"][f"b{i}"]]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer(tree, i: int):
    """Layer ``i`` of a stacked params tree: every leaf sliced on its
    leading axis (a packed projection slices its words, table and
    scale)."""
    return map_leaves(lambda leaf: leaf[i], tree)


def _layers(tree, n: int) -> list:
    """The ``n`` layers of a stacked params tree, each tensor leaf
    unbound once along its leading axis (a packed leaf sliced).  The
    gradient of an unbind is one ``stack`` of the layers' gradients,
    where slicing layer by layer (:func:`_layer`) gives each layer's
    gradient as a zero tensor of the whole stack's size, added up ``n``
    times."""
    cols = [leaf.unbind(0) if isinstance(leaf, torch.Tensor)
            else [leaf[i] for i in range(n)] for leaf in leaves(tree)]
    return [unflatten_like(tree, [c[i] for c in cols]) for i in range(n)]


def _block_apply(lp, x, spec, cfg, mode, cache, pos, positions):
    """One block: the mixer of ``spec`` (attention, GQA or MLA, or an SSM
    mixer) and its MLP or MoE, if the plan gives it one."""
    kind, _ = spec
    h = norm_apply(x, lp["norm1"], cfg.norm_type, f32=cfg.norm_f32)
    mixer = lp["mixer"]
    if kind == "attn":
        if mode == "decode":
            fn = attn.mla_decode if cfg.use_mla else attn.gqa_decode
            out, new_cache = fn(mixer, h, cfg, cache, pos)
        else:
            fn = attn.mla_forward if cfg.use_mla else attn.gqa_forward
            out, new_cache = fn(mixer, h, cfg, positions)
    elif kind == "mamba":
        if mode == "decode":
            out, new_cache = ssm.mamba_decode(mixer, h, cfg, cache)
        else:
            out, new_cache = ssm.mamba_forward(mixer, h, cfg,
                                               chunk=cfg.mamba_chunk)
    elif kind in ("mlstm", "slstm"):
        fn = ssm.mlstm_forward if kind == "mlstm" else ssm.slstm_forward
        out, new_cache = fn(mixer, h, cfg,
                            state=cache if mode == "decode" else None)
    else:
        raise ValueError(kind)
    x = x + out
    if "mlp" in lp:
        h = norm_apply(x, lp["norm2"], cfg.norm_type, f32=cfg.norm_f32)
        if "router" in lp["mlp"]:
            out = moe_mod.moe_forward(lp["mlp"], h, cfg, mode=mode)
        else:
            out = moe_mod.mlp_forward(lp["mlp"], h, cfg.act)
        x = x + out
    return x, new_cache


def forward(params, tokens: torch.Tensor, cfg, *, mode: str = "train",
            cache=None, pos=None, prefix=None):
    """tokens (B, S) int → (logits, new_cache).

    mode='train'  : causal forward, logits for every position, no cache
                    (``None``); differentiable, each period checkpointed
                    when ``cfg.remat`` is set.
    mode='prefill': causal forward, logits for the LAST position, cache
                    out (each pair stacked over the layers; the prologue
                    layers' pairs in a list).
    mode='decode' : S == 1, attends into ``cache`` at ``pos``, writing the
                    new KV rows and SSM states into it in place; returns
                    it.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    plan = cfg.layer_plan()
    x = embedding_lookup(params["embed"], tokens, DEFAULT_DTYPE)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)

    new_prologue = []
    for i, lp in enumerate(params.get("prologue", [])):
        c = cache["prologue"][i] if mode == "decode" else None
        x, nc = _block_apply(lp, x, ("attn", "dense"), cfg, mode, c, pos,
                             positions)
        new_prologue.append(nc)

    if mode == "train":
        def period_fn(xc, period):
            for i, spec in enumerate(plan):
                xc, _ = _block_apply(period[f"b{i}"], xc, spec, cfg, mode,
                                     None, pos, positions)
            return xc

        for period in _layers(params["stack"], cfg.n_periods):
            x = (checkpoint(period_fn, x, period, use_reentrant=False)
                 if cfg.remat else period_fn(x, period))
        x = norm_apply(x, params["final_norm"], cfg.norm_type,
                       f32=cfg.norm_f32)
        return unembed(x, params.get("out_embed", params["embed"])), None

    caches: dict[str, list] = {f"b{i}": [] for i in range(len(plan))}
    for li in range(cfg.n_periods):
        period = _layer(params["stack"], li)
        for i, spec in enumerate(plan):
            name = f"b{i}"
            layer_cache = None
            if mode == "decode":
                layer_cache = tuple(t[li] for t in cache["stack"][name])
            x, nc = _block_apply(period[name], x, spec, cfg, mode,
                                 layer_cache, pos, positions)
            if mode == "prefill":
                caches[name].append(nc)

    x = norm_apply(x, params["final_norm"], cfg.norm_type, f32=cfg.norm_f32)
    if mode == "prefill":
        x = x[:, -1:]
        new_cache = {"stack": {
            name: tuple(torch.stack(parts) for parts in zip(*pairs))
            for name, pairs in caches.items()}}
        if cfg.n_dense_layers:
            new_cache["prologue"] = new_prologue
    else:
        new_cache = cache             # the layers wrote into it in place
    logits = unembed(x, params.get("out_embed", params["embed"]))
    return logits, new_cache


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def train_loss(params, batch, cfg) -> torch.Tensor:
    """Next-token cross entropy over ``batch["tokens"]`` (B, S) int, with
    the optional ``"prefix"`` (its positions cut off the logits) and
    ``"mask"``."""
    logits, _ = forward(params, batch["tokens"], cfg, mode="train",
                        prefix=batch.get("prefix"))
    if cfg.frontend_seq and "prefix" in batch:
        logits = logits[:, cfg.frontend_seq:]
    mask = batch.get("mask")
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                        mask[:, 1:] if mask is not None else None)


def prefill(params, tokens, cfg, prefix=None):
    return forward(params, tokens, cfg, mode="prefill", prefix=prefix)


def decode_step(params, cache, token, pos, cfg):
    """token (B,) int, pos int → (logits (B, V), cache)."""
    logits, cache = forward(params, token[:, None], cfg, mode="decode",
                            cache=cache, pos=pos)
    return logits[:, 0], cache


class CapturedDecode:
    """``decode_step(params, cache, token, pos, cfg)`` captured once as a
    CUDA graph over one cache, and replayed — the port's counterpart of
    the reference's ``jax.jit(decode_step)``.  The step is the model
    family's: this module's for the decoder-only families,
    :func:`repro_torch.models.encdec.decode_step` over the ``{"self",
    "cross"}`` cache for the encoder-decoder family.

    The graph's static state is the cache (every step writes it in
    place: the stack's layers and the prologue's alike, KV rows and SSM
    states; the encoder-decoder's cross half is only read) and three
    tensors of this object: ``token`` and ``pos``,
    ``(batch,)`` int64 filled before each replay (positions are always
    per row here, never a Python int, which a graph would bake in), and
    ``logits``, ``(batch, vocab)``, which every call returns and the next
    replay overwrites.

    The first call after construction or :meth:`bind` captures: one
    eager step with the call's own token and positions on this object's
    stream (the warm-up — it builds the kernels, sets their
    shared-memory attributes and grows ``codr_matmul``'s split-K scratch,
    none of which may happen inside a capture), the capture, then the
    replay that serves the call.  The warm-up and the replay write the
    same KV rows twice with the same bits (see
    ``repro_torch.core.batching`` on re-run steps); the SSM states
    (:func:`recurrent_state`), which a second run would advance again,
    are saved before the warm-up and put back after it, so the replay
    advances them once.  A failed capture raises; there is no eager
    fallback on the card.  CPU callers run the eager step themselves.

    The split-K scratch that the warm-up grows and the graph reads and
    writes at every replay is this object's own
    (``codr_matmul.ops.scratch_pool``), not the per-stream buffer of
    eager calls, so no other graph or eager call shares it, whatever
    stream replays it.

    ``captures`` and ``replays`` count this object's captures and
    replays.  The kernels' launch counters tick in the warm-up only:
    ``codr_matmul.ops.captured`` counts the calls a capture records, and
    a replay calls no wrapper.
    """

    def __init__(self, params, cache, cfg, batch: int, *, device=None):
        self.params, self.cfg = params, cfg
        if cfg.family == "encdec":
            from repro_torch.models import encdec
            self._step = encdec.decode_step
        else:
            self._step = decode_step
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CapturedDecode needs a CUDA device, got "
                             f"{self.device}; on the CPU call decode_step")
        self.token = torch.zeros(batch, dtype=torch.int64, device=self.device)
        self.pos = torch.zeros(batch, dtype=torch.int64, device=self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._scratch: dict = {}
        self.captures = 0
        self.replays = 0
        self.bind(cache)

    def bind(self, cache) -> None:
        """Serve ``cache`` from now on.  The graph holds the addresses of
        the cache it was captured over, so binding drops it and the next
        call captures again."""
        self.cache = cache
        self.graph = None
        self.logits = None

    def capture(self) -> None:
        """Warm up and capture over the current ``token`` / ``pos``."""
        from repro_torch.kernels.codr_matmul import ops as mm_ops
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(self.device))
        state = recurrent_state(self.cfg, self.cache)
        with mm_ops.scratch_pool(self._scratch):
            with torch.cuda.stream(stream):
                saved = [t.clone() for t in state]
                self._step(self.params, self.cache, self.token, self.pos,
                           self.cfg)
                for t, before in zip(state, saved):
                    t.copy_(before)
                del saved
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                logits, _ = self._step(self.params, self.cache, self.token,
                                       self.pos, self.cfg)
        self.graph, self.logits = graph, logits
        self.captures += 1

    def __call__(self, token, pos) -> torch.Tensor:
        """One step: ``token`` ``(batch,)`` ints (any device), ``pos`` an
        int or ``(batch,)`` ints.  Returns the static ``logits``."""
        self.token.copy_(token)
        if isinstance(pos, int):
            self.pos.fill_(pos)
        else:
            self.pos.copy_(pos)
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        return self.logits
