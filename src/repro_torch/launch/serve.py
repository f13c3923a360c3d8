"""Serving driver: batched prefill + greedy decode from CoDR-compressed
weights — ``run_serve`` of ``repro.launch.serve``, decoder-only branch.

``use_codr=True`` compiles the params tree onto the packed
representation (:func:`repro_torch.api.compile_params`), so every
projection matmul resolves through the backend registry into the
``codr_matmul`` CUDA kernel (its plain version on the CPU) and the
reported weight bytes are measured on the stored packs.  Runs on the
card unless the caller passes ``device="cpu"``.  The command line, the
continuous batcher, chaos and packed-checkpoint modes wait for ROADMAP
A12 / A6 / A7 / A8.
"""
from __future__ import annotations

import time

import torch

import repro_torch.api as codr
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.engine import resolve_device
from repro_torch.core.serving import codr_serving_stats
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import get_model

__all__ = ["greedy_decode", "run_serve"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_decode(api, params, tokens: torch.Tensor, cfg, gen_len: int):
    """Greedy decode over a fresh full-length cache: replay the prompt
    ``tokens`` (B, prompt_len) through ``decode_step``, then generate
    ``gen_len`` tokens (cache shapes stay fixed).  Returns ``(gen (B,
    gen_len) int64 on the tokens' device, cache, decode_step calls)``."""
    batch, prompt_len = tokens.shape
    total = prompt_len + gen_len
    cache = api.init_cache(cfg, batch, total, device=tokens.device)
    out_tokens: list[torch.Tensor] = []
    tok = tokens[:, 0]
    n_steps = 0
    for i in range(total - 1):
        logits, cache = api.decode_step(params, cache, tok, i, cfg)
        n_steps += 1
        if i + 1 < prompt_len:
            tok = tokens[:, i + 1]
        else:
            tok = torch.argmax(logits, dim=-1)
            out_tokens.append(tok)
    gen = (torch.stack(out_tokens, 1) if out_tokens else
           torch.zeros((batch, 0), dtype=torch.int64, device=tokens.device))
    return gen, cache, n_steps


def run_serve(*, arch: str = "qwen2.5-3b", batch: int = 4,
              prompt_len: int = 32, gen_len: int = 32, use_codr: bool = False,
              codr_unique: int = 16, codr_backend: str = "codr_matmul",
              verbose: bool = True, device=None) -> dict:
    """One serving run: prefill + greedy decode on the smoke variant of
    ``arch``, params and prompt drawn from a generator seeded 0.  Returns
    the reference's metrics dict (timings, generated tokens, and — under
    ``use_codr`` — the measured packed-representation bytes)."""
    dev = resolve_device(device)
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(gen, cfg)

    compiled = None
    if use_codr:
        compiled = codr.compile_params(
            params, codr.EncodeConfig(n_unique=codr_unique),
            backend=codr_backend, device=dev)
        params = compiled.params
        if verbose:
            print(compiled.summary())

    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)

    t0 = time.monotonic()
    logits, cache = api.prefill(params, {"tokens": tokens}, cfg)
    _sync(dev)
    t_prefill = time.monotonic() - t0

    t0 = time.monotonic()
    out, cache, n_steps = greedy_decode(api, params, tokens, cfg, gen_len)
    _sync(dev)
    t_decode = time.monotonic() - t0
    gen_np = out.to("cpu", torch.int32).numpy()

    # per executed decode_step call — the prompt is replayed through
    # decode, so dividing by generated tokens alone would overstate it
    ms_per_tok = t_decode / max(n_steps, 1) * 1e3
    kv_bytes = sum(leaf.numel() * leaf.element_size()
                   for _, leaf in leaves_with_path(cache))
    if verbose:
        print(f"prefill {prompt_len} toks: {t_prefill*1e3:.1f} ms; "
              f"decode {n_steps} steps ({gen_np.shape[1]} generated): "
              f"{t_decode*1e3:.1f} ms ({ms_per_tok:.2f} ms/step)")
        if gen_np.size:
            print("sample generation (first row):", gen_np[0][:16])

    result = {
        "arch": arch, "family": cfg.family, "gen": gen_np,
        "prefill_s": t_prefill, "decode_s": t_decode,
        "n_decode_steps": n_steps,
        "ms_per_tok": ms_per_tok,
        "cache_self_len": None,
        "kv_bytes": kv_bytes,
    }
    if compiled is not None:
        # measured on the stored packed representation, not estimated
        result.update(
            hbm_bytes=compiled.hbm_bytes(),
            dense_bf16_bytes=compiled.dense_bf16_bytes(),
            bits_per_weight=compiled.bits_per_weight(),
            n_packed=len(compiled.packed_paths),
            backend=compiled.backend)
        if verbose:
            print(f"weight HBM, measured on the packed representation "
                  f"({compiled.backend}): "
                  f"{compiled.hbm_bytes()/1e6:.3f} MB vs "
                  f"bf16 {compiled.dense_bf16_bytes()/1e6:.3f} MB "
                  f"({compiled.compression_vs_bf16():.1f}x, "
                  f"{compiled.bits_per_weight():.2f} bits/weight)")
    elif verbose:
        stats = codr_serving_stats(cfg, n_unique=codr_unique)
        unit, scale = ("GB", 1.0) if stats["bf16_gb"] > 0.5 else ("MB", 1e3)
        print(f"decode HBM weight traffic/token ({stats['source']}: "
              f"extrapolated from one synthetic matrix, NOT measured — "
              f"full {cfg.name} geometry): "
              f"bf16={stats['bf16_gb']*scale:.2f} {unit}, "
              f"int8={stats['int8_gb']*scale:.2f} {unit}, "
              f"codr(U={codr_unique})≈{stats['codr_gb']*scale:.2f} {unit} "
              f"({stats['codr_bits_per_weight']:.2f} bits/weight)")
    return result
