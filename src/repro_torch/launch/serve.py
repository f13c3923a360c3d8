"""Serving driver: batched prefill + greedy decode from CoDR-compressed
weights — ``run_serve`` and ``run_serve_continuous`` of
``repro.launch.serve``.

``use_codr=True`` compiles the params tree onto the packed
representation (:func:`repro_torch.api.compile_params`), so every
projection matmul resolves through the backend registry into the
``codr_matmul`` CUDA kernel (its plain version on the CPU) and the
reported weight bytes are measured on the stored packs.  Runs on the
card unless the caller passes ``device="cpu"``; there the decode step is
captured once as a CUDA graph and replayed (prefill stays eager).

``arch`` (``--arch``) names any of the ten configurations of the
registry — the dense family (qwen2.5-3b, qwen1.5-4b, qwen3-32b,
command-r-plus-104b), the MLA / MoE family (deepseek-v2-236b,
granite-moe-1b-a400m), the SSM and hybrid models (xlstm-350m,
jamba-v0.1-52b), the vision-prefixed internvl2-26b and the
encoder-decoder seamless-m4t-medium; as in the reference, a run serves
its smoke variant.  A frontend or encoder-decoder model gets a random
``(batch, frontend_seq, d_model)`` prefix, the frontend stub.  The
decoder-only loop replays the prompt through decode on a fresh cache
(so a frontend model's decode never sees its prefix, as in the
reference); the encoder-decoder loop continues from the prefill cache,
its self-attention KV padded out to ``prompt_len + gen_len`` and its
cross-attention KV kept.  The continuous batcher serves decoder-only
models without a frontend.

``packed_ckpt=PATH`` (``--packed-ckpt``) boots from a packed checkpoint
artifact (:func:`repro_torch.api.save_packed`): if PATH exists it is
mapped (no re-encode); otherwise the run compiles once, saves the
artifact and reloads it.  Packed boots default to the int8 paged KV
cache.  ``chaos_seed`` (``--chaos SEED``) arms a seeded fault plan over
the batcher's sites with retry and restart budgets sized to it.

    python -m repro_torch.launch.serve --continuous --chaos 0 \
        --packed-ckpt PATH --check
    python -m repro_torch.launch.serve --arch deepseek-v2-236b --codr
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

import repro_torch.api as codr
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.engine import resolve_device
from repro_torch.core.serving import codr_serving_stats
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import get_model

__all__ = ["greedy_decode", "pad_self_cache", "encdec_decode", "run_serve",
           "run_serve_continuous", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_decode(api, params, tokens: torch.Tensor, cfg, gen_len: int, *,
                  eager: bool = False):
    """Greedy decode over a fresh full-length cache: replay the prompt
    ``tokens`` (B, prompt_len) through ``decode_step``, then generate
    ``gen_len`` tokens (cache shapes stay fixed).  Returns ``(gen (B,
    gen_len) int64 on the tokens' device, cache, decode_step calls)``.

    On the card the step is captured once as a CUDA graph
    (:class:`repro_torch.models.lm.CapturedDecode`) and replayed, the
    position filled into its static buffer each step; the CPU, and
    ``eager=True`` (tests and ``chip_smoke.py``), call ``decode_step``."""
    from repro_torch.models.lm import CapturedDecode
    batch, prompt_len = tokens.shape
    total = prompt_len + gen_len
    cache = api.init_cache(cfg, batch, total, device=tokens.device)
    step = (None if eager or tokens.device.type != "cuda" else
            CapturedDecode(params, cache, cfg, batch, device=tokens.device))
    out_tokens: list[torch.Tensor] = []
    tok = tokens[:, 0]
    n_steps = 0
    for i in range(total - 1):
        if step is None:
            logits, cache = api.decode_step(params, cache, tok, i, cfg)
        else:
            logits = step(tok, i)
        n_steps += 1
        if i + 1 < prompt_len:
            tok = tokens[:, i + 1]
        else:
            tok = torch.argmax(logits, dim=-1)
            out_tokens.append(tok)
    gen = (torch.stack(out_tokens, 1) if out_tokens else
           torch.zeros((batch, 0), dtype=torch.int64, device=tokens.device))
    return gen, cache, n_steps


def pad_self_cache(cache: dict, total: int) -> dict:
    """An encoder-decoder prefill cache with its self-attention KV padded
    with zeros out to ``total`` positions (decode writes the positions
    from the prompt's length on; the tail stays masked until written) and
    its cross-attention KV kept.  The padded halves are new tensors."""
    pad = total - cache["self"][0].shape[2]
    if pad <= 0:
        return cache
    return {**cache, "self": tuple(
        torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
        for kv in cache["self"])}


def encdec_decode(api, params, cache, logits: torch.Tensor, cfg,
                  prompt_len: int, gen_len: int, *, eager: bool = False):
    """Greedy decode continuing an encoder-decoder prefill: the first
    token from the prefill ``logits``, then ``gen_len - 1`` steps over
    ``cache`` (already padded to ``prompt_len + gen_len``) at positions
    ``prompt_len`` on.  Returns ``(gen (B, gen_len) int64, cache,
    decode_step calls)``.  On the card the step is captured once over
    ``cache`` and replayed, as in :func:`greedy_decode`."""
    from repro_torch.models.lm import CapturedDecode
    batch = logits.shape[0]
    total = prompt_len + gen_len
    step = (None if eager or logits.device.type != "cuda" else
            CapturedDecode(params, cache, cfg, batch, device=logits.device))
    tok = torch.argmax(logits[:, -1], dim=-1)
    out_tokens = [tok] if gen_len > 0 else []
    n_steps = 0
    for i in range(prompt_len, total - 1):
        if step is None:
            logits, cache = api.decode_step(params, cache, tok, i, cfg)
        else:
            logits = step(tok, i)
        n_steps += 1
        tok = torch.argmax(logits, dim=-1)
        out_tokens.append(tok)
    gen = (torch.stack(out_tokens, 1) if out_tokens else
           torch.zeros((batch, 0), dtype=torch.int64, device=logits.device))
    return gen, cache, n_steps


def run_serve(*, arch: str = "qwen2.5-3b", batch: int = 4,
              prompt_len: int = 32, gen_len: int = 32, use_codr: bool = False,
              codr_unique: int = 16, codr_backend: str = "codr_matmul",
              verbose: bool = True, device=None) -> dict:
    """One serving run: prefill + greedy decode on the smoke variant of
    ``arch``, params, prompt and prefix drawn from a generator seeded 0.
    Returns the reference's metrics dict (timings, generated tokens, the
    encoder-decoder's padded self-cache length, and — under ``use_codr``
    — the measured packed-representation bytes).  The decode loop
    replays a captured step on the card (:func:`greedy_decode`,
    :func:`encdec_decode`)."""
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
    batch_in = {"tokens": tokens}
    if cfg.frontend or cfg.family == "encdec":
        batch_in["prefix"] = torch.randn(
            (batch, cfg.frontend_seq, cfg.d_model), generator=gen,
            device=dev)

    t0 = time.monotonic()
    logits, cache = api.prefill(params, batch_in, cfg)
    _sync(dev)
    t_prefill = time.monotonic() - t0

    cache_self_len = None
    t0 = time.monotonic()
    if cfg.family == "encdec":
        cache = pad_self_cache(cache, prompt_len + gen_len)
        cache_self_len = int(cache["self"][0].shape[2])
        out, cache, n_steps = encdec_decode(api, params, cache, logits, cfg,
                                            prompt_len, gen_len)
    else:
        out, cache, n_steps = greedy_decode(api, params, tokens, cfg,
                                            gen_len)
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
        "cache_self_len": cache_self_len,
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


def _boot_packed(api, cfg, gen, path: str, *, codr_unique: int,
                 codr_backend: str, device, verbose: bool):
    """``(CompiledParams, boot seconds)`` from the artifact at ``path``,
    compiling and saving it first when it does not exist."""
    if not os.path.exists(path):
        # self-contained: compile once and persist the artifact, then
        # boot from it like any later run would
        params = api.init_params(gen, cfg)
        t0 = time.monotonic()
        cp = codr.compile_params(
            params, codr.EncodeConfig(n_unique=codr_unique),
            backend=codr_backend, device=device)
        codr.save_packed(cp, path)
        if verbose:
            print(f"packed checkpoint written to {path} "
                  f"({time.monotonic() - t0:.2f}s compile+save)")
    t0 = time.monotonic()
    compiled = codr.load_packed(path, device=device)
    _sync(device)
    boot_s = time.monotonic() - t0
    if verbose:
        print(f"booted from packed checkpoint {path} in "
              f"{boot_s * 1e3:.1f} ms (format v{codr.CODR_FORMAT_VERSION}, "
              f"mmap)")
        print(compiled.summary())
    return compiled, boot_s


def run_serve_continuous(*, arch: str = "qwen2.5-3b", n_requests: int = 4,
                         n_slots: int = 4, prompt_len: int = 8,
                         gen_len: int = 8, max_len: int = 64,
                         use_codr: bool = False, codr_unique: int = 16,
                         codr_backend: str = "codr_matmul",
                         check: bool = False, seed: int = 0,
                         chaos_seed: int | None = None,
                         kv_dtype: str | None = None,
                         kv_page_size: int | None = None,
                         packed_ckpt: str | None = None,
                         verbose: bool = True, device=None) -> dict:
    """Continuous-batching serving run: ``n_requests`` mixed-length
    prompts streamed through a :class:`repro_torch.core.batching
    .ContinuousBatcher` slot pool on the smoke variant of ``arch``,
    params drawn from a generator seeded ``seed``.  With ``check=True``
    every streamed output is asserted bit-identical to the sequential
    solo-decode reference on the same params; lossy KV modes
    (``kv_dtype="int8"``) additionally replay the dense-cache
    reference's tokens teacher-forced through the paged pipeline and
    bound the per-step logit deviation (0.10 of the dense logit
    spread).  Returns the reference's metrics dict.

    ``packed_ckpt`` boots the weights from a packed checkpoint artifact
    (saving one first if the path does not exist) and — unless
    overridden — turns on the int8 paged KV cache.

    ``chaos_seed`` arms a deterministic fault plan
    (:meth:`repro_torch.runtime.resilience.FaultPlan.seeded` over the
    batcher's worker/prefill/decode sites: transient dispatch errors,
    injected latency, worker crashes) with retry and restart budgets
    sized to the plan; every request must still finish with the bits
    of a clean run, which ``check=True`` asserts."""
    from repro_torch.core.batching import ContinuousBatcher
    from repro_torch.runtime import resilience as res

    dev = resolve_device(device)
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    if kv_dtype is None:
        # packed boots default to the int8 paged cache; plain runs keep
        # the dense bf16 pool
        kv_dtype = "int8" if packed_ckpt is not None else "bf16"
    if kv_dtype == "int8" and kv_page_size is None:
        kv_page_size = 4 if max_len <= 128 else 16

    compiled = None
    boot_s = None
    if packed_ckpt is not None:
        compiled, boot_s = _boot_packed(
            api, cfg, gen, packed_ckpt, codr_unique=codr_unique,
            codr_backend=codr_backend, device=dev, verbose=verbose)
        params = compiled.params
    else:
        params = api.init_params(gen, cfg)
        if use_codr:
            compiled = codr.compile_params(
                params, codr.EncodeConfig(n_unique=codr_unique),
                backend=codr_backend, device=dev)
            params = compiled.params
            if verbose:
                print(compiled.summary())

    rng = np.random.default_rng(seed)
    # mixed prompt lengths around prompt_len: the join-on-prefill path
    # must handle ragged admissions
    lens = [max(1, prompt_len + (i % 3) - 1) for i in range(n_requests)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lens]
    max_len = max(max_len, max(lens) + gen_len)    # pool must fit every req

    batcher = ContinuousBatcher(params, cfg, n_slots=n_slots,
                                max_len=max_len, kv_dtype=kv_dtype,
                                kv_page_size=kv_page_size, device=dev)
    injector = None
    if chaos_seed is not None:
        plan = res.FaultPlan.seeded(
            chaos_seed,
            (res.SITE_BATCHER_WORKER, res.SITE_BATCHER_PREFILL,
             res.SITE_BATCHER_DECODE),
            n_faults=4, max_call=max(4, n_requests * gen_len // 2),
            latency_s=0.002)
        injector = res.FaultInjector(plan)
        # budgets sized to the plan: every injected fault is survivable,
        # so the run must finish with bit-identical outputs
        batcher.configure_resilience(
            injector=injector,
            retry_policy=res.RetryPolicy(max_retries=max(2, len(plan)),
                                         backoff_s=0.001),
            restart_policy=res.RestartPolicy(
                max_restarts=max(1, len(plan)), backoff_s=0.001))
        if verbose:
            print(f"chaos seed {chaos_seed}: {plan.describe()}")
    t0 = time.monotonic()
    handles = [batcher.submit(p, max_new_tokens=gen_len) for p in prompts]
    streamed = [[tok for tok in h] for h in handles]
    t_total = time.monotonic() - t0
    batcher.stop_async()

    n_tokens = sum(len(s) for s in streamed)
    toks_per_s = n_tokens / max(t_total, 1e-9)
    kv_bytes = batcher.kv_bytes()
    if verbose:
        print(f"continuous batching: {n_requests} requests "
              f"(prompt lens {lens}) over {n_slots} slots → "
              f"{n_tokens} tokens in {t_total*1e3:.1f} ms "
              f"({toks_per_s:.1f} tok/s); steps={batcher.steps_run} "
              f"prefills={batcher.prefills_run} "
              f"peak_active={batcher.peak_active}")
        print(f"KV pool: {kv_dtype}"
              + (f" paged (page_size={kv_page_size})"
                 if kv_page_size is not None else " dense")
              + f", {kv_bytes/1e3:.1f} kB resident")
        if injector is not None:
            print(f"chaos: {len(injector.fired)}/{len(injector.plan)} "
                  f"scheduled faults fired "
                  f"({[f'{f.site}#{f.at_call}:{f.kind}' for f in injector.fired]}); "
                  f"worker crashes={batcher.worker_crashes} "
                  f"restarts={batcher.worker_restarts}")
        if compiled is not None:
            stats = codr_serving_stats(cfg, reports=compiled.reports)
            print(f"weight HBM ({stats['source']} on this model's "
                  f"tensors): {compiled.hbm_bytes()/1e6:.3f} MB packed, "
                  f"{stats['pack_bits_per_weight']:.2f} pack bits/weight")
    matched = None
    check_dev = None
    if check:
        matched = 0
        # a dense-cache twin on the SAME served params is the oracle for
        # paged modes: bf16-paged must reproduce its tokens bit-exactly;
        # int8 is lossy, so its contract is the teacher-forced logit
        # bound (free-running greedy legitimately diverges on near-tied
        # logits — see ContinuousBatcher.replay_logits)
        dense_ref = (ContinuousBatcher(params, cfg, n_slots=n_slots,
                                       max_len=max_len, device=dev)
                     if kv_page_size is not None else batcher)
        for p, s in zip(prompts, streamed):
            same, _ = batcher.generate_reference(p, max_new_tokens=gen_len)
            if s != same:
                raise AssertionError(
                    f"streamed output diverged from the sequential "
                    f"reference: {s} vs {same}")
            dense_toks, _ = dense_ref.generate_reference(
                p, max_new_tokens=gen_len)
            if kv_dtype == "int8":
                dense_rows = dense_ref.replay_logits(p, dense_toks)
                paged_rows = batcher.replay_logits(p, dense_toks)
                if not np.array_equal(paged_rows[0], dense_rows[0]):
                    raise AssertionError("prefill logits must be bit-exact "
                                         "across KV modes")
                spread = float(dense_rows.max() - dense_rows.min()) or 1.0
                dev_ = float(np.abs(paged_rows - dense_rows).max()) / spread
                check_dev = max(check_dev or 0.0, dev_)
                if not dev_ < 0.10:
                    raise AssertionError(
                        f"int8-paged teacher-forced logits deviate "
                        f"{dev_:.4f} of the dense logit spread (bound 0.10)")
            elif s != dense_toks:
                raise AssertionError(
                    f"bf16 KV must match the dense-cache reference "
                    f"bit-exactly: {s} vs {dense_toks}")
            matched += 1
        if verbose:
            print(f"check: {matched}/{n_requests} streamed outputs "
                  f"verified against the dense-cache sequential "
                  f"reference"
                  + (f" (worst teacher-forced logit deviation "
                     f"{check_dev:.4f} of spread, bound 0.10)"
                     if check_dev is not None else " (bit-identical)"))

    return {
        "arch": arch, "n_requests": n_requests, "n_slots": n_slots,
        "prompt_lens": lens, "gen": streamed, "total_s": t_total,
        "tokens_per_s": toks_per_s, "steps_run": batcher.steps_run,
        "prefills_run": batcher.prefills_run,
        "peak_active": batcher.peak_active, "checked": matched,
        "backend": compiled.backend if compiled is not None else None,
        "chaos_seed": chaos_seed,
        "faults_fired": (len(injector.fired) if injector is not None
                         else None),
        "worker_restarts": batcher.worker_restarts,
        "kv_dtype": kv_dtype, "kv_page_size": kv_page_size,
        "kv_bytes": kv_bytes, "boot_s": boot_s,
        "packed_ckpt": packed_ckpt, "check_dev": check_dev,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve the smoke variant of a model from CoDR-packed "
                    "weights on the card (the reference's serve CLI).")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--codr", action="store_true",
                    help="serve from the packed CoDR weight representation")
    ap.add_argument("--codr-unique", type=int, default=16,
                    help="unique-weight budget per tensor (paper Fig. 6 U)")
    ap.add_argument("--codr-backend", default="codr_matmul",
                    help="packed-matmul backend: codr_matmul (fused "
                         "decode+matmul kernel) or tiled (decode-then-"
                         "matmul reference lane)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching mode: stream --requests "
                         "concurrent mixed-length prompts through a "
                         "slot-pooled decode loop")
    ap.add_argument("--requests", type=int, default=4,
                    help="concurrent requests (--continuous)")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache pool slots (--continuous)")
    ap.add_argument("--check", action="store_true",
                    help="assert streamed outputs are bit-identical to "
                         "the sequential reference (--continuous)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="inject a deterministic seeded fault plan "
                         "(dispatch errors, latency, worker crashes) "
                         "into the continuous-batching run; combine "
                         "with --check to assert outputs survive "
                         "bit-identically (--continuous)")
    ap.add_argument("--packed-ckpt", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="boot from a packed checkpoint artifact "
                         "(codr.save_packed); writes one first if PATH "
                         "is missing.  Without PATH a per-arch default "
                         "in the working directory is used.  Implies "
                         "--kv-dtype int8 unless overridden "
                         "(--continuous)")
    ap.add_argument("--kv-dtype", choices=("bf16", "int8"), default=None,
                    help="KV cache storage: bf16 (bit-identical; dense "
                         "unless --kv-page-size) or int8 (quantized "
                         "paged) (--continuous)")
    ap.add_argument("--kv-page-size", type=int, default=None,
                    help="tokens per KV page; enables the paged pool "
                         "for bf16 too (--continuous)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    packed_ckpt = args.packed_ckpt
    if packed_ckpt == "":
        packed_ckpt = f"codr_packed_{args.arch.replace('/', '_')}.codr"
    if args.continuous:
        run_serve_continuous(
            arch=args.arch, n_requests=args.requests, n_slots=args.slots,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            use_codr=args.codr, codr_unique=args.codr_unique,
            codr_backend=args.codr_backend, check=args.check,
            chaos_seed=args.chaos, kv_dtype=args.kv_dtype,
            kv_page_size=args.kv_page_size, packed_ckpt=packed_ckpt,
            device=args.device)
    else:
        run_serve(arch=args.arch, batch=args.batch,
                  prompt_len=args.prompt_len, gen_len=args.gen_len,
                  use_codr=args.codr, codr_unique=args.codr_unique,
                  codr_backend=args.codr_backend, device=args.device)


if __name__ == "__main__":
    main()
