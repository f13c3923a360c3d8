"""The port's encoder-decoder model (``repro_torch.models.encdec``,
seamless-m4t-medium) and the prefix-fed decoder (internvl2-26b) against
``repro.models`` on the same NumPy inputs, with the reference's weights
carried across by ``convert``; the enc-dec branch of ``run_serve``
(mirroring ``tests/test_serve_driver.py``) and seamless's packed
checkpoint.

Tolerances: float32 within ``1e-4 · max(|JAX|, 1)`` (``F32``), bfloat16
within ``2e-2 · max(|JAX|, 1)`` (``BF16``).  Inside the port, bit for
bit: the ``tiled`` packed lane equals the quantize-applied lane, packs
carried over from JAX serve the port's own packed logits, a packed
checkpoint boots to the same logits, and a decode step writes its
self-attention row into the cache's own buffers and leaves the cross
half as it was.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jcodr
import repro.models.common as jcommon
import repro.models.encdec as jenc
import repro.models.lm as jlm
import repro_torch.api as tcodr
import repro_torch.models.encdec as tenc
import repro_torch.models.lm as tlm
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.batching import ContinuousBatcher
from repro_torch.core.serving import codr_compress_params
from repro_torch.core.tree import leaves_with_path
from repro_torch.launch.serve import (encdec_decode, pad_self_cache,
                                      run_serve)
from repro_torch.models import get_model

F32, BF16 = 1e-4, 2e-2
ENCDEC, VLM = "seamless-m4t-medium", "internvl2-26b"
B, S, N_UNIQUE, N_DECODE = 2, 8, 16, 4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": F32, "bf16": BF16}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _close(t, j, rel: float, what: str = "") -> None:
    """Within ``rel · max(|JAX|, 1)``."""
    t, j = _np(t), _np(j)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    bound = rel * max(float(np.abs(j).max()), 1.0)
    err = float(np.abs(t - j).max())
    assert err <= bound, f"{what}: max-abs err {err} > {bound}"


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)), **changes)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


class _activations:
    """Both packages' model activations in ``dtype`` for the block."""

    def __init__(self, dtype: str):
        self.t, self.j = DTYPES[dtype]

    def __enter__(self):
        self.saved = (tlm.DEFAULT_DTYPE, tenc.DEFAULT_DTYPE,
                      jcommon.DEFAULT_DTYPE, jlm.DEFAULT_DTYPE,
                      jenc.DEFAULT_DTYPE)
        tlm.DEFAULT_DTYPE = tenc.DEFAULT_DTYPE = self.t
        jcommon.DEFAULT_DTYPE = jlm.DEFAULT_DTYPE = jenc.DEFAULT_DTYPE = \
            self.j
        return self

    def __exit__(self, *exc):
        (tlm.DEFAULT_DTYPE, tenc.DEFAULT_DTYPE, jcommon.DEFAULT_DTYPE,
         jlm.DEFAULT_DTYPE, jenc.DEFAULT_DTYPE) = self.saved


@pytest.fixture(scope="module", params=[ENCDEC, VLM])
def model(request):
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return arch, jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def encdec_model():
    jcfg, tcfg = _cfgs(ENCDEC)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    prefix = rng.normal(size=(b, cfg.frontend_seq, cfg.d_model)).astype(
        np.float32)
    return ({"tokens": torch.from_numpy(tokens),
             "prefix": torch.from_numpy(prefix)},
            {"tokens": jnp.asarray(tokens), "prefix": jnp.asarray(prefix)})


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

def test_tree_and_caches_follow_the_reference(model):
    """The same paths and shapes as the port's own init (the encoder and
    decoder stacks, the ungated MLPs); prefill caches and, for
    seamless, ``init_cache``'s ``{"self", "cross"}`` halves alike."""
    arch, jcfg, tcfg, jp, tp = model
    own = get_model(tcfg).init_params(torch.Generator().manual_seed(0), tcfg)
    assert {p: tuple(v.shape) for p, v in leaves_with_path(tp)} == \
        {p: tuple(v.shape) for p, v in leaves_with_path(own)}
    tb, jb = _inputs(tcfg, 1)
    _, tc = get_model(tcfg).prefill(tp, tb, tcfg)
    _, jc = jget_model(jcfg).prefill(jp, jb, jcfg)
    assert [tuple(a.shape) for _, a in leaves_with_path(tc)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jc)]
    tc = get_model(tcfg).init_cache(tcfg, 2, 5, device="cpu")
    jc = jget_model(jcfg).init_cache(jcfg, 2, 5)
    assert [tuple(a.shape) for _, a in leaves_with_path(tc)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jc)]
    if arch == ENCDEC:
        assert "gate_proj" not in tp["enc_stack"]["mlp"]
        assert set(tc) == {"self", "cross"}
        assert tc["cross"][0].shape[2] == tcfg.frontend_seq


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_encode_matches_reference(encdec_model, dtype):
    """Bidirectional GQA, LayerNorm and the ungated ReLU MLP over stub
    frames."""
    jcfg, tcfg, jp, tp = encdec_model
    tb, jb = _inputs(tcfg, 2)
    with _activations(dtype):
        t = tenc.encode(tp, tb["prefix"], tcfg)
        j = jenc.encode(jp, jb["prefix"], jcfg)
    assert t.dtype == DTYPES[dtype][0]
    _close(t, j, TOL[dtype])


def _whole(arch, jcfg, tcfg, jp, tp, dtype: str):
    """Prefill with the prefix, then N_DECODE decode steps: seamless
    from its own prefill cache padded out (``run_serve``'s enc-dec
    loop), internvl on a fresh cache (its decoder-only loop)."""
    tb, jb = _inputs(tcfg, 3)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    total = S + N_DECODE
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size,
                                               (B, total))
    with _activations(dtype) as act:
        lt, tc = tapi.prefill(tp, tb, tcfg)
        lj, jc = japi.prefill(jp, jb, jcfg)
        t, j = [lt], [lj]
        if arch == ENCDEC:
            tc = pad_self_cache(tc, total)
            pad = total - jc["self"][0].shape[2]
            jc = {**jc, "self": tuple(
                jnp.pad(kv, ((0, 0), (0, 0), (0, pad), (0, 0), (0, 0)))
                for kv in jc["self"])}
            start = S
        else:
            tc = tapi.init_cache(tcfg, B, total, dtype=act.t, device="cpu")
            jc = japi.init_cache(jcfg, B, total, dtype=act.j)
            start = 0
        for i in range(start, start + N_DECODE):
            a, tc = tapi.decode_step(tp, tc, torch.from_numpy(tokens[:, i]),
                                     i, tcfg)
            b, jc = japi.decode_step(jp, jc, jnp.asarray(tokens[:, i]),
                                     jnp.int32(i), jcfg)
            t.append(a)
            j.append(b)
    return t, j


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_decode_match_reference(model, dtype):
    """Prefill and 4 decode steps within the bound of ``dtype``."""
    arch, jcfg, tcfg, jp, tp = model
    t, j = _whole(arch, jcfg, tcfg, jp, tp, dtype)
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, TOL[dtype], f"{arch} step {i}")


def test_decode_writes_self_kv_in_place_and_reads_cross(encdec_model):
    """A decode step writes its self-attention row into the cache's own
    buffers at ``pos`` and leaves every cross-attention byte as it
    was."""
    jcfg, tcfg, jp, tp = encdec_model
    tb, _ = _inputs(tcfg, 5)
    api = get_model(tcfg)
    logits, cache = api.prefill(tp, tb, tcfg)
    cache = pad_self_cache(cache, S + 2)
    ptrs = [t.data_ptr() for _, t in leaves_with_path(cache)]
    cross = [t.clone() for t in cache["cross"]]
    before = [t.clone() for t in cache["self"]]
    tok = torch.argmax(logits[:, -1], -1)
    _, out = api.decode_step(tp, cache, tok, S, tcfg)
    assert out is cache
    assert [t.data_ptr() for _, t in leaves_with_path(cache)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(cache["cross"], cross))
    for new, old in zip(cache["self"], before):
        assert torch.equal(new[:, :, :S], old[:, :, :S])
        assert bool(new[:, :, S].abs().sum() > 0)
        assert not bool(new[:, :, S + 1:].any())


def test_cross_attention_runs_the_plain_attention(encdec_model,
                                                  monkeypatch):
    """Cross-attention goes through ``models.attention``'s plain chunked
    and decode attention, as the reference's does, never through the
    ``flash_attention`` kernel's entry point."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import attention as tattn
    _, tcfg, _, tp = encdec_model

    def refuse(*a, **k):
        raise AssertionError("the model called the attention kernel")
    for name in ("flash_attention_kernel", "flash_attention_cuda"):
        monkeypatch.setattr(fa_ops, name, refuse)
    calls = {"flash": 0, "decode": 0}
    real_flash, real_dec = tattn.flash_attention, tattn.decode_attention

    def flash(*a, **k):
        calls["flash"] += 1
        return real_flash(*a, **k)

    def dec(*a, **k):
        calls["decode"] += 1
        return real_dec(*a, **k)
    monkeypatch.setattr(tattn, "flash_attention", flash)
    monkeypatch.setattr(tattn, "decode_attention", dec)
    tb, _ = _inputs(tcfg, 6)
    api = get_model(tcfg)
    logits, cache = api.prefill(tp, tb, tcfg)
    api.decode_step(tp, pad_self_cache(cache, S + 1),
                    torch.argmax(logits[:, -1], -1), S, tcfg)
    layers, enc = tcfg.n_periods, tcfg.n_encoder_layers
    # prefill: the encoder's and the decoder's self-attention (through
    # gqa_forward) plus the decoder's cross-attention; decode: self and
    # cross per decoder layer
    assert calls == {"flash": enc + 2 * layers, "decode": 2 * layers}


# ---------------------------------------------------------------------------
# packed lanes and the packed checkpoint
# ---------------------------------------------------------------------------

def _rows(api, params, cfg, batch, steps):
    """Prefill, then ``steps`` greedy steps (seamless from its padded
    prefill cache, internvl on a fresh cache)."""
    logits, cache = api.prefill(params, batch, cfg)
    out = [logits[:, 0]]
    if cfg.family == "encdec":
        cache, start = pad_self_cache(cache, S + steps), S
    else:
        cache, start = api.init_cache(cfg, B, S + steps, device="cpu"), 0
    tok = torch.argmax(logits[:, -1], -1)
    for i in range(start, start + steps):
        lg, cache = api.decode_step(params, cache, tok, i, cfg)
        out.append(lg)
        tok = torch.argmax(lg, -1)
    return out


def test_tiled_lane_bitwise_vs_quantize_applied(model):
    arch, _, tcfg, _, tp = model
    ref, _ = codr_compress_params(tp, n_unique=N_UNIQUE)
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="tiled", accounting=False,
                              device="cpu")
    api = get_model(tcfg)
    tb, _ = _inputs(tcfg, 7)
    for i, (a, b) in enumerate(zip(_rows(api, ref, tcfg, tb, 3),
                                   _rows(api, cp.params, tcfg, tb, 3))):
        assert torch.equal(a, b), f"{arch} step {i}"


def test_codr_matmul_lane_matches_reference_lane(model):
    arch, _, tcfg, _, tp = model
    ref, _ = codr_compress_params(tp, n_unique=N_UNIQUE)
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="codr_matmul", accounting=False,
                              device="cpu")
    api = get_model(tcfg)
    tb, _ = _inputs(tcfg, 8)
    for i, (a, b) in enumerate(zip(_rows(api, ref, tcfg, tb, 2),
                                   _rows(api, cp.params, tcfg, tb, 2))):
        _close(b, a, 0.02, f"{arch} step {i}")


def test_reference_packs_serve_the_ports_packed_logits(model):
    arch, jcfg, tcfg, jp, tp = model
    jcp = jcodr.compile_params(jp, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=False)
    carried = convert.compiled_params_from_reference(jcp, "cpu")
    own = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=False,
                               device="cpu")
    assert carried.packed_paths == own.packed_paths
    assert carried.embed_paths == own.embed_paths
    for (pa, a), (pb, b) in zip(carried.packed_leaves(),
                                own.packed_leaves()):
        assert pa == pb and a.weight.bits == b.weight.bits
        for x, y in zip((a.weight.packed, a.weight.table, a.weight.scale),
                        (b.weight.packed, b.weight.table, b.weight.scale)):
            assert torch.equal(x.to(y.dtype), y), pa
    api = get_model(tcfg)
    tb, _ = _inputs(tcfg, 9)
    for i, (a, b) in enumerate(zip(_rows(api, carried.params, tcfg, tb, 2),
                                   _rows(api, own.params, tcfg, tb, 2))):
        assert torch.equal(a, b), f"{arch} step {i}"


def test_packed_checkpoint_roundtrip_bit_identical(encdec_model, tmp_path):
    """Mirror of ``tests/test_packed_checkpoint.py::
    test_roundtrip_bit_identical_logits[seamless-m4t-medium]``; and the
    reference's artifact of the same params boots in the port with the
    same packed bytes and logits bits."""
    jcfg, tcfg, jp, tp = encdec_model
    api = get_model(tcfg)
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="codr_matmul", device="cpu")
    tb, _ = _inputs(tcfg, 10, b=2, s=6)
    ref, _ = api.prefill(cp.params, tb, tcfg)
    path = str(tmp_path / "ck.codr")
    assert tcodr.save_packed(cp, path) == path
    cp2 = tcodr.load_packed(path, device="cpu")
    assert torch.equal(api.prefill(cp2.params, tb, tcfg)[0], ref)
    assert cp2.config == cp.config and cp2.backend == cp.backend
    assert cp2.packed_paths == cp.packed_paths
    assert cp2.quantized_paths == cp.quantized_paths
    assert cp2.embed_paths == cp.embed_paths
    assert cp2.reports == cp.reports
    assert cp2.hbm_bytes() == cp.hbm_bytes()
    jcp = jcodr.compile_params(jp, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul")
    jpath = str(tmp_path / "jax.codr")
    jcodr.save_packed(jcp, jpath)
    cp3 = tcodr.load_packed(jpath, device="cpu")
    assert cp3.packed_paths == cp.packed_paths
    assert cp3.reports == cp.reports
    for (_, a), (_, b) in zip(cp3.packed_leaves(), cp.packed_leaves()):
        for x, y in zip((a.weight.packed, a.weight.table, a.weight.scale),
                        (b.weight.packed, b.weight.table, b.weight.scale)):
            assert torch.equal(x.to(y.dtype), y)
    assert torch.equal(api.prefill(cp3.params, tb, tcfg)[0], ref)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_paged_caches_and_the_batcher_refuse_prefix_models(model):
    """A paged spec raises for the enc-dec cache, as in the reference;
    both packages' batchers refuse frontend and enc-dec configs."""
    from repro.core.batching import ContinuousBatcher as JBatcher
    from repro_torch.models.cache import PagedSpec
    arch, jcfg, tcfg, jp, tp = model
    if arch == ENCDEC:
        with pytest.raises(NotImplementedError, match="decoder-only"):
            get_model(tcfg).init_cache(tcfg, 1, 4, device="cpu",
                                       paged=PagedSpec(page_size=2,
                                                       max_len=4, n_slots=1))
    msg = "supports decoder-only LM configs"
    with pytest.raises(NotImplementedError, match=msg):
        ContinuousBatcher(tp, tcfg, n_slots=2, max_len=16, device="cpu")
    with pytest.raises(NotImplementedError, match=msg):
        JBatcher(jp, jcfg, n_slots=2, max_len=16)


# ---------------------------------------------------------------------------
# the serve driver (tests/test_serve_driver.py's enc-dec tests)
# ---------------------------------------------------------------------------

def test_serve_encdec_pads_self_cache_and_generates():
    res = run_serve(arch=ENCDEC, batch=2, prompt_len=4, gen_len=3,
                    verbose=False, device="cpu")
    assert res["family"] == "encdec"
    assert res["gen"].shape == (2, 3)
    assert res["cache_self_len"] == 4 + 3      # padded to total
    assert res["n_decode_steps"] == 2
    assert np.isfinite(res["gen"]).all()


def test_serve_encdec_gen_len_zero():
    res = run_serve(arch=ENCDEC, batch=1, prompt_len=4, gen_len=0,
                    verbose=False, device="cpu")
    assert res["gen"].shape == (1, 0)
    assert res["cache_self_len"] == 4          # nothing to pad


def test_encdec_decode_from_padded_prefill_cache_matches_prefill():
    """The padded-cache decode step reproduces a one-token-longer
    prefill (float32, rel < 1e-4): the pad leaves masked tail positions
    inert and the kept cross cache carries the real encoder output."""
    cfg = smoke_variant(get_config(ENCDEC))
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg)
    prefix = torch.randn((1, cfg.frontend_seq, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 5), generator=gen)
    with _activations("f32"):
        lg_full, _ = api.prefill(params, {"tokens": tokens,
                                          "prefix": prefix}, cfg)
        _, cache = api.prefill(params, {"tokens": tokens[:, :4],
                                        "prefix": prefix}, cfg)
        cache = pad_self_cache(cache, 5)
        lg_step, _ = api.decode_step(params, cache, tokens[:, 4], 4, cfg)
    ref = lg_full[:, -1]
    rel = float((lg_step - ref).abs().max()) / max(float(ref.abs().max()),
                                                   1e-6)
    assert rel < 1e-4, rel


def test_encdec_decode_is_the_serve_loop():
    """``encdec_decode`` (the loop ``run_serve`` runs) gives the tokens
    of the same greedy steps driven by hand."""
    cfg = smoke_variant(get_config(ENCDEC))
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(1)
    params = api.init_params(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4),
                                     generator=gen),
             "prefix": torch.randn((2, cfg.frontend_seq, cfg.d_model),
                                   generator=gen)}
    logits, cache = api.prefill(params, batch, cfg)
    gen_tok, _, n = encdec_decode(api, params, pad_self_cache(cache, 7),
                                  logits, cfg, 4, 3)
    assert n == 2 and tuple(gen_tok.shape) == (2, 3)
    logits, cache = api.prefill(params, batch, cfg)
    cache = pad_self_cache(cache, 7)
    tok = torch.argmax(logits[:, -1], -1)
    want = [tok]
    for i in (4, 5):
        lg, cache = api.decode_step(params, cache, tok, i, cfg)
        tok = torch.argmax(lg, -1)
        want.append(tok)
    assert torch.equal(gen_tok, torch.stack(want, 1))


@pytest.mark.parametrize("backend", ["tiled", "codr_matmul"])
def test_serve_codr_encdec(backend):
    res = run_serve(arch=ENCDEC, batch=1, prompt_len=4, gen_len=2,
                    use_codr=True, codr_backend=backend, verbose=False,
                    device="cpu")
    assert res["gen"].shape == (1, 2)
    assert res["hbm_bytes"] > 0
    assert res["backend"] == backend


@pytest.mark.parametrize("use_codr", [False, True])
def test_run_serve_returns_the_reference_keys(model, use_codr, capsys):
    """The same keys, shapes, step counts, cache bytes and padded
    self-cache length as the reference's ``run_serve``."""
    from repro.launch.serve import run_serve as jrun_serve
    arch = model[0]
    kw = dict(arch=arch, batch=2, prompt_len=4, gen_len=3,
              use_codr=use_codr, codr_backend="tiled")
    j = jrun_serve(verbose=False, **kw)
    t = run_serve(device="cpu", **kw)
    assert set(t) == set(j)
    assert t["family"] == j["family"]
    assert t["gen"].shape == j["gen"].shape == (2, 3)
    assert t["n_decode_steps"] == j["n_decode_steps"]
    assert t["kv_bytes"] == j["kv_bytes"]
    assert t["cache_self_len"] == j["cache_self_len"]
    assert "prefill 4 toks" in capsys.readouterr().out
    if use_codr:
        assert t["n_packed"] == j["n_packed"]
        assert t["hbm_bytes"] == pytest.approx(j["hbm_bytes"], rel=0.2)
