"""The port's transformer serving slice against the JAX reference: a
three-layer ``smoke_variant("qwen2.5-3b")`` (so the layer loop runs)
with params made by JAX and carried over with
``convert.params_from_reference``.

* ``tiled`` and ``codr_matmul`` lanes, prefill + 4 teacher-forced decode
  steps: logits within ``0.02 · max(|JAX|max, 1)`` of JAX's, argmax equal
  wherever JAX's top-2 margin exceeds that bound (the bound of
  ``tests/test_transformer_executor.py``; XLA and torch round bfloat16
  activations at different places).
* inside the port, bit for bit: the ``tiled`` packed lane equals the
  quantize-applied lane of ``codr_compress_params``, and packs carried
  over from JAX serve the same logits as the port's own packs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jcodr
import repro_torch.api as tcodr
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.codr_linear import PackedEmbedding, PackedLinear
from repro_torch.core.serving import codr_compress_params
from repro_torch.launch.serve import run_serve
from repro_torch.models import get_model

B, S, N_UNIQUE, N_DECODE = 2, 8, 16, 4
ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module")
def setup():
    """(JAX cfg, JAX api, JAX params, port cfg, port api, port params,
    tokens) for the three-layer smoke model."""
    jcfg = dataclasses.replace(jsmoke(jget_config(ARCH)), n_layers=3)
    tcfg = dataclasses.replace(smoke_variant(get_config(ARCH)), n_layers=3)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    # random biases and norm gains, so those leaves are exercised too
    rng = np.random.default_rng(0)
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape).astype(np.float32) * 0.5
                         + (1.0 if "norm" in jax.tree_util.keystr(path)
                            else 0.0))
        if ("bias" in jax.tree_util.keystr(path)
            or "norm" in jax.tree_util.keystr(path)) else np.asarray(a),
        jparams)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = convert.params_from_reference(np_params, "cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S))
    return jcfg, japi, jparams, tcfg, tapi, tparams, tokens


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _assert_close_to_reference(t, j, what):
    """The slice's bound: within ``0.02 · max(|JAX|max, 1)``, argmax equal
    where JAX's top-2 margin exceeds the bound."""
    t, j = _f32(t).reshape(-1, _f32(t).shape[-1]), _f32(j).reshape(
        -1, _f32(j).shape[-1])
    bound = 0.02 * max(np.abs(j).max(), 1.0)
    err = np.abs(t - j).max()
    assert err <= bound, f"{what}: max-abs err {err} > {bound}"
    top2 = np.sort(j, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > bound
    np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear],
                                  err_msg=what)


def _run_jax(api, params, cfg, tokens):
    """JAX prefill + N_DECODE decode steps; the decode steps are fed
    JAX's own argmax.  Returns (logits list, fed tokens)."""
    lg, _ = api.prefill(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                        cfg)
    out, fed = [lg], []
    cache = api.init_cache(cfg, B, S)
    tok = jnp.asarray(tokens[:, 0], jnp.int32)
    for i in range(N_DECODE):
        fed.append(np.asarray(tok))
        lg, cache = api.decode_step(params, cache, tok, jnp.int32(i), cfg)
        out.append(lg)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return out, fed


def _run_port(api, params, cfg, tokens, fed):
    """The port's prefill + decode steps, teacher-forced with ``fed``."""
    lg, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    out = [lg]
    cache = api.init_cache(cfg, B, S, device="cpu")
    for i, tok in enumerate(fed):
        lg, cache = api.decode_step(params, cache,
                                    torch.from_numpy(tok.astype(np.int64)),
                                    i, cfg)
        out.append(lg)
    return out


@pytest.mark.parametrize("backend", ["tiled", "codr_matmul"])
def test_packed_lane_matches_reference(setup, backend):
    jcfg, japi, jparams, tcfg, tapi, tparams, tokens = setup
    jcp = jcodr.compile_params(jparams, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend=backend, accounting=False)
    tcp = tcodr.compile_params(tparams, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend=backend, accounting=False,
                               device="cpu")
    assert tcp.packed_paths == jcp.packed_paths
    assert tcp.embed_paths == jcp.embed_paths
    assert tcp.quantized_paths == jcp.quantized_paths
    assert tcp.hbm_bytes() == jcp.hbm_bytes()
    assert tcp.dense_bf16_bytes() == jcp.dense_bf16_bytes()
    j_out, fed = _run_jax(japi, jcp.params, jcfg, tokens)
    t_out = _run_port(tapi, tcp.params, tcfg, tokens, fed)
    assert t_out[0].shape == (B, 1, tcfg.vocab_size)
    assert t_out[1].shape == (B, tcfg.vocab_size)
    for step, (t, j) in enumerate(zip(t_out, j_out)):
        _assert_close_to_reference(t, j, f"{backend} step {step}")


def test_dense_params_match_reference(setup):
    """The uncompressed model: the same forward on the same params."""
    jcfg, japi, jparams, tcfg, tapi, tparams, tokens = setup
    j_out, fed = _run_jax(japi, jparams, jcfg, tokens)
    t_out = _run_port(tapi, tparams, tcfg, tokens, fed)
    for step, (t, j) in enumerate(zip(t_out, j_out)):
        _assert_close_to_reference(t, j, f"dense step {step}")


def test_tiled_lane_equals_quantize_applied_lane_bitwise(setup):
    """Inside the port: serving from the packs through decode-then-matmul
    (``tiled``) equals serving the quantize-applied dense params."""
    *_, tcfg, tapi, tparams, tokens = setup
    ref_params, reports = codr_compress_params(tparams, n_unique=N_UNIQUE)
    assert reports
    cp = tcodr.compile_params(tparams, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="tiled", accounting=False,
                              device="cpu")
    fed = [tokens[:, i] for i in range(N_DECODE)]
    for a, b in zip(_run_port(tapi, ref_params, tcfg, tokens, fed),
                    _run_port(tapi, cp.params, tcfg, tokens, fed)):
        np.testing.assert_array_equal(_f32(a), _f32(b))


def test_packs_from_reference_serve_the_ports_logits(setup):
    """``compiled_params_from_reference`` carries JAX's packs over without
    re-encoding; they are the port's own packs byte for byte, so the
    logits are bit-identical."""
    jcfg, japi, jparams, tcfg, tapi, tparams, tokens = setup
    jcp = jcodr.compile_params(jparams, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=True,
                               sample_rows=16)
    carried = convert.compiled_params_from_reference(jcp, "cpu")
    own = tcodr.compile_params(tparams, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=True,
                               sample_rows=16, device="cpu")
    assert carried.packed_paths == own.packed_paths
    assert carried.hbm_bytes() == own.hbm_bytes()
    assert [vars(r) for r in carried.reports] == \
        [vars(r) for r in own.reports]
    assert carried.summary() == own.summary() == jcp.summary()
    kinds = {type(leaf) for _, leaf in carried.packed_leaves()}
    assert kinds == {PackedLinear, PackedEmbedding}
    fed = [tokens[:, i] for i in range(N_DECODE)]
    for a, b in zip(_run_port(tapi, carried.params, tcfg, tokens, fed),
                    _run_port(tapi, own.params, tcfg, tokens, fed)):
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("use_codr", [False, True])
def test_run_serve_returns_the_reference_keys(use_codr, capsys):
    from repro.launch.serve import run_serve as jrun_serve
    kw = dict(batch=2, prompt_len=4, gen_len=3, use_codr=use_codr,
              codr_backend="tiled")
    j = jrun_serve(verbose=False, **kw)
    t = run_serve(device="cpu", **kw)
    assert set(t) == set(j)
    assert t["gen"].shape == j["gen"].shape == (2, 3)
    assert t["n_decode_steps"] == j["n_decode_steps"] == 6
    assert t["kv_bytes"] == j["kv_bytes"]
    out = capsys.readouterr().out
    assert "prefill 4 toks" in out and "sample generation" in out
    if use_codr:
        assert t["n_packed"] == j["n_packed"]
        assert t["hbm_bytes"] == pytest.approx(j["hbm_bytes"], rel=0.2)
        assert "measured on the packed representation" in out


def test_unported_paths_raise_with_the_roadmap_item(setup):
    jcfg, *_ = setup
    with pytest.raises(KeyError, match="A5"):
        get_config("deepseek-v2-236b")
    mla = dataclasses.replace(smoke_variant(get_config(ARCH)), use_mla=True)
    with pytest.raises(NotImplementedError, match="A5"):
        get_model(mla).init_params(torch.Generator().manual_seed(0), mla)
    encdec = dataclasses.replace(smoke_variant(get_config(ARCH)),
                                 family="encdec")
    with pytest.raises(NotImplementedError, match="A5"):
        get_model(encdec)
    cfg = smoke_variant(get_config(ARCH))
    with pytest.raises(NotImplementedError, match="A6"):
        get_model(cfg).init_cache(cfg, 1, 4, paged=object(), device="cpu")


def test_entry_points_default_to_the_card():
    cfg = smoke_variant(get_config(ARCH))
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    calls = [lambda: api.init_cache(cfg, 1, 4),
             lambda: tcodr.compile_params(params, accounting=False),
             lambda: run_serve(batch=1, prompt_len=2, gen_len=1,
                               verbose=False)]
    if torch.cuda.is_available():      # with a card they run there
        assert api.init_cache(cfg, 1, 4)["stack"]["b0"][0].is_cuda
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
