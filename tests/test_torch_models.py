"""The port's model building blocks (``repro_torch.models``) against
``repro.models``, module by module, on the same NumPy inputs.

Float32 inputs: the two frameworks compute the same float32 math in
another order, so comparisons hold rtol/atol 1e-5 (1e-4 through the
exponentials of attention).  Bfloat16 activations round at different
places in XLA and torch: those comparisons hold one bf16 step (2e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-5)
EXP = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("f32", [True, False])
def test_norms_match_reference(f32):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    w = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tcommon.rms_norm(_t(x), _t(w), f32=f32)),
        _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), f32=f32)), **F32)
    np.testing.assert_allclose(
        _np(tcommon.layer_norm(_t(x), _t(w), _t(b), f32=f32)),
        _np(jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b), f32=f32)), **EXP)
    for kind in ("rmsnorm", "layernorm"):
        p = tcommon.norm_init(64, kind, lead=(3,))
        jp = jcommon.norm_init(64, kind)
        assert set(p) == set(jp) and p["w"].shape == (3, 64)
    xb = x.astype(jnp.bfloat16)
    np.testing.assert_allclose(
        _np(tcommon.rms_norm(_t(x, torch.bfloat16), _t(w))),
        _np(jcommon.rms_norm(jnp.asarray(xb), jnp.asarray(w))), **BF16)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations_match_reference(name):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(_np(tcommon.act_fn(name)(_t(x))),
                               _np(jcommon.act_fn(name)(jnp.asarray(x))),
                               **F32)


def test_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32)[None], (2, 6))
    np.testing.assert_array_equal(tcommon.rope_freqs(16, 1e6),
                                  jcommon.rope_freqs(16, 1e6))
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(_t(x), torch.from_numpy(pos.copy()), 1e6)),
        _np(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        **EXP)


@pytest.mark.parametrize("sq,qc,kc", [(8, 8, 8), (16, 4, 8), (12, 5, 3)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4), (6, 1)])
def test_flash_attention_matches_reference(sq, qc, kc, causal, hq, hkv):
    rng = np.random.default_rng(sq + qc + hq)
    q = rng.normal(size=(2, sq, hq, 8)).astype(np.float32)
    k = rng.normal(size=(2, sq, hkv, 8)).astype(np.float32)
    v = rng.normal(size=(2, sq, hkv, 8)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc)
    assert tattn._pick_chunk(sq, qc) == jattn._pick_chunk(sq, qc)
    np.testing.assert_allclose(
        _np(tattn.flash_attention(_t(q), _t(k), _t(v), **kw)),
        _np(jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)), **EXP)


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_and_cache_update_match_reference(per_row):
    rng = np.random.default_rng(2)
    b, s, hq, hkv, d = 3, 7, 4, 2, 8
    q = rng.normal(size=(b, 1, hq, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    new = rng.normal(size=(b, 1, hkv, d)).astype(np.float32)
    pos = np.array([0, 3, 6], np.int32) if per_row else 4
    tpos = torch.from_numpy(pos) if per_row else pos
    jk = jattn.cache_update(jnp.asarray(kc), jnp.asarray(new), pos)
    tk = tattn.cache_update(_t(kc), _t(new), tpos)
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(
        tattn.decode_positions(tpos, b).numpy(),
        np.asarray(jattn.decode_positions(pos, b)))
    np.testing.assert_allclose(
        _np(tattn.decode_attention(_t(q), tk, _t(vc), tpos)),
        _np(jattn.decode_attention(jnp.asarray(q), jk, jnp.asarray(vc),
                                   pos)), **EXP)


def _cfg_pair():
    j = dataclasses.replace(jsmoke(jget_config("qwen2.5-3b")),
                            attn_q_chunk=4, attn_kv_chunk=4)
    t = dataclasses.replace(smoke_variant(get_config("qwen2.5-3b")),
                            attn_q_chunk=4, attn_kv_chunk=4)
    return j, t


def _tree_to_port(p):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_gqa_prefill_and_decode_match_reference(qk_norm):
    jcfg, tcfg = _cfg_pair()
    jcfg = dataclasses.replace(jcfg, qk_norm=qk_norm)
    tcfg = dataclasses.replace(tcfg, qk_norm=qk_norm)
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(3)
    jp = {k: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
              if k.endswith("bias") else v) for k, v in jp.items()}
    tp = _tree_to_port(jp)
    assert set(tp) == set(tattn.gqa_init(torch.Generator(), tcfg))
    x = rng.normal(size=(2, 8, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32)[None], (2, 8))
    jo, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x), jcfg,
                                     jnp.asarray(pos))
    to, (tk, tv) = tattn.gqa_forward(tp, _t(x), tcfg,
                                     torch.from_numpy(pos.copy()))
    for a, b in ((to, jo), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), **EXP)
    # one decode step at position 8 against the prefill cache, padded
    xd = rng.normal(size=(2, 1, tcfg.d_model)).astype(np.float32)
    pad = ((0, 0), (0, 1), (0, 0), (0, 0))
    jcache = (jnp.pad(jk, pad), jnp.pad(jv, pad))
    tcache = (torch.from_numpy(np.pad(_np(tk), pad)),
              torch.from_numpy(np.pad(_np(tv), pad)))
    jo, (jk2, _) = jattn.gqa_decode(jp, jnp.asarray(xd), jcfg, jcache, 8)
    to, (tk2, _) = tattn.gqa_decode(tp, _t(xd), tcfg, tcache, 8)
    np.testing.assert_allclose(_np(to), _np(jo), **EXP)
    np.testing.assert_allclose(_np(tk2), _np(jk2), **EXP)
    assert tk2 is tcache[0]                   # written in place


def test_mlp_matches_reference():
    rng = np.random.default_rng(4)
    jp = jmoe.mlp_init(jax.random.PRNGKey(4), 16, 32)
    tp = _tree_to_port(jp)
    assert set(tp) == set(tmoe.mlp_init(torch.Generator(), 16, 32))
    x = rng.normal(size=(3, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(tmoe.mlp_forward(tp, _t(x))),
                               _np(jmoe.mlp_forward(jp, jnp.asarray(x))),
                               **EXP)
    xb = _t(x, torch.bfloat16)
    np.testing.assert_allclose(
        _np(tmoe.mlp_forward(tp, xb)),
        _np(jmoe.mlp_forward(jp, jnp.asarray(x, jnp.bfloat16))), **BF16)


def test_init_shapes_follow_the_reference_tree():
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm
    jcfg = dataclasses.replace(jsmoke(jget_config("qwen2.5-3b")), n_layers=2)
    tcfg = dataclasses.replace(smoke_variant(get_config("qwen2.5-3b")),
                               n_layers=2)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    jshapes = {jax.tree_util.keystr(k): tuple(v.shape)
               for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    from repro_torch.core.tree import leaves_with_path
    tshapes = {"".join(f"['{p}']" for p in path.split("/")): tuple(v.shape)
               for path, v in leaves_with_path(tp)}
    assert tshapes == jshapes
    jc = jlm.init_cache(jcfg, 2, 5)
    tc = tlm.init_cache(tcfg, 2, 5, device="cpu")
    assert [tuple(a.shape) for a in jax.tree.leaves(jc)] == \
        [tuple(a.shape) for _, a in leaves_with_path(tc)]
