"""The port's MLA and MoE models (``repro_torch.models.attention``'s MLA
half, ``repro_torch.models.moe``, the prologue layers of
``repro_torch.models.lm``) and the dense configurations, against
``repro.models`` on the same NumPy inputs; the registry against the
reference's, all ten configurations.

Tolerances are ``tests/test_torch_models.py``'s: float32 1e-5 (``F32``),
1e-4 through the exponentials of attention (``EXP``), one bfloat16 step
(``BF16``, 2e-2) where XLA and torch round bfloat16 activations at
different places.  Whole models hold ``0.02 · max(|JAX|, 1)`` (the bound
of ``tests/test_transformer_executor.py``).

Inside the port, bit for bit: the ``tiled`` packed lane equals the
quantize-applied lane, packs carried over from JAX serve the port's own
packed logits, and the batched decode of a stacked pack equals the
per-matrix decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jcodr
import repro.models.common as jcommon
import repro.models.lm as jlm
import repro_torch.api as tcodr
import repro_torch.models.lm as tlm
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import attention as jattn
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.core import codr_linear
from repro_torch.core.serving import codr_compress_params
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import attention as tattn
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-5)
EXP = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
DEEPSEEK, GRANITE = "deepseek-v2-236b", "granite-moe-1b-a400m"
DENSE = ["qwen1.5-4b", "qwen3-32b", "command-r-plus-104b"]
B, S, N_UNIQUE, N_DECODE = 2, 8, 16, 4
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _to_port(tree):
    return convert.params_from_reference(jax.tree.map(np.asarray, tree),
                                         "cpu")


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)), **changes)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _close(t, j, what):
    """Within ``0.02 · max(|JAX|, 1)``."""
    t, j = _np(t), _np(j)
    bound = 0.02 * max(np.abs(j).max(), 1.0)
    err = np.abs(t - j).max()
    assert err <= bound, f"{what}: max-abs err {err} > {bound}"


class _activations:
    """Both packages' model activations in ``dtype`` for the block (the
    reference's tests swap ``DEFAULT_DTYPE`` for a float32 run)."""

    def __init__(self, dtype: str):
        self.t, self.j = DTYPES[dtype]

    def __enter__(self):
        self.saved = (tlm.DEFAULT_DTYPE, jcommon.DEFAULT_DTYPE,
                      jlm.DEFAULT_DTYPE)
        tlm.DEFAULT_DTYPE = self.t
        jcommon.DEFAULT_DTYPE = jlm.DEFAULT_DTYPE = self.j
        return self

    def __exit__(self, *exc):
        (tlm.DEFAULT_DTYPE, jcommon.DEFAULT_DTYPE,
         jlm.DEFAULT_DTYPE) = self.saved


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [DEEPSEEK, GRANITE, *DENSE, "qwen2.5-3b",
                                  "xlstm-350m", "jamba-v0.1-52b",
                                  "internvl2-26b", "seamless-m4t-medium"])
def test_registered_configs_equal_the_reference(arch):
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(smoke_variant(get_config(arch))) == \
        dataclasses.asdict(jsmoke(jget_config(arch)))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mla():
    jcfg, tcfg = _cfgs(DEEPSEEK)
    jp = jattn.mla_init(jax.random.PRNGKey(3), jcfg)
    tp = _to_port(jp)
    assert {k: tuple(v.shape) for k, v in leaves_with_path(tp)} == {
        k: tuple(v.shape) for k, v in leaves_with_path(
            tattn.mla_init(torch.Generator(), tcfg))}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_forward_matches_reference(mla, dtype):
    jcfg, tcfg, jp, tp = mla
    tdt, jdt = DTYPES[dtype]
    tol = EXP if dtype == "f32" else BF16
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jo, (jc, jr) = jattn.mla_forward(jp, jnp.asarray(x, jdt), jcfg,
                                     jnp.asarray(pos))
    to, (tc, tr) = tattn.mla_forward(tp, torch.from_numpy(x).to(tdt), tcfg,
                                     torch.from_numpy(pos.copy()))
    assert tuple(tc.shape) == (B, S, tcfg.kv_lora_rank)
    assert tuple(tr.shape) == (B, S, tcfg.rope_head_dim)
    for a, b in ((to, jo), (tc, jc), (tr, jr)):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mla_decode_matches_reference(mla, dtype, per_row):
    jcfg, tcfg, jp, tp = mla
    tdt, jdt = DTYPES[dtype]
    tol = EXP if dtype == "f32" else BF16
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, tcfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(3, 9, tcfg.kv_lora_rank)).astype(np.float32)
    krot = rng.normal(size=(3, 9, tcfg.rope_head_dim)).astype(np.float32)
    pos = np.array([0, 4, 8], np.int32) if per_row else 5
    tpos = torch.from_numpy(pos) if per_row else pos
    tcache = (torch.from_numpy(ckv).to(tdt), torch.from_numpy(krot).to(tdt))
    jo, (jc, jr) = jattn.mla_decode(
        jp, jnp.asarray(x, jdt), jcfg,
        (jnp.asarray(ckv, jdt), jnp.asarray(krot, jdt)), pos)
    to, (tc, tr) = tattn.mla_decode(tp, torch.from_numpy(x).to(tdt), tcfg,
                                    tcache, tpos)
    assert tc is tcache[0] and tr is tcache[1]          # written in place
    for a, b in ((to, jo), (tc, jc), (tr, jr)):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


def test_mla_cache_init_matches_reference():
    jcfg, tcfg = _cfgs(DEEPSEEK)
    from repro.models import cache as jcache
    from repro_torch.models import cache as tcache
    jc = jattn.mla_cache_init(jcfg, 3, 5)
    tc = tattn.mla_cache_init(tcfg, 3, 5, lead=(2,))
    assert [tuple(a.shape) for a in tc] == [(2,) + tuple(a.shape)
                                            for a in jc]
    spec = dict(page_size=2, max_len=6, n_slots=3, kv_dtype="int8")
    jp = jattn.mla_cache_init_paged(jcfg, jcache.PagedSpec(**spec))
    tp = tattn.mla_cache_init_paged(tcfg, tcache.PagedSpec(**spec))
    for a, b in zip(tp, jp):
        assert tuple(a.data.shape) == tuple(b.data.shape)
        assert a.data.dtype == torch.int8 and a.quantized


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {"granite": (GRANITE, {}),
             "deepseek": (DEEPSEEK, {}),
             "deepseek-no-shared": (DEEPSEEK, dict(n_shared_experts=0))}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case, dtype):
    arch, changes = MOE_CASES[case]
    jcfg, tcfg = _cfgs(arch, **changes)
    tdt, jdt = DTYPES[dtype]
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    tp = _to_port(jp)
    assert ("shared" in tp) == bool(tcfg.n_shared_experts)
    assert set(tp) == set(tmoe.moe_init(torch.Generator(), tcfg))
    x = np.random.default_rng(8).normal(
        size=(2, 6, tcfg.d_model)).astype(np.float32)
    jo = jmoe.moe_forward(jp, jnp.asarray(x, jdt), jcfg)
    to = tmoe.moe_forward(tp, torch.from_numpy(x).to(tdt), tcfg)
    assert to.dtype == tdt
    np.testing.assert_allclose(_np(to), _np(jo),
                               **(F32 if dtype == "f32" else BF16))
    # the same experts chosen, in the same order, from the same logits
    x2 = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32)).reshape(
        -1, tcfg.d_model)
    _, jidx = jax.lax.top_k(jnp.dot(x2, jp["router"]), tcfg.moe_top_k)
    _, tidx = torch.topk(torch.from_numpy(x2.copy()) @ tp["router"],
                         tcfg.moe_top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_moe_routing_is_topk():
    """Every token's MoE output uses exactly its top-k experts: changing
    a non-selected expert's weights leaves the output as it was (mirror
    of ``tests/test_models.py::test_moe_routing_is_topk``)."""
    cfg = smoke_variant(get_config(GRANITE))
    p = tmoe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((1, 1, cfg.d_model), generator=torch.Generator(
        ).manual_seed(1))
    out1 = tmoe.moe_forward(p, x, cfg)
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    used = set(torch.topk(logits, cfg.moe_top_k).indices.reshape(-1).tolist())
    unused = [e for e in range(cfg.n_experts) if e not in used]
    assert unused
    p2 = dict(p)
    p2["w_experts_in"] = p["w_experts_in"].clone()
    p2["w_experts_in"][unused[0]] = 123.0
    torch.testing.assert_close(out1, tmoe.moe_forward(p2, x, cfg),
                               rtol=0, atol=0)
    p2["w_experts_in"][sorted(used)[0]] = 123.0
    assert not torch.equal(out1, tmoe.moe_forward(p2, x, cfg))


def test_packed_moe_leaves_decode_on_dispatch():
    """A packed router and packed expert stacks serve the bits of their
    quantize-applied dense forms (the router decoded in float32, the
    experts into the activations' dtype)."""
    cfg = smoke_variant(get_config(DEEPSEEK))
    p = tmoe.moe_init(torch.Generator().manual_seed(2), cfg)
    packed = {k: (codr_linear.pack_projection(v) if k in tmoe._PACKABLE_KEYS
                  else v) for k, v in p.items()}
    dense = {k: (v.dense() if k in tmoe._PACKABLE_KEYS else v)
             for k, v in packed.items()}
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator(
        ).manual_seed(3)).to(torch.bfloat16)
    assert torch.equal(tmoe.moe_forward(packed, x, cfg),
                       tmoe.moe_forward(dense, x, cfg))


@pytest.mark.parametrize("bits_u", [2, 4, 16, 256])
def test_batched_stack_decode_equals_per_matrix_decode(bits_u, monkeypatch):
    """``PackedLinear.dense`` of a stacked pack (several slabs) gives, in
    float32 and bfloat16, the bits of ``unpack_unique`` matrix by matrix
    times the scale."""
    monkeypatch.setattr(codr_linear, "_DECODE_CHUNK", 3 * 40 * 24)
    w = torch.randn((2, 5, 40, 20), generator=torch.Generator(
        ).manual_seed(bits_u))
    pl = codr_linear.pack_projection(w, n_unique=bits_u)
    pw = pl.weight
    want = torch.stack([
        codr_linear.unpack_unique(pw.packed[i, j], pw.table[i, j],
                                  bits=pw.bits, n=pw.shape[1])[:, :20]
        * pw.scale[i, j] for i in range(2) for j in range(5)]
    ).reshape(2, 5, 40, 20)
    assert torch.equal(pl.dense(), want)
    assert torch.equal(pl.dense(torch.bfloat16), want.to(torch.bfloat16))
    assert torch.equal(codr_linear.dense_weight(pl[1]), want[1])


# ---------------------------------------------------------------------------
# whole models against the reference
# ---------------------------------------------------------------------------

def _whole(arch, jcfg, tcfg, jp, tp, dtype: str):
    """Prefill + N_DECODE decode steps fed the prompt's own tokens, in
    both packages; returns (port rows, JAX rows)."""
    tokens = np.random.default_rng(9).integers(0, tcfg.vocab_size, (B, S))
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    with _activations(dtype) as act:
        t = [tapi.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                          tcfg)[0]]
        j = [japi.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)[0]]
        tc = tapi.init_cache(tcfg, B, S, dtype=act.t, device="cpu")
        jc = japi.init_cache(jcfg, B, S, dtype=act.j)
        for i in range(N_DECODE):
            lt, tc = tapi.decode_step(tp, tc, torch.from_numpy(tokens[:, i]),
                                      i, tcfg)
            lj, jc = japi.decode_step(jp, jc, jnp.asarray(tokens[:, i]),
                                      jnp.int32(i), jcfg)
            t.append(lt)
            j.append(lj)
    return t, j


@pytest.fixture(scope="module")
def deepseek():
    jcfg, tcfg = _cfgs(DEEPSEEK)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _to_port(jp)


def test_deepseek_tree_follows_the_reference(deepseek):
    """The same paths and shapes: the prologue list, the ``(n_periods, E,
    …)`` expert stacks, the router and the shared experts; caches too."""
    jcfg, tcfg, jp, tp = deepseek
    own = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    shapes = {p: tuple(v.shape) for p, v in leaves_with_path(tp)}
    assert shapes == {p: tuple(v.shape) for p, v in leaves_with_path(own)}
    e, f, d = tcfg.n_experts, tcfg.moe_d_ff, tcfg.d_model
    assert shapes["stack/b0/mlp/w_experts_gate"] == (1, e, d, f)
    assert shapes["stack/b0/mlp/router"] == (1, d, e)
    assert shapes["stack/b0/mlp/shared/up_proj"] == (1, d, 2 * f)
    assert shapes["prologue/0/mlp/up_proj"] == (d, tcfg.d_ff)
    jc = jget_model(jcfg).init_cache(jcfg, 2, 5)
    tc = tlm.init_cache(tcfg, 2, 5, device="cpu")
    assert [tuple(a.shape) for a in jax.tree.leaves(jc)] == \
        [tuple(a.shape) for _, a in leaves_with_path(tc)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_deepseek_prefill_decode_match_reference(deepseek, dtype):
    """The smoke deepseek-v2-236b (prologue MLA + dense MLP, then MLA +
    MoE): prefill and 4 decode steps within the whole-model bound.  The
    bfloat16 run is held to the reference's float32 run: the reference's
    own bfloat16 run strays from its float32 one by more than the bound
    (0.048 of logits up to 0.5 at the first decode step for these
    weights) while the port's stays within 0.005."""
    jcfg, tcfg, jp, tp = deepseek
    t, j = _whole(DEEPSEEK, jcfg, tcfg, jp, tp, dtype)
    if dtype == "bf16":
        _, j = _whole(DEEPSEEK, jcfg, tcfg, jp, tp, "f32")
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, f"step {i}")


@pytest.mark.parametrize("arch", [DEEPSEEK, "qwen3-32b"])
def test_decode_matches_prefill_f32(arch):
    """Incremental decode reproduces the parallel forward (float32, rel
    < 1e-4; mirror of ``tests/test_models.py::
    test_decode_matches_prefill_f32``)."""
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (B, 32),
                           generator=torch.Generator().manual_seed(1))
    with _activations("f32"):
        ref, _ = api.prefill(params, {"tokens": tokens}, cfg)
        cache = api.init_cache(cfg, B, 32, dtype=torch.float32,
                               device="cpu")
        for t in range(32):
            lg, cache = api.decode_step(params, cache, tokens[:, t], t, cfg)
    rel = float((lg - ref[:, 0]).abs().max()) / max(
        float(ref.abs().max()), 1e-6)
    assert rel < 1e-4, rel


@pytest.mark.parametrize("arch", [*DENSE, GRANITE])
def test_smoke_configs_match_reference(arch):
    """qwen1.5-4b (QKV bias), qwen3-32b (qk-norm), command-r-plus-104b
    (layernorm) and granite-moe-1b-a400m (GQA + MoE, tied embeddings):
    prefill + 4 decode steps within the whole-model bound."""
    jcfg, tcfg = _cfgs(arch)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(1), jcfg)
    t, j = _whole(arch, jcfg, tcfg, jp, _to_port(jp), "bf16")
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, f"{arch} step {i}")


# ---------------------------------------------------------------------------
# packed deepseek, inside the port and from JAX's packs
# ---------------------------------------------------------------------------

def _lanes(tcfg, tp, backend):
    ref, _ = codr_compress_params(tp, n_unique=N_UNIQUE)
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend=backend, accounting=False,
                              device="cpu")
    return ref, cp


def _rows(api, params, cfg, tokens, steps):
    out = [api.prefill(params, {"tokens": tokens}, cfg)[0][:, 0]]
    cache = api.init_cache(cfg, B, S, device="cpu")
    tok = tokens[:, 0]
    for i in range(steps):
        lg, cache = api.decode_step(params, cache, tok, i, cfg)
        out.append(lg)
        tok = torch.argmax(lg, -1)
    return out


def test_deepseek_tiled_lane_bitwise_vs_quantize_applied(deepseek):
    """Mirror of ``tests/test_transformer_executor.py::
    test_packed_prefill_decode_bitwise_vs_quantize_applied``."""
    _, tcfg, _, tp = deepseek
    ref, cp = _lanes(tcfg, tp, "tiled")
    assert any("w_experts" in p for p in cp.packed_paths)
    assert any(p.startswith("prologue/0/") for p in cp.packed_paths)
    api = get_model(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (B, S)))
    for i, (a, b) in enumerate(zip(_rows(api, ref, tcfg, tokens, 4),
                                   _rows(api, cp.params, tcfg, tokens, 4))):
        assert torch.equal(a, b), f"step {i}"


def test_deepseek_codr_matmul_lane_matches_reference_lane(deepseek):
    """Mirror of ``tests/test_transformer_executor.py::
    test_fused_codr_matmul_lane_matches_reference``: within 0.02, the
    same argmax."""
    _, tcfg, _, tp = deepseek
    ref, cp = _lanes(tcfg, tp, "codr_matmul")
    api = get_model(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (B, S)))
    a = api.prefill(ref, {"tokens": tokens}, tcfg)[0]
    b = api.prefill(cp.params, {"tokens": tokens}, tcfg)[0]
    _close(b, a, "prefill")
    np.testing.assert_array_equal(_np(a).argmax(-1), _np(b).argmax(-1))
    cache_r = api.init_cache(tcfg, B, S, device="cpu")
    cache_p = api.init_cache(tcfg, B, S, device="cpu")
    tok = tokens[:, 0]
    for i in range(2):
        lr, cache_r = api.decode_step(ref, cache_r, tok, i, tcfg)
        lp, cache_p = api.decode_step(cp.params, cache_p, tok, i, tcfg)
        _close(lp, lr, f"decode {i}")
        tok = torch.argmax(lr, -1)


def test_reference_packs_serve_the_ports_packed_logits(deepseek):
    """JAX's deepseek packs, carried over by
    ``convert.compiled_params_from_reference`` (the prologue list, the
    expert stacks, the router and the shared experts), serve the logits
    of the port's own packs of the same params, bit for bit."""
    jcfg, tcfg, jp, tp = deepseek
    jcp = jcodr.compile_params(jp, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=False)
    carried = convert.compiled_params_from_reference(jcp, "cpu")
    own = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=False,
                               device="cpu")
    assert carried.packed_paths == own.packed_paths
    assert carried.embed_paths == own.embed_paths
    assert isinstance(carried.params["prologue"], list)
    for (pa, a), (pb, b) in zip(carried.packed_leaves(),
                                own.packed_leaves()):
        assert pa == pb and a.weight.bits == b.weight.bits
        for x, y in zip((a.weight.packed, a.weight.table, a.weight.scale),
                        (b.weight.packed, b.weight.table, b.weight.scale)):
            assert torch.equal(x.to(y.dtype), y), pa
    api = get_model(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (B, S)))
    for i, (a, b) in enumerate(zip(
            _rows(api, carried.params, tcfg, tokens, 3),
            _rows(api, own.params, tcfg, tokens, 3))):
        assert torch.equal(a, b), f"step {i}"
