"""The port's SSM mixers (``repro_torch.models.ssm``: mamba, mLSTM,
sLSTM), the heterogeneous periods of ``repro_torch.models.lm`` and the
two SSM configurations, xlstm-350m (mLSTM + sLSTM) and jamba-v0.1-52b
(mamba, attention and MoE in one period), against ``repro.models`` on
the same NumPy inputs, with the reference's weights carried across by
``convert``.

Tolerances: float32 within ``1e-4 · max(|JAX|, 1)`` (``F32``), bfloat16
within ``2e-2 · max(|JAX|, 1)`` (``BF16``).  Whole jamba runs are held
in float32 only: its MoE routes each token to the top 2 of its experts,
and in bfloat16 a near tie routes a token elsewhere, so both packages'
bfloat16 runs stray from their own float32 run by more than the bound
(at the smoke size and seed 0: the reference 0.22, the port 0.028); the
mamba mixer alone is held in bfloat16 too.  The batchers are compared
token for token in float32 for the same reason.

Inside the port, bit for bit: the ``tiled`` packed lane equals the
quantize-applied lane, packs carried over from JAX serve the port's own
packed logits, a decode step writes the state into the cache's own
buffers, and a pooled step that fails after its first layer and is
retried equals the clean run (the state is put back before the retry).
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
from repro.core.batching import ContinuousBatcher as JBatcher
from repro.models import get_model as jget_model
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.core.batching import ContinuousBatcher
from repro_torch.core.codr_linear import PackedLinear
from repro_torch.core.serving import codr_compress_params
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import get_model
from repro_torch.models import ssm as tssm

F32, BF16 = 1e-4, 2e-2
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-350m"
ARCHS = [JAMBA, XLSTM]
B, S, N_UNIQUE, N_DECODE = 2, 8, 16, 4
T = 120
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


def _to_port(tree):
    return convert.params_from_reference(jax.tree.map(np.asarray, tree),
                                         "cpu")


def _cfgs(arch, **changes):
    jcfg = dataclasses.replace(jsmoke(jget_config(arch)), **changes)
    tcfg = dataclasses.replace(smoke_variant(get_config(arch)), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


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


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)


def _state(shapes, seed):
    """Random state buffers (as NumPy float32) of ``shapes`` for a decode
    test (the stabilizers finite)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * 0.5 for s in shapes]


def _port_state(arrs, dtypes):
    return tuple(torch.from_numpy(a.copy()).to(d) for a, d in zip(arrs, dtypes))


def _jax_state(arrs, dtypes):
    return tuple(jnp.asarray(a, d) for a, d in zip(arrs, dtypes))


# ---------------------------------------------------------------------------
# the chunked selective scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 8, 32, 64])
def test_ssm_scan_chunked_matches_reference_and_sequential(chunk):
    """Mirror of ``tests/test_models.py::
    test_mamba_chunked_scan_matches_sequential``: chunks smaller than S,
    one chunk of S, and a chunk larger than S (cut to S)."""
    rng = np.random.default_rng(chunk)
    b, s, d, n = 2, 32, 4, 3
    a = rng.uniform(0.5, 0.99, size=(b, s, d, n)).astype(np.float32)
    bb = rng.normal(size=(b, s, d, n)).astype(np.float32)
    h0 = rng.normal(size=(b, d, n)).astype(np.float32)
    got = tssm._ssm_scan_chunked(torch.from_numpy(a), torch.from_numpy(bb),
                                 torch.from_numpy(h0), chunk)
    want = jssm._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(bb),
                                  jnp.asarray(h0), chunk)
    h, seq = h0, []
    for t in range(s):
        h = a[:, t] * h + bb[:, t]
        seq.append(h)
    np.testing.assert_allclose(_np(got), np.stack(seq, 1), rtol=1e-5,
                               atol=1e-5)
    _close(got, want, F32)


def test_ssm_scan_chunk_must_divide_the_sequence():
    a = torch.ones(1, 12, 2, 2)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        tssm._ssm_scan_chunked(a, a, torch.zeros(1, 2, 2), 8)
    with pytest.raises(AssertionError):
        jssm._ssm_scan_chunked(jnp.ones((1, 12, 2, 2)), jnp.ones(
            (1, 12, 2, 2)), jnp.zeros((1, 2, 2)), 8)


# ---------------------------------------------------------------------------
# each mixer against its reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mixers():
    """(jamba cfgs, xlstm cfgs, {kind: (JAX params, port params)})."""
    jj, tj = _cfgs(JAMBA)
    jx, tx = _cfgs(XLSTM)
    out = {}
    for kind, jcfg, tcfg, init, tinit in (
            ("mamba", jj, tj, jssm.mamba_init, tssm.mamba_init),
            ("mlstm", jx, tx, jssm.mlstm_init, tssm.mlstm_init),
            ("slstm", jx, tx, jssm.slstm_init, tssm.slstm_init)):
        jp = init(jax.random.PRNGKey(len(kind)), jcfg)
        tp = _to_port(jp)
        own = tinit(torch.Generator().manual_seed(0), tcfg)
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in own.items()}
        out[kind] = (jp, tp)
    return (jj, tj), (jx, tx), out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_forward_matches_reference(mixers, dtype):
    (jcfg, tcfg), _, p = mixers
    jp, tp = p["mamba"]
    tx, jx = _x((B, 16, tcfg.d_model), 1, dtype)
    to, (tt, th) = tssm.mamba_forward(tp, tx, tcfg, chunk=8)
    jo, (jt, jh) = jssm.mamba_forward(jp, jx, jcfg, chunk=8)
    assert to.dtype == tx.dtype and tt.dtype == tx.dtype
    assert th.dtype == torch.float32
    assert tuple(tt.shape) == (B, tcfg.ssm_d_conv - 1,
                               tcfg.ssm_expand * tcfg.d_model)
    for a, b, what in ((to, jo, "out"), (tt, jt, "conv tail"),
                       (th, jh, "h")):
        _close(a, b, TOL[dtype], what)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mamba_decode_matches_reference_in_place(mixers, dtype):
    """The step writes the shifted conv tail and the new h into the
    state's own buffers (cast to their dtypes), with the reference's
    values."""
    (jcfg, tcfg), _, p = mixers
    jp, tp = p["mamba"]
    tdt, jdt = DTYPES[dtype]
    d_in = tcfg.ssm_expand * tcfg.d_model
    arrs = _state([(B, tcfg.ssm_d_conv - 1, d_in),
                   (B, d_in, tcfg.ssm_d_state)], 2)
    state = _port_state(arrs, (tdt, torch.float32))
    ptrs = [t.data_ptr() for t in state]
    tx, jx = _x((B, 1, tcfg.d_model), 3, dtype)
    to, new = tssm.mamba_decode(tp, tx, tcfg, state)
    jo, jnew = jssm.mamba_decode(jp, jx, jcfg,
                                 _jax_state(arrs, (jdt, jnp.float32)))
    assert new is state and [t.data_ptr() for t in new] == ptrs
    assert [t.dtype for t in new] == [tdt, torch.float32]
    _close(to, jo, TOL[dtype], "out")
    for a, b, what in zip(new, jnew, ("conv tail", "h")):
        _close(a, b, TOL[dtype], what)


def _xlstm_state_arrays(kind, tcfg, seed):
    h, d = tcfg.n_heads, tcfg.d_model
    if kind == "mlstm":
        dk = 2 * d // h
        shapes = [(B, h, dk, dk), (B, h, dk), (B, h)]
    else:
        shapes = [(B, d), (B, d), (B, d), (B, h)]
    arrs = _state(shapes, seed)
    arrs[1] = np.abs(arrs[1])                # normalizers are positive
    return arrs


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_mixers_match_reference(mixers, kind, dtype, mode):
    """mLSTM and sLSTM: a prefill from the initial state over 8 tokens,
    and a decode step from a given state, rewritten in place."""
    _, (jcfg, tcfg), p = mixers
    jp, tp = p[kind]
    tfn = getattr(tssm, f"{kind}_forward")
    jfn = getattr(jssm, f"{kind}_forward")
    s = S if mode == "prefill" else 1
    tx, jx = _x((B, s, tcfg.d_model), 4, dtype)
    if mode == "prefill":
        to, tstate = tfn(tp, tx, tcfg)
        jo, jstate = jfn(jp, jx, jcfg)
    else:
        arrs = _xlstm_state_arrays(kind, tcfg, 5)
        state = _port_state(arrs, [torch.float32] * len(arrs))
        ptrs = [t.data_ptr() for t in state]
        to, tstate = tfn(tp, tx, tcfg, state=state)
        jo, jstate = jfn(jp, jx, jcfg,
                         state=_jax_state(arrs, [jnp.float32] * len(arrs)))
        assert tstate is state and [t.data_ptr() for t in state] == ptrs
    assert to.dtype == tx.dtype
    assert all(t.dtype == torch.float32 for t in tstate)
    _close(to, jo, TOL[dtype], "out")
    for i, (a, b) in enumerate(zip(tstate, jstate)):
        _close(a, b, TOL[dtype], f"state {i}")


def test_slstm_decodes_a_packed_r_proj_once_per_forward(mixers,
                                                        monkeypatch):
    _, (_, tcfg), p = mixers
    from repro_torch.core.codr_linear import pack_projection
    tp = dict(p["slstm"][1])
    tp["r_proj"] = pack_projection(p["slstm"][1]["r_proj"])
    assert isinstance(tp["r_proj"], PackedLinear)
    calls = []
    real = tssm.dense_weight
    monkeypatch.setattr(tssm, "dense_weight",
                        lambda w, *a: calls.append(1) or real(w, *a))
    out, _ = tssm.slstm_forward(tp, torch.ones(B, S, tcfg.d_model), tcfg)
    assert len(calls) == 1
    dense = dict(tp, r_proj=tp["r_proj"].dense())
    assert torch.equal(out, tssm.slstm_forward(dense, torch.ones(
        B, S, tcfg.d_model), tcfg)[0])


@pytest.mark.parametrize("lead", [(), (3,)])
def test_state_inits_match_reference(lead):
    """Shapes (stacked over ``lead``), dtypes and the ``-1e30``
    stabilizer start."""
    jj, tj = _cfgs(JAMBA)
    jx, tx = _cfgs(XLSTM)
    cases = [(tssm.mamba_state_init(tj, 2, torch.bfloat16, lead=lead),
              jssm.mamba_state_init(jj, 2, jnp.bfloat16)),
             (tssm.mlstm_state_init(tx, 2, lead=lead),
              jssm.mlstm_state_init(jx, 2)),
             (tssm.slstm_state_init(tx, 2, lead=lead),
              jssm.slstm_state_init(jx, 2))]
    for tstate, jstate in cases:
        assert len(tstate) == len(jstate)
        for a, b in zip(tstate, jstate):
            assert tuple(a.shape) == lead + tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            want = np.broadcast_to(np.asarray(b, np.float32),
                                   tuple(a.shape))
            np.testing.assert_array_equal(_np(a), want)
    for tstate in (cases[1][0], cases[2][0]):
        assert bool((tstate[-1] == -1e30).all())


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, tcfg, jp, _to_port(jp)


def test_tree_and_caches_follow_the_reference(model):
    """The same paths and shapes as the port's own init (the 4-D sLSTM
    ``r_proj`` stacked over the periods, jamba's mamba, attention, MoE
    and dense layers in one period); caches alike, with the
    reference's dtypes."""
    arch, jcfg, tcfg, jp, tp = model
    own = get_model(tcfg).init_params(torch.Generator().manual_seed(0), tcfg)
    shapes = {p: tuple(v.shape) for p, v in leaves_with_path(tp)}
    assert shapes == {p: tuple(v.shape) for p, v in leaves_with_path(own)}
    if arch == XLSTM:
        dh = tcfg.d_model // tcfg.n_heads
        assert shapes["stack/b1/mixer/r_proj"] == (
            tcfg.n_periods, tcfg.n_heads, dh, 4 * dh)
    else:
        assert [k for k, _ in tcfg.layer_plan()].count("mamba") == 7
        assert "router" in tp["stack"]["b1"]["mlp"]
        assert "A_log" in tp["stack"]["b0"]["mixer"]
    jc = jget_model(jcfg).init_cache(jcfg, 2, 5)
    tc = get_model(tcfg).init_cache(tcfg, 2, 5, device="cpu")
    assert [tuple(a.shape) for a in jax.tree.leaves(jc)] == \
        [tuple(a.shape) for _, a in leaves_with_path(tc)]
    assert [str(a.dtype) for a in jax.tree.leaves(jc)] == \
        [str(a.dtype).split(".")[-1] for _, a in leaves_with_path(tc)]


def _whole(jcfg, tcfg, jp, tp, dtype: str, steps: int = N_DECODE,
           check_in_place: bool = False):
    """Prefill + ``steps`` decode steps fed the prompt's own tokens, in
    both packages; returns (port rows, JAX rows, port cache, JAX
    cache)."""
    tokens = np.random.default_rng(9).integers(0, tcfg.vocab_size, (B, S))
    japi, tapi = jget_model(jcfg), get_model(tcfg)
    with _activations(dtype) as act:
        t = [tapi.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                          tcfg)[0]]
        j = [japi.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg)[0]]
        tc = tapi.init_cache(tcfg, B, S, dtype=act.t, device="cpu")
        jc = japi.init_cache(jcfg, B, S, dtype=act.j)
        ptrs = [a.data_ptr() for _, a in leaves_with_path(tc)]
        for i in range(steps):
            lt, tc2 = tapi.decode_step(tp, tc, torch.from_numpy(tokens[:, i]),
                                       i, tcfg)
            lj, jc = japi.decode_step(jp, jc, jnp.asarray(tokens[:, i]),
                                      jnp.int32(i), jcfg)
            if check_in_place:
                assert tc2 is tc
                assert [a.data_ptr() for _, a in leaves_with_path(tc)] == \
                    ptrs
            t.append(lt)
            j.append(lj)
    return t, j, tc, jc


def test_prefill_decode_match_reference_f32(model):
    """Prefill and 4 decode steps within ``F32``."""
    arch, jcfg, tcfg, jp, tp = model
    t, j, _, _ = _whole(jcfg, tcfg, jp, tp, "f32")
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, F32, f"{arch} step {i}")


def test_xlstm_prefill_decode_match_reference_bf16():
    """xlstm-350m in bfloat16 within ``BF16`` (jamba is held in float32
    only: module docstring)."""
    jcfg, tcfg = _cfgs(XLSTM)
    jp = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    t, j, _, _ = _whole(jcfg, tcfg, jp, _to_port(jp), "bf16")
    for i, (a, b) in enumerate(zip(t, j)):
        _close(a, b, BF16, f"step {i}")


def test_decode_writes_the_state_in_place(model):
    """Every decode step writes the caches' own buffers (the same data
    pointers, the same tree), and after 4 steps the SSM states and KV
    rows hold the reference's new cache, float32 within 1e-4."""
    arch, jcfg, tcfg, jp, tp = model
    _, _, tc, jc = _whole(jcfg, tcfg, jp, tp, "f32", check_in_place=True)
    state = tlm.recurrent_state(tcfg, tc)
    assert len(state) == (7 * 2 if arch == JAMBA else 3 + 4)
    for (path, a), b in zip(leaves_with_path(tc), jax.tree.leaves(jc)):
        _close(a, b, F32, path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_smoke_serve_step(arch):
    """Mirror of ``tests/test_models.py::test_arch_smoke_serve_step`` over
    every architecture of the registry: a prefill (with the stub prefix
    where the model takes one) and a decode step from a fresh cache give
    finite logits of the reference's shapes."""
    cfg = smoke_variant(get_config(arch))
    api = get_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = api.init_params(gen, cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 32),
                                     generator=gen)}
    if cfg.family == "encdec" or cfg.frontend:
        batch["prefix"] = torch.randn((B, cfg.frontend_seq, cfg.d_model),
                                      generator=gen)
    logits, _ = api.prefill(params, batch, cfg)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    cache = api.init_cache(cfg, B, 32, device="cpu")
    logits, _ = api.decode_step(params, cache, batch["tokens"][:, 0], 0,
                                cfg)
    assert tuple(logits.shape) == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_f32(arch):
    """Incremental decode reproduces the parallel forward (float32, rel
    < 1e-4; mirror of ``tests/test_models.py::
    test_decode_matches_prefill_f32``: 32 tokens, two mamba chunks)."""
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


# ---------------------------------------------------------------------------
# packed lanes
# ---------------------------------------------------------------------------

def _rows(api, params, cfg, tokens, steps):
    out = [api.prefill(params, {"tokens": tokens}, cfg)[0][:, 0]]
    cache = api.init_cache(cfg, B, S, device="cpu")
    tok = tokens[:, 0]
    for i in range(steps):
        lg, cache = api.decode_step(params, cache, tok, i, cfg)
        out.append(lg)
        tok = torch.argmax(lg, -1)
    return out


def test_compile_params_packs_the_ssm_leaves(model):
    """The same packed and quantize-applied paths as the reference's
    ``compile_params``: every ``*_proj`` packed (sLSTM's 4-D ``r_proj``,
    the narrow ``if_proj`` and ``x_proj``; the smoke router, 64 × 8, is
    below the size floor in both packages), mamba's ``conv_w``,
    ``A_log`` and ``D`` quantize-applied where large enough, never
    packed."""
    arch, jcfg, tcfg, jp, tp = model
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="tiled", accounting=False,
                              device="cpu")
    jcp = jcodr.compile_params(jp, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="tiled", accounting=False)
    assert cp.packed_paths == list(jcp.packed_paths)
    assert cp.quantized_paths == list(jcp.quantized_paths)
    packed = {path: leaf for path, leaf in cp.packed_leaves()
              if isinstance(leaf, PackedLinear)}
    assert list(packed) == cp.packed_paths
    if arch == XLSTM:
        r = packed["stack/b1/mixer/r_proj"]
        assert r.weight.packed.dim() == 4
        assert r.out_features == 4 * tcfg.d_model // tcfg.n_heads
        assert packed["stack/b0/mixer/if_proj"].out_features == \
            2 * tcfg.n_heads
    else:
        assert packed["stack/b0/mixer/x_proj"].out_features == \
            tcfg.d_model // 16 + 2 * tcfg.ssm_d_state
        assert "stack/b1/mlp/w_experts_gate" in packed
        for leaf in ("conv_w", "A_log", "D", "conv_b", "dt_bias"):
            assert f"stack/b0/mixer/{leaf}" not in packed
        assert "stack/b0/mixer/A_log" in cp.quantized_paths
    jleaves = dict(zip(jcp.packed_paths, [
        x for x in jax.tree_util.tree_leaves(
            jcp.params, is_leaf=lambda x: hasattr(x, "out_features"))
        if hasattr(x, "out_features")]))
    for path, leaf in packed.items():
        jw = jleaves[path].weight
        assert tuple(leaf.weight.shape) == tuple(jw.shape), path
        assert leaf.weight.bits == jw.bits, path


def test_tiled_lane_bitwise_vs_quantize_applied(model):
    """Mirror of ``tests/test_transformer_executor.py::
    test_packed_prefill_decode_bitwise_vs_quantize_applied`` (whose
    ``PARITY_ARCHS`` include xlstm-350m)."""
    arch, _, tcfg, _, tp = model
    ref, _ = codr_compress_params(tp, n_unique=N_UNIQUE)
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="tiled", accounting=False,
                              device="cpu")
    api = get_model(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (B, S)))
    for i, (a, b) in enumerate(zip(_rows(api, ref, tcfg, tokens, 4),
                                   _rows(api, cp.params, tcfg, tokens, 4))):
        assert torch.equal(a, b), f"{arch} step {i}"


def test_codr_matmul_lane_matches_reference_lane(model):
    """The ``codr_matmul`` lane (its plain version here) within 0.02 of
    the quantize-applied lane, prefill and two decode steps."""
    arch, _, tcfg, _, tp = model
    ref, _ = codr_compress_params(tp, n_unique=N_UNIQUE)
    cp = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                              backend="codr_matmul", accounting=False,
                              device="cpu")
    api = get_model(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (B, S)))
    for i, (a, b) in enumerate(zip(_rows(api, ref, tcfg, tokens, 2),
                                   _rows(api, cp.params, tcfg, tokens, 2))):
        _close(b, a, 0.02, f"{arch} step {i}")


def test_reference_packs_serve_the_ports_packed_logits(model):
    """JAX's packs, carried over by
    ``convert.compiled_params_from_reference`` (the 4-D ``r_proj``, the
    narrow projections, the expert stacks), equal the port's own packs
    of the same params and serve the same logits, bit for bit."""
    arch, jcfg, tcfg, jp, tp = model
    jcp = jcodr.compile_params(jp, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=False)
    carried = convert.compiled_params_from_reference(jcp, "cpu")
    own = tcodr.compile_params(tp, tcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul", accounting=False,
                               device="cpu")
    assert carried.packed_paths == own.packed_paths
    assert carried.quantized_paths == own.quantized_paths
    for (pa, a), (pb, b) in zip(carried.packed_leaves(),
                                own.packed_leaves()):
        assert pa == pb and a.weight.bits == b.weight.bits
        for x, y in zip((a.weight.packed, a.weight.table, a.weight.scale),
                        (b.weight.packed, b.weight.table, b.weight.scale)):
            assert torch.equal(x.to(y.dtype), y), pa
    for (pa, a), (pb, b) in zip(leaves_with_path(carried.params),
                                leaves_with_path(own.params)):
        if isinstance(a, torch.Tensor):
            assert pa == pb and torch.equal(a, b), pa
    api = get_model(tcfg)
    tokens = torch.from_numpy(np.random.default_rng(12).integers(
        0, tcfg.vocab_size, (B, S)))
    for i, (a, b) in enumerate(zip(
            _rows(api, carried.params, tcfg, tokens, 3),
            _rows(api, own.params, tcfg, tokens, 3))):
        assert torch.equal(a, b), f"{arch} step {i}"


# ---------------------------------------------------------------------------
# the continuous batcher on the dense pool
# ---------------------------------------------------------------------------

LENS = (8, 16, 5)


def _prompts(cfg, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in lens]


def test_batcher_matches_the_reference_batcher(model):
    """Three requests (prompts of 8, 16 and 5 tokens) over two slots of
    the dense pool, in float32: the port's tokens equal the reference
    batcher's, and each equals the port's solo reference."""
    arch, jcfg, tcfg, jp, tp = model
    prompts = _prompts(tcfg)
    with _activations("f32"):
        jb = JBatcher(jp, jcfg, n_slots=2, max_len=32)
        want = [h.result(timeout=T) for h in
                [jb.submit(p, max_new_tokens=6) for p in prompts]]
        jb.stop_async()
        tb = ContinuousBatcher(tp, tcfg, n_slots=2, max_len=32,
                               device="cpu")
        got = [h.result(timeout=T) for h in
               [tb.submit(p, max_new_tokens=6) for p in prompts]]
        tb.stop_async()
        assert tb.peak_active == 2
        solo = [tb.generate_reference(p, max_new_tokens=6)[0]
                for p in prompts]
    assert got == want
    assert got == solo


@pytest.mark.parametrize("kv", [dict(kv_page_size=4),
                                dict(kv_dtype="int8", kv_page_size=4),
                                dict(kv_dtype="int8")],
                         ids=["bf16-paged", "int8-paged", "int8"])
def test_paged_pools_refuse_ssm_mixers(model, kv):
    arch, jcfg, tcfg, jp, tp = model
    msg = "paged KV cache covers attention mixers only"
    with pytest.raises(NotImplementedError, match=msg):
        ContinuousBatcher(tp, tcfg, n_slots=2, max_len=16, device="cpu",
                          **kv)
    with pytest.raises(NotImplementedError, match=msg):
        JBatcher(jp, jcfg, n_slots=2, max_len=16, **kv)


def test_retried_step_after_a_partial_write_equals_clean(model,
                                                         monkeypatch):
    """A pooled step raises a transient error after its first SSM layer
    wrote its state (twice in the run); the retry starts from the saved
    state, so tokens and logits equal the clean solo reference bit for
    bit."""
    from repro_torch.runtime import resilience as res
    arch, _, tcfg, _, tp = model
    cb = ContinuousBatcher(tp, tcfg, n_slots=2, max_len=24,
                           record_logits=True, device="cpu")
    cb.configure_resilience(retry_policy=res.RetryPolicy(max_retries=2,
                                                         backoff_s=1e-4))
    name = "mamba_decode" if arch == JAMBA else "mlstm_forward"
    real, calls = getattr(tssm, name), []
    per_step = 7 if arch == JAMBA else 1      # SSM layers of this kind

    def mixer(*a, **k):
        out = real(*a, **k)
        if name == "mamba_decode" or k.get("state") is not None:
            calls.append(1)
            if len(calls) in (per_step * 2 + 1, per_step * 5 + 2):
                raise res.TransientDispatchError("step failed midway")
        return out
    monkeypatch.setattr(tssm, name, mixer)
    p1, p2 = _prompts(tcfg, (6, 9), seed=14)
    handles = [cb.submit(p, max_new_tokens=8) for p in (p1, p2)]
    outs = [h.result(timeout=T) for h in handles]
    cb.stop_async()
    monkeypatch.setattr(tssm, name, real)
    assert len(calls) > per_step * 5 + 2
    for p, h, out in zip((p1, p2), handles, outs):
        ref, rows = cb.generate_reference(p, max_new_tokens=8,
                                          record_logits=True)
        assert out == ref
        for got, want in zip(h.logits, rows):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the serve driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_codr", [False, True])
def test_run_serve_returns_the_reference_keys(model, use_codr, capsys):
    from repro.launch.serve import run_serve as jrun_serve
    from repro_torch.launch.serve import run_serve
    arch = model[0]
    kw = dict(arch=arch, batch=2, prompt_len=4, gen_len=3,
              use_codr=use_codr, codr_backend="tiled")
    j = jrun_serve(verbose=False, **kw)
    t = run_serve(device="cpu", **kw)
    assert set(t) == set(j)
    assert t["family"] == j["family"]
    assert t["gen"].shape == j["gen"].shape == (2, 3)
    assert t["n_decode_steps"] == j["n_decode_steps"] == 6
    assert t["kv_bytes"] == j["kv_bytes"]
    assert t["cache_self_len"] is None and j["cache_self_len"] is None
    assert "prefill 4 toks" in capsys.readouterr().out
    if use_codr:
        assert t["n_packed"] == j["n_packed"]
        assert t["hbm_bytes"] == pytest.approx(j["hbm_bytes"], rel=0.2)
