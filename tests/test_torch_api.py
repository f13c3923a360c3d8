"""The port's spec → compile → run API against the JAX reference, on the
CPU (``device="cpu"``), mirroring ``tests/test_api.py``.

Tolerances: the ``tiled`` lane and the dense oracles are float32
convolutions summed in another order than XLA's, so they are held to
rtol 1e-4; the ``smm`` and ``smm_kernel`` lanes are integer arithmetic
on the same int8 activations as the reference ``smm`` lane, so they are
held to exact equality.  (The reference's ``smm_kernel`` lane cannot
run: its Pallas kernel fails on the installed JAX.)
"""
import dataclasses

import numpy as np
import pytest

import repro.api as jcodr
import repro_torch.api as tcodr
from repro.core import backends as jbackends
from repro_torch.convert import compiled_from_reference
from repro_torch.core import backends as tbackends


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sparse(rng, shape, density=0.5, scale=0.5):
    w = rng.normal(size=shape).astype(np.float32) * scale
    w[rng.random(shape) > density] = 0
    return w


def _both(layers_fn, cfg=None, backend="tiled"):
    """Compile the same layers in both packages (port on the CPU)."""
    jc = jcodr.compile(jcodr.ModelSpec(layers_fn(jcodr)),
                       None if cfg is None else jcodr.EncodeConfig(**cfg),
                       backend=backend)
    tc = tcodr.compile(tcodr.ModelSpec(layers_fn(tcodr)),
                       None if cfg is None else tcodr.EncodeConfig(**cfg),
                       backend=backend, device="cpu")
    return jc, tc


def _np(y):
    return y.detach().cpu().numpy()


def _assert_codes_equal(tcomp, jcomp):
    for tl, jl in zip(tcomp.model.layers, jcomp.model.layers):
        assert (tl.name, tl.kind) == (jl.name, jl.kind)
        t, j = tl.code, jl.code
        assert t.shape == j.shape and t.params == j.params
        assert np.asarray(t.scale).tobytes() == np.asarray(j.scale).tobytes()
        for tv, jv in zip(t.vectors, j.vectors):
            for name in ("deltas", "reps", "indexes"):
                ts, js = getattr(tv, name), getattr(jv, name)
                assert ts.packed.tobytes() == js.packed.tobytes()
                assert (ts.nbits, ts.param, ts.count, ts.mode_bits) == \
                    (js.nbits, js.param, js.count, js.mode_bits)


# ---------------------------------------------------------------------------
# strides 1–3 × ragged last output-channel tile × every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("m", [8, 10])          # 10 → ragged tile at t_m=4
def test_compile_run_matches_reference_all_backends(stride, m, rng):
    w = _sparse(rng, (m, 3, 3, 3))
    b = rng.normal(size=m).astype(np.float32)
    jc, tc = _both(lambda c: [c.LayerSpec.conv(w, b, stride=stride,
                                               activation="relu",
                                               name="c0")])
    _assert_codes_equal(tc, jc)
    tc.verify_roundtrip()
    names = [n for n in tcodr.available_backends()
             if tcodr.get_backend(n).supports_model(tc.model.layers)[0]]
    assert {"tiled", "smm", "smm_kernel"} <= set(names)

    x = rng.integers(-8, 8, size=(2, 13, 13, 3)).astype(np.float32)
    xf = rng.normal(size=(2, 13, 13, 3)).astype(np.float32) * 3
    for xx in (x, xf):
        j_tiled = np.asarray(jc.run(xx))
        j_smm = np.asarray(jc.run(xx, backend="smm"))
        np.testing.assert_allclose(_np(tc.run(xx)), j_tiled, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(_np(tc.run(xx)),
                                   np.asarray(jc.quantized_reference(xx)),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(tc.reference(xx)),
                                   np.asarray(jc.reference(xx)),
                                   rtol=1e-4, atol=1e-4)
        for name in ("smm", "smm_kernel"):
            y = _np(tc.run(xx, backend=name))
            assert y.dtype == np.float32 and y.shape == j_smm.shape
            np.testing.assert_array_equal(y, j_smm, err_msg=name)
    # integer inputs: the integer lanes equal the dequantized oracle too
    np.testing.assert_allclose(_np(tc.run(x, backend="smm_kernel")),
                               _np(tc.quantized_reference(x)), rtol=1e-4,
                               atol=1e-4)


def test_conv_chain_with_linear_head_matches_reference(rng):
    """from_shapes draws the same weights; conv→linear flattening, the
    linear fallback of the integer lanes and the head all agree."""
    from repro.core.dataflow import ConvShape as JShape
    from repro_torch.core.dataflow import ConvShape as TShape
    geo = [(6, 3, 3, 3, 12, 12, 1), (5, 6, 2, 2, 10, 10, 2)]
    jspec = jcodr.ModelSpec.from_shapes([JShape(*g) for g in geo], n_out=4,
                                        rng=np.random.default_rng(7))
    tspec = tcodr.ModelSpec.from_shapes([TShape(*g) for g in geo], n_out=4,
                                        rng=np.random.default_rng(7))
    for jl, tl in zip(jspec, tspec):
        assert jl.name == tl.name and jl.stride == tl.stride
        np.testing.assert_array_equal(jl.weight, tl.weight)
    cfg = dict(n_unique=16, t_m_linear=3)
    jc = jcodr.compile(jspec, jcodr.EncodeConfig(**cfg))
    tc = tcodr.compile(tspec, tcodr.EncodeConfig(**cfg), device="cpu")
    _assert_codes_equal(tc, jc)
    x = rng.normal(size=(3, 12, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tc.run(x)), np.asarray(jc.run(x)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tc.reference(x)),
                               np.asarray(jc.reference(x)), rtol=1e-4,
                               atol=1e-4)
    j_smm = np.asarray(jc.run(x, backend="smm"))
    np.testing.assert_allclose(_np(tc.run(x, backend="smm")), j_smm,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tc.run(x, backend="smm_kernel")), j_smm,
                               rtol=1e-4, atol=1e-4)
    # a conv-only stack draws the same conv weights (the head comes last)
    conv_only = tcodr.ModelSpec.from_shapes([TShape(*g) for g in geo], None,
                                            rng=np.random.default_rng(7))
    assert [ls.kind for ls in conv_only] == ["conv", "conv"]
    np.testing.assert_array_equal(conv_only.layers[1].weight,
                                  jspec.layers[1].weight)


def test_from_paper_cnn_geometry_matches_reference():
    jspec = jcodr.ModelSpec.from_paper_cnn("alexnet", n_conv=2, ri=31, ci=31)
    tspec = tcodr.ModelSpec.from_paper_cnn("alexnet", n_conv=2, ri=31, ci=31)
    for jl, tl in zip(jspec, tspec):
        assert (jl.kind, jl.name, jl.stride) == (tl.kind, tl.name, tl.stride)
        np.testing.assert_array_equal(jl.weight, tl.weight)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------

def test_stats_and_sram_report_match_reference(rng):
    jc, tc = _both(lambda c: [
        c.LayerSpec.conv(_sparse(np.random.default_rng(1), (10, 3, 3, 3)),
                         stride=2, name="c0"),
        c.LayerSpec.conv(_sparse(np.random.default_rng(2), (6, 10, 3, 3)),
                         name="c1"),
        c.LayerSpec.dense(_sparse(np.random.default_rng(3), (5, 54)),
                          name="fc")], cfg=dict(n_unique=16))
    for ts, js in zip(tc.stats(), jc.stats()):
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert tc.total_bits() == jc.total_bits()
    assert tc.bits_per_weight() == jc.bits_per_weight()
    for kw in ({}, {"per_layer_tiling": True}):
        tr, jr = tc.sram_report((13, 13), **kw), jc.sram_report((13, 13), **kw)
        assert [n for n, _ in tr] == [n for n, _ in jr]
        for (_, ta), (_, ja) in zip(tr, jr):
            assert dataclasses.asdict(ta) == dataclasses.asdict(ja)
            assert ta.total_sram == ja.total_sram
    assert "total" in tc.layer_table((13, 13))


# ---------------------------------------------------------------------------
# registry + capability errors
# ---------------------------------------------------------------------------

def _register_both(make):
    jb, tb = make(jbackends), make(tbackends)
    jbackends.register(jb)
    tbackends.register(tb)
    return jb.name


def _unregister_both(name):
    jbackends._REGISTRY.pop(name, None)
    tbackends._REGISTRY.pop(name, None)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_capability_errors_match_reference(rng):
    def stride1(mod):
        class Stride1(mod.Backend):
            name = "test_stride1"
            caps = mod.BackendCaps(max_stride=1)

            def conv(self, layer, x):
                return layer(x)
        return Stride1()

    def linear_only(mod):
        class LinearOnly(mod.Backend):
            name = "test_linear_only"
            caps = mod.BackendCaps(native_kinds=frozenset({"linear"}))

            def conv(self, layer, x):
                return layer(x)
        return LinearOnly()

    w = _sparse(rng, (4, 2, 3, 3))
    names = [_register_both(stride1), _register_both(linear_only)]
    try:
        for backend in ("warp_drive", "test_stride1", "test_linear_only"):
            msgs = [_error(lambda c=c, dev=dev: c.compile(
                        c.ModelSpec([c.LayerSpec.conv(w, stride=2,
                                                      name="c0")]),
                        backend=backend, **dev))
                    for c, dev in ((jcodr, {}), (tcodr, {"device": "cpu"}))]
            if backend == "warp_drive":       # registries list their names
                assert all("unknown backend 'warp_drive'" in m for m in msgs)
            else:
                assert msgs[0] == msgs[1], backend
        # a run-time override is checked the same way
        jc, tc = _both(lambda c: [c.LayerSpec.conv(w, name="c0")])
        x = rng.integers(-4, 5, size=(1, 8, 8, 2)).astype(np.float32)
        assert _error(lambda: jc.run(x, backend="test_linear_only")) == \
            _error(lambda: tc.run(x, backend="test_linear_only"))
    finally:
        for n in names:
            _unregister_both(n)
    assert "test_stride1" not in tcodr.available_backends()


def test_register_custom_backend_and_dispatch(rng):
    class NegatingBackend(tbackends.Backend):
        name = "test_negate"
        caps = tbackends.BackendCaps(description="test-only")

        def conv(self, layer, x):
            return -layer(x)

    tbackends.register(NegatingBackend())
    try:
        tc = tcodr.compile(tcodr.ModelSpec([tcodr.LayerSpec.conv(
            _sparse(rng, (4, 2, 3, 3)))]), device="cpu")
        x = rng.normal(size=(1, 6, 6, 2)).astype(np.float32)
        np.testing.assert_array_equal(_np(tc.run(x, backend="test_negate")),
                                      -_np(tc.run(x)))
        with pytest.raises(ValueError, match="already registered"):
            tbackends.register(NegatingBackend())
        tbackends.register(NegatingBackend(), overwrite=True)
    finally:
        tbackends._REGISTRY.pop("test_negate", None)


@pytest.mark.parametrize("kwargs", [
    {"n_unique": 2}, {"n_unique": 300}, {"t_m": 0}, {"t_n": True},
    {"t_m_linear": 2.5}, {"rle_params": (4, 4)}, {"rle_params": (4, 4, 17)},
    {"decode_source": "telepathy"}])
def test_encode_config_validation_matches_reference(kwargs):
    assert _error(lambda: jcodr.EncodeConfig(**kwargs)) == \
        _error(lambda: tcodr.EncodeConfig(**kwargs))


def test_model_spec_validation_matches_reference(rng):
    c0 = _sparse(rng, (4, 3, 3, 3))
    bad = _sparse(rng, (4, 5, 3, 3))
    fc = _sparse(rng, (4, 8))
    cases = [
        lambda c: c.ModelSpec([c.LayerSpec.conv(c0, name="c0"),
                               c.LayerSpec.conv(bad, name="c1")]),
        lambda c: c.ModelSpec([c.LayerSpec.dense(fc, name="fc"),
                               c.LayerSpec.conv(c0, name="c0")]),
        lambda c: c.LayerSpec.conv(fc),
        lambda c: c.LayerSpec.conv(c0, np.zeros(5, np.float32)),
        lambda c: c.ModelSpec([]),
    ]
    for case in cases:
        assert _error(lambda: case(jcodr)) == _error(lambda: case(tcodr))


def test_encode_config_plan_and_decode_source_match_reference(rng):
    w0, w1 = _sparse(rng, (8, 3, 3, 3)), _sparse(rng, (4, 8, 3, 3))
    plans = [{"c1": c.EncodeConfig(n_unique=8, t_m=2)} for c in (jcodr,
                                                                tcodr)]
    jc = jcodr.compile(jcodr.ModelSpec([jcodr.LayerSpec.conv(w0, name="c0"),
                                        jcodr.LayerSpec.conv(w1, name="c1")]),
                       jcodr.EncodeConfig(decode_source="ucr"),
                       plan=plans[0])
    tc = tcodr.compile(tcodr.ModelSpec([tcodr.LayerSpec.conv(w0, name="c0"),
                                        tcodr.LayerSpec.conv(w1, name="c1")]),
                       tcodr.EncodeConfig(decode_source="ucr"),
                       plan=plans[1], device="cpu")
    _assert_codes_equal(tc, jc)
    assert tc.model.layers[1].code.t_m == 2
    x = rng.integers(-5, 6, size=(2, 9, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(_np(tc.run(x, backend="smm_kernel")),
                                  np.asarray(jc.run(x, backend="smm")))
    np.testing.assert_array_equal(tc.model.layers[0].tiles,
                                  jc.model.layers[0].tiles)


@pytest.mark.parametrize("source", ["bitstream", "ucr"])
def test_decoded_tiles_match_reference(source, rng):
    from repro.core import engine as jengine
    from repro.core import ucr as jucr
    from repro_torch.core import engine as tengine
    from repro_torch.core import ucr as tucr
    w = _sparse(rng, (10, 3, 3, 3))               # ragged last tile
    jcode = jucr.encode_conv_layer(w, t_m=4, t_n=2, n_unique=16)
    tcode = tucr.encode_conv_layer(w, t_m=4, t_n=2, n_unique=16)
    tiles = tengine.decode_all_tiles(tcode, source=source)
    np.testing.assert_array_equal(
        tiles, jengine.decode_all_tiles(jcode, source=source))
    for mt in range(3):
        np.testing.assert_array_equal(
            tengine.decode_tile(tcode, mt, source=source),
            jengine.decode_tile(jcode, mt, source=source))
        np.testing.assert_array_equal(
            tengine.decode_tile(tcode, mt, source=source), tiles[mt])
    with pytest.raises(ValueError, match="decode source"):
        tengine.decode_all_tiles(tcode, source="telepathy")


# ---------------------------------------------------------------------------
# checkpoint ingestion
# ---------------------------------------------------------------------------

def test_from_params_tree_matches_reference(rng):
    params = {
        "conv0": {"w": _sparse(rng, (8, 3, 3, 3)),
                  "b": rng.normal(size=8).astype(np.float32)},
        "conv1": {"w": _sparse(rng, (12, 8, 3, 3))},
        "fc": {"w": _sparse(rng, (8 * 8 * 12, 6), scale=0.1)},
    }
    kw = dict(activation={"conv0": "relu", "conv1": "relu"},
              linear_layout="in_out")
    jspec = jcodr.ModelSpec.from_params(params, **kw)
    tspec = tcodr.ModelSpec.from_params(params, **kw)
    assert [ls.name for ls in tspec] == [ls.name for ls in jspec] == \
        ["conv0", "conv1", "fc"]
    for jl, tl in zip(jspec, tspec):
        np.testing.assert_array_equal(jl.weight, tl.weight)
        assert (jl.bias is None) == (tl.bias is None)
        assert jl.activation == tl.activation
    jc = jcodr.compile(jspec, jcodr.EncodeConfig(n_unique=16))
    tc = tcodr.compile(tspec, tcodr.EncodeConfig(n_unique=16), device="cpu")
    _assert_codes_equal(tc, jc)
    x = rng.normal(size=(2, 12, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tc.run(x)), np.asarray(jc.run(x)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("params", [
    {f"conv{i}": {"w": np.full((4, 4, 3, 3), i + 1, np.float32)}
     for i in range(12)},
    [np.ones((4, 2, 3, 3), np.float32), np.ones((6, 4, 3, 3), np.float32)],
    {"blk": {"w_a": np.ones((4, 6), np.float32),
             "b_a": np.arange(4, dtype=np.float32),
             "w_b": np.full((4, 6), 2, np.float32),
             "b_b": np.arange(4, 8, dtype=np.float32)},
     "head": ({"kernel": np.ones((3, 4), np.float32)}, None)},
])
def test_from_params_flatten_order_matches_reference(params):
    jspec = jcodr.ModelSpec.from_params(params, stride={"0": 2})
    tspec = tcodr.ModelSpec.from_params(params, stride={"0": 2})
    assert [(l.name, l.kind, l.stride) for l in tspec] == \
        [(l.name, l.kind, l.stride) for l in jspec]
    for jl, tl in zip(jspec, tspec):
        np.testing.assert_array_equal(jl.weight, tl.weight)
        np.testing.assert_array_equal(
            np.zeros(0) if jl.bias is None else jl.bias,
            np.zeros(0) if tl.bias is None else tl.bias)


def test_from_params_without_weights_raises_like_reference():
    p = {"scalars": {"a": np.zeros(3)}}
    assert _error(lambda: jcodr.ModelSpec.from_params(p)) == \
        _error(lambda: tcodr.ModelSpec.from_params(p))


# ---------------------------------------------------------------------------
# carrying the reference's compiled state across
# ---------------------------------------------------------------------------

def test_compiled_from_reference_runs_the_same_bitstreams(rng):
    jspec = jcodr.ModelSpec([
        jcodr.LayerSpec.conv(_sparse(rng, (10, 3, 3, 3)),
                             rng.normal(size=10).astype(np.float32),
                             stride=2, activation="relu", name="c0"),
        jcodr.LayerSpec.conv(_sparse(rng, (6, 10, 2, 2)), activation="relu",
                             name="c1"),
        jcodr.LayerSpec.dense(_sparse(rng, (5, 6 * 4 * 4)), name="fc")])
    jc = jcodr.compile(jspec, jcodr.EncodeConfig(n_unique=16), backend="smm")
    tc = compiled_from_reference(jc, "cpu")
    assert tc.backend.name == "smm" and tc.spec is None
    _assert_codes_equal(tc, jc)
    for tl, jl in zip(tc.model.layers, jc.model.layers):
        assert tl.code is not jl.code            # copied, not shared
        np.testing.assert_array_equal(tl.decoded_weights(),
                                      jl.decoded_weights())
    x = rng.integers(-6, 7, size=(2, 12, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tc.run(x, backend="tiled")),
                               np.asarray(jc.run(x, backend="tiled")),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tc.run(x)), np.asarray(jc.run(x)),
                               rtol=1e-4, atol=1e-4)
    # the conv stack is integer arithmetic end to end: exact
    conv_j = jcodr.compile(jcodr.ModelSpec(jspec.layers[:2]),
                           jcodr.EncodeConfig(n_unique=16))
    conv_t = compiled_from_reference(conv_j, "cpu", backend="smm_kernel")
    np.testing.assert_array_equal(_np(conv_t.run(x)),
                                  np.asarray(conv_j.run(x, backend="smm")))
    np.testing.assert_allclose(_np(tc.quantized_reference(x)),
                               np.asarray(jc.quantized_reference(x)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="no float weights"):
        tc.reference(x)
