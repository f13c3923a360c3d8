"""The rest of the reference API in the port, each piece against the JAX
package on seeded inputs: the codec's scalar oracle (``decode_vector``
and its stream decoders), ``escape_field_offsets``, the NumPy SMM
helpers, per-channel ``quantize_int8``, the engine's ``smm_forward`` and
``build_random_model`` shims, ``CellOptions.tag`` and the roofline
constants.  Codes, offsets, decoded vectors, op counts and integer
outputs are held exactly; quantization bit for bit.

The reference package is imported inside the tests, so the ``cuda`` test
also runs where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_reference_api.py
"""
import ast
import os
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import packing as tpacking
from repro_torch.core import rle as trle
from repro_torch.core import smm as tsmm
from repro_torch.core import ucr as tucr

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = os.path.join(ROOT, "tests", "golden", "rle_stream.npz")
# the vector of tools/regen_goldens.py::build_rle_golden
GOLDEN_UNIQUE = np.array([-90, -17, -5, 3, 12, 101], np.int64)
GOLDEN_REPS = np.array([2, 1, 4, 3, 2, 1], np.int64)
GOLDEN_INDEXES = np.array([1, 20, 7, 0, 3, 9, 15, 2, 11, 23, 5, 18, 4],
                          np.int64)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sparse(rng, shape, density, scale=0.5):
    w = rng.normal(size=shape).astype(np.float32) * scale
    w[rng.random(w.shape) > density] = 0
    return w


def _golden_stream(g, name):
    nbits, param, count, mode_bits = (int(v) for v in g[f"{name}_meta"])
    return trle.Stream(packed=g[f"{name}_packed"], nbits=nbits, param=param,
                       count=count, mode_bits=mode_bits)


# ---------------------------------------------------------------------------
# the codec's scalar oracle
# ---------------------------------------------------------------------------

def test_golden_streams_decode_by_the_scalar_path():
    """The frozen RLE bytes decode, field by field, to the vector they
    were made from — byte equality alone would also pass for two
    matching bugs (cf. tests/test_golden_formats.py)."""
    from repro.core import rle as jrle
    g = np.load(GOLDEN)
    deltas = trle.decode_escape_stream(_golden_stream(g, "deltas"))
    uniq = np.cumsum(np.concatenate(
        [[trle.delta_untransform_first(int(deltas[0]))], deltas[1:]]))
    np.testing.assert_array_equal(uniq, GOLDEN_UNIQUE)
    reps = trle.decode_rep_stream(_golden_stream(g, "reps"))
    np.testing.assert_array_equal(reps, GOLDEN_REPS)
    raw = trle.decode_escape_stream(_golden_stream(g, "indexes"),
                                    absolute_mode=True)
    assert raw.shape == (2, len(GOLDEN_INDEXES)) and raw.dtype == np.int64
    assert raw[1, 0] == 1                       # the first index is absolute
    np.testing.assert_array_equal(
        raw, jrle.decode_escape_stream(_golden_stream(g, "indexes"),
                                       absolute_mode=True))

    enc = trle.EncodedVector(
        _golden_stream(g, "deltas"), _golden_stream(g, "reps"),
        _golden_stream(g, "indexes"), vector_len=24,
        n_unique=len(GOLDEN_UNIQUE), n_weights=len(GOLDEN_INDEXES))
    want = np.zeros(24, np.int8)
    cursor = 0
    for val, rep in zip(GOLDEN_UNIQUE, GOLDEN_REPS):
        want[GOLDEN_INDEXES[cursor:cursor + rep]] = val
        cursor += rep
    got = trle.decode_vector(enc)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert enc.total_bits == int(g["total_bits"][0])


def _layers(rng):
    """Seeded conv and linear codes of both packages (byte-identical)."""
    from repro.core import ucr as jucr
    out = []
    for shape, t_m, t_n, density, u in [((12, 3, 3, 3), 4, 2, 0.5, 16),
                                        ((10, 4, 2, 2), 4, 4, 0.2, 256),
                                        ((6, 2, 5, 5), 4, 1, 1.0, 4),
                                        ((4, 2, 3, 3), 4, 2, 0.0, 16)]:
        w = _sparse(rng, shape, density)
        out.append((tucr.encode_conv_layer(w, t_m=t_m, t_n=t_n, n_unique=u),
                    jucr.encode_conv_layer(w, t_m=t_m, t_n=t_n, n_unique=u)))
    for shape, t_m in [((10, 24), 256), ((16, 12), 4)]:
        w = _sparse(rng, shape, 0.7, scale=0.3)
        out.append((tucr.encode_linear_layer(w, t_m=t_m, n_unique=16),
                    jucr.encode_linear_layer(w, t_m=t_m, n_unique=16)))
    return out


def test_scalar_oracle_equals_both_bulk_decoders(rng):
    from repro.core import rle as jrle
    for tcode, jcode in _layers(rng):
        bulk = trle.decode_layer(tcode)
        np.testing.assert_array_equal(bulk, jrle.decode_layer(jcode))
        views = trle.decode_layer_vectors(tcode)
        assert len(views) == len(tcode.vectors)
        for i, (tv, jv) in enumerate(zip(tcode.vectors, jcode.vectors)):
            got = trle.decode_vector(tv)
            assert got.dtype == np.int8 and got.shape == (tv.vector_len,)
            np.testing.assert_array_equal(got, bulk[i, : tv.vector_len])
            np.testing.assert_array_equal(got, views[i])
            np.testing.assert_array_equal(got, jrle.decode_vector(jv))
            np.testing.assert_array_equal(got,
                                          tucr.ucr_reconstruct(tcode.ucr[i]))


def test_stream_decoders_equal_the_reference(rng):
    from repro.core import rle as jrle
    for tcode, jcode in _layers(rng):
        for tv, jv in zip(tcode.vectors, jcode.vectors):
            np.testing.assert_array_equal(
                trle.decode_escape_stream(tv.deltas),
                jrle.decode_escape_stream(jv.deltas))
            np.testing.assert_array_equal(
                trle.decode_escape_stream(tv.indexes, absolute_mode=True),
                jrle.decode_escape_stream(jv.indexes, absolute_mode=True))
            np.testing.assert_array_equal(trle.decode_rep_stream(tv.reps),
                                          jrle.decode_rep_stream(jv.reps))
    for field in (1, 128, 255):
        assert trle.delta_untransform_first(field) == \
            jrle.delta_untransform_first(field)


def test_scalar_oracle_raises_on_a_truncated_stream(rng):
    q, _ = tucr.quantize_int8(_sparse(rng, (4, 1, 3, 3), 0.8))
    u = tucr.ucr_transform(q.reshape(-1))
    enc = trle.encode_vector(u.unique_vals, u.reps, u.indexes, u.vector_len)
    enc.indexes.nbits -= 1
    with pytest.raises(EOFError):
        trle.decode_vector(enc)


@given(st.lists(st.integers(-128, 127), min_size=1, max_size=256))
@settings(max_examples=100, deadline=None)
def test_size_only_equals_total_bits(vals):
    from repro.core import rle as jrle
    w = np.array(vals, dtype=np.int8)
    u = tucr.ucr_transform(w)
    enc = trle.encode_vector(u.unique_vals, u.reps, u.indexes, u.vector_len)
    size = trle.encoded_bits_size_only(u.unique_vals, u.reps, u.indexes,
                                       u.vector_len)
    assert size == enc.total_bits
    assert size == jrle.encoded_bits_size_only(u.unique_vals, u.reps,
                                               u.indexes, u.vector_len)
    np.testing.assert_array_equal(trle.decode_vector(enc), w)


# ---------------------------------------------------------------------------
# packing: the single-stream pointer doubling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("low,full,count", [(1, 8, 1), (2, 8, 37),
                                            (4, 8, 300), (7, 12, 129),
                                            (3, 5, 0)])
def test_escape_field_offsets_equal_the_reference(low, full, count, rng):
    from repro.core import packing as jpacking
    values = rng.integers(0, 1 << full, size=count)
    values[rng.random(count) < 0.6] %= 1 << low       # most fit low bits
    s = trle.encode_escape_stream(values, low, full)
    bits = tpacking.unpack_bits(s.packed, s.nbits)
    got = tpacking.escape_field_offsets(bits, count, low + 1, full + 1)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, jpacking.escape_field_offsets(bits, count, low + 1, full + 1))
    # each offset is where a field-by-field reader finds the field
    reader, want = tpacking.BitReader(s.packed, s.nbits), []
    for _ in range(count):
        want.append(reader.pos)
        reader.read(full if reader.read(1) else low)
    np.testing.assert_array_equal(got, np.array(want, np.int64))


def test_escape_field_offsets_raise_on_an_exhausted_stream(rng):
    from repro.core import packing as jpacking
    s = trle.encode_escape_stream(rng.integers(0, 256, size=50), 3, 8)
    bits = tpacking.unpack_bits(s.packed, s.nbits)
    offsets = tpacking.escape_field_offsets(bits, 50, 4, 9)
    cut = bits[: offsets[-1]]                  # ends where the last starts
    for mod in (tpacking, jpacking):
        with pytest.raises(EOFError):
            mod.escape_field_offsets(cut, 50, 4, 9)


# ---------------------------------------------------------------------------
# smm: the dense oracle, the FC lane and the op counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,ri,stride", [((6, 3, 3, 3), 9, 1),
                                             ((4, 2, 2, 2), 11, 2),
                                             ((5, 4, 1, 1), 5, 1)])
def test_conv2d_dense_ref_equals_the_reference(shape, ri, stride, rng):
    from repro.core import smm as jsmm
    w = rng.integers(-127, 128, size=shape).astype(np.int8)
    x = rng.integers(-127, 128, size=(shape[1], ri, ri + 1)).astype(np.int32)
    got = tsmm.conv2d_dense_ref(x, w, stride)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jsmm.conv2d_dense_ref(x, w, stride))
    # and the SMM lane computes the same sums from the code
    q, _ = tucr.quantize_int8(_sparse(rng, shape, 0.5))
    code = tucr.encode_conv_layer(q.astype(np.float32), t_m=4, t_n=2)
    np.testing.assert_array_equal(tsmm.conv2d_smm(x, code, stride),
                                  tsmm.conv2d_dense_ref(x, q, stride))


@pytest.mark.parametrize("shape,t_m,density", [((10, 24), 256, 0.7),
                                               ((16, 12), 4, 0.5),
                                               ((7, 5), 3, 1.0)])
def test_linear_smm_equals_the_reference_and_the_product(shape, t_m, density,
                                                         rng):
    from repro.core import smm as jsmm
    from repro.core import ucr as jucr
    w = _sparse(rng, shape, density, scale=0.3)
    tcode = tucr.encode_linear_layer(w, t_m=t_m, n_unique=16)
    jcode = jucr.encode_linear_layer(w, t_m=t_m, n_unique=16)
    x = rng.integers(-127, 128, size=shape[1]).astype(np.int64)
    got = tsmm.linear_smm(x, tcode)
    assert got.dtype == np.int64 and got.shape == (shape[0],)
    np.testing.assert_array_equal(got, jsmm.linear_smm(x, jcode))
    q = tucr.restrict_unique(tucr.quantize_int8(w)[0], 16)
    np.testing.assert_array_equal(got, q.astype(np.int64) @ x)


@pytest.mark.parametrize("feature_elems", [1, 49, 50176])
def test_smm_op_counts_equal_the_reference(feature_elems, rng):
    from repro.core import smm as jsmm
    for tcode, jcode in _layers(rng):
        got = tsmm.smm_op_counts(tcode, feature_elems)
        want = jsmm.smm_op_counts(jcode, feature_elems)
        assert list(got) == list(want) == ["mults", "accums", "dense_mults",
                                           "unique_ratio", "density"]
        assert got == want
        assert got["mults"] <= got["accums"] <= got["dense_mults"]


# ---------------------------------------------------------------------------
# per-channel quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 5, 3, 3), (12, 7)])
@pytest.mark.parametrize("axis", [None, 0, 1])
def test_quantize_int8_bit_for_bit(shape, axis, rng):
    from repro.core import ucr as jucr
    w = rng.normal(size=shape).astype(np.float32)
    w[1] = 0                                   # an all-zero channel
    tq, ts = tucr.quantize_int8(w, per_channel_axis=axis)
    jq, js = jucr.quantize_int8(w, per_channel_axis=axis)
    assert tq.dtype == jq.dtype == np.int8
    np.testing.assert_array_equal(tq, jq)
    assert ts.dtype == js.dtype == np.float32
    assert ts.shape == js.shape
    assert ts.tobytes() == js.tobytes()
    if axis is not None:
        assert ts.ndim == w.ndim and ts.shape[axis] == shape[axis]


# ---------------------------------------------------------------------------
# the engine's shims
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kernel", [False, True])
def test_smm_forward_equals_the_reference_smm_backend(kernel, stride, rng):
    """``kernel=True`` runs ``smm_kernel``'s plain version on the CPU and
    is held to the reference's ``smm`` backend (its Pallas ``smm_kernel``
    does not run on the installed JAX)."""
    from repro.core.engine import CodrConv2D as JConv
    from repro_torch.core.engine import CodrConv2D
    from repro_torch.kernels.smm_conv import ops as smm_ops
    w = _sparse(rng, (8, 3, 3, 3), 0.5)
    b = rng.normal(size=8).astype(np.float32)
    layer = CodrConv2D(w, b, stride=stride, t_m=4, t_n=2, activation="relu",
                       device="cpu")
    jlayer = JConv(w, b, stride=stride, t_m=4, t_n=2, activation="relu")
    x = rng.integers(-8, 8, size=(2, 11, 11, 3)).astype(np.float32)
    before = smm_ops.launches
    got = layer.smm_forward(torch.from_numpy(x), kernel=kernel)
    assert smm_ops.launches == before            # no kernel on the CPU
    want = np.asarray(jlayer.smm_forward(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # and the tiled forward computes the same from the same code
    np.testing.assert_array_equal(
        layer(torch.from_numpy(x)).numpy(), got.numpy())


def test_build_random_model_gives_the_reference_codes(rng):
    from repro.core import engine as jengine
    from repro_torch.core import engine as tengine
    from repro_torch.core.dataflow import ConvShape
    shapes = [ConvShape(8, 3, 3, 3, 12, 12, 1),
              ConvShape(12, 8, 3, 3, 1, 1, 2)]
    kw = dict(density=0.5, t_m=4, t_n=2, activation=None)
    model = tengine.build_random_model(
        shapes, 6, rng=np.random.default_rng(7), device="cpu", **kw)
    jmodel = jengine.build_random_model(
        shapes, 6, rng=np.random.default_rng(7), **kw)
    assert model.device.type == "cpu"
    assert [l.kind for l in model.layers] == [l.kind for l in jmodel.layers]
    for tl, jl in zip(model.layers, jmodel.layers):
        t, j = tl.code, jl.code
        assert t.shape == j.shape and (t.t_m, t.t_n) == (j.t_m, j.t_n)
        assert t.params == j.params and t.total_bits == j.total_bits
        assert np.asarray(t.scale).tobytes() == np.asarray(j.scale).tobytes()
        for tv, jv in zip(t.vectors, j.vectors, strict=True):
            for name in ("deltas", "reps", "indexes"):
                ts, js = getattr(tv, name), getattr(jv, name)
                assert ts.packed.tobytes() == js.packed.tobytes()
                assert (ts.nbits, ts.param, ts.count, ts.mode_bits) == \
                    (js.nbits, js.param, js.count, js.mode_bits)
    x = np.random.default_rng(1).integers(-5, 6, size=(2, 12, 12, 3))
    np.testing.assert_allclose(model.run(x).numpy(),
                               np.asarray(jmodel.run(x.astype(np.float32))),
                               rtol=1e-5, atol=1e-5)


def test_build_random_model_defaults_to_the_card():
    from repro_torch.core.dataflow import ConvShape
    from repro_torch.core.engine import build_random_model
    shapes = [ConvShape(4, 2, 3, 3, 6, 6, 1)]
    if torch.cuda.is_available():
        assert build_random_model(shapes, 3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_random_model(shapes, 3)


# ---------------------------------------------------------------------------
# launch: CellOptions.tag, the roofline constants; the re-exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_cell_options_tag_equals_the_reference(weights, cache):
    from repro.launch.steps import CellOptions as JOpts
    from repro_torch.launch.steps import CellOptions
    opts = CellOptions(serve_weight_dtype=weights, cache_dtype=cache)
    assert opts.tag() == JOpts(serve_weight_dtype=weights,
                               cache_dtype=cache).tag()


def test_roofline_constants_are_the_h100s_and_chip_smoke_reads_them():
    from repro_torch.launch import mesh
    assert mesh.PEAK_FLOPS_BF16 == 989e12
    assert mesh.HBM_BW == 3.35e12
    assert mesh.ICI_BW == 25e9
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {(n.module, a.name, a.asname) for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom) for a in n.names}
    assert ("repro_torch.launch.mesh", "PEAK_FLOPS_BF16", "BF16_FLOPS") \
        in imported
    assert ("repro_torch.launch.mesh", "HBM_BW", "HBM_BYTES_S") in imported
    assigned = {t.id for n in tree.body if isinstance(n, ast.Assign)
                for t in n.targets if isinstance(t, ast.Name)}
    assert not assigned & {"BF16_FLOPS", "HBM_BYTES_S"}


def test_reexports_name_the_same_objects():
    import repro_torch.api as codr
    import repro_torch.data as data
    from repro_torch.core import codr_linear
    from repro_torch.data import pipeline
    for name in ("PackedLinear", "PackedWeight", "PackedEmbedding",
                 "dense_weight", "pack_projection", "pack_embedding"):
        assert getattr(codr, name) is getattr(codr_linear, name)
        assert name in codr.__all__
    assert data.make_batch_specs is pipeline.make_batch_specs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_smm_forward_launches_smm_conv(stride):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.core.backends import get_backend
    from repro_torch.core.engine import CodrConv2D
    from repro_torch.kernels.smm_conv import ops as smm_ops
    rng = np.random.default_rng(0)
    layer = CodrConv2D(_sparse(rng, (16, 8, 3, 3), 0.5), t_m=4, t_n=4,
                       stride=stride, activation="relu", n_unique=16)
    x = torch.from_numpy(rng.integers(-127, 128, size=(2, 20, 20, 8))
                         .astype(np.float32)).cuda()
    before = smm_ops.launches
    got = layer.smm_forward(x, kernel=True)
    torch.cuda.synchronize()
    assert smm_ops.launches == before + 1
    want = get_backend("smm_kernel").conv(layer, x)
    assert torch.equal(got, want)
    host = layer.smm_forward(x, kernel=False)
    assert float((got - host).abs().max()) == 0.0
