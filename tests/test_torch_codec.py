"""The port's offline codec against the JAX reference package: the same
float weights encode to byte-identical streams, decode identically, and
the frozen RLE golden is reproduced byte for byte."""
import os

import numpy as np
import pytest

from repro.core import packing as jpacking
from repro.core import rle as jrle
from repro.core import ucr as jucr
from repro_torch.core import packing as tpacking
from repro_torch.core import rle as trle
from repro_torch.core import ucr as tucr

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "rle_stream.npz")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _sparse(rng, shape, density, scale=0.5):
    w = rng.normal(size=shape).astype(np.float32) * scale
    w[rng.random(w.shape) > density] = 0
    return w


def _assert_stream_equal(a, b):
    assert a.packed.dtype == b.packed.dtype == np.uint8
    assert a.packed.tobytes() == b.packed.tobytes()
    assert (a.nbits, a.param, a.count, a.mode_bits) == \
        (b.nbits, b.param, b.count, b.mode_bits)


def _assert_code_equal(t, j):
    assert t.shape == j.shape and (t.t_m, t.t_n) == (j.t_m, j.t_n)
    assert t.params == j.params
    assert np.asarray(t.scale).dtype == np.asarray(j.scale).dtype
    assert np.asarray(t.scale).tobytes() == np.asarray(j.scale).tobytes()
    assert t.total_bits == j.total_bits
    assert len(t.vectors) == len(j.vectors) == len(t.ucr) == len(j.ucr)
    for tv, jv in zip(t.vectors, j.vectors):
        for name in ("deltas", "reps", "indexes"):
            _assert_stream_equal(getattr(tv, name), getattr(jv, name))
        assert (tv.vector_len, tv.n_unique, tv.n_weights) == \
            (jv.vector_len, jv.n_unique, jv.n_weights)
    for tu, ju in zip(t.ucr, j.ucr):
        for name in ("unique_vals", "reps", "indexes"):
            np.testing.assert_array_equal(getattr(tu, name),
                                          getattr(ju, name))
        assert tu.vector_len == ju.vector_len


@pytest.mark.parametrize("shape,t_m,t_n", [((8, 4, 3, 3), 4, 2),
                                           ((10, 3, 3, 3), 4, 4),
                                           ((5, 3, 2, 2), 2, 2),
                                           ((6, 2, 5, 5), 4, 1)])
@pytest.mark.parametrize("density", [0.05, 0.5, 1.0])
@pytest.mark.parametrize("n_unique", [256, 16, 4])
def test_conv_layer_encodes_byte_identical(shape, t_m, t_n, density,
                                           n_unique, rng):
    w = _sparse(rng, shape, density)
    _assert_code_equal(
        tucr.encode_conv_layer(w, t_m=t_m, t_n=t_n, n_unique=n_unique),
        jucr.encode_conv_layer(w, t_m=t_m, t_n=t_n, n_unique=n_unique))


@pytest.mark.parametrize("params", [(4, 4, 4), (1, 2, 3), (8, 8, 8)])
def test_fixed_rle_params_encode_byte_identical(params, rng):
    w = _sparse(rng, (8, 3, 3, 3), 0.6)
    _assert_code_equal(tucr.encode_conv_layer(w, params=params),
                       jucr.encode_conv_layer(w, params=params))


@pytest.mark.parametrize("shape,t_m", [((10, 24), 256), ((16, 12), 4),
                                       ((7, 5), 3)])
def test_linear_layer_encodes_byte_identical(shape, t_m, rng):
    w = _sparse(rng, shape, 0.7, scale=0.3)
    _assert_code_equal(tucr.encode_linear_layer(w, t_m=t_m, n_unique=16),
                       jucr.encode_linear_layer(w, t_m=t_m, n_unique=16))


def test_all_zero_layer_encodes_byte_identical():
    w = np.zeros((4, 2, 3, 3), np.float32)
    _assert_code_equal(tucr.encode_conv_layer(w, t_m=4, t_n=2),
                       jucr.encode_conv_layer(w, t_m=4, t_n=2))


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_decode_layer_identical(density, rng):
    w = _sparse(rng, (12, 3, 3, 3), density)
    tcode = tucr.encode_conv_layer(w, t_m=4, t_n=2, n_unique=16)
    jcode = jucr.encode_conv_layer(w, t_m=4, t_n=2, n_unique=16)
    got = trle.decode_layer(tcode, pad_to=40)
    np.testing.assert_array_equal(got, jrle.decode_layer(jcode, pad_to=40))
    np.testing.assert_array_equal(trle.decode_layer(tcode),
                                  jrle.decode_layer(jcode))
    # and the decode is lossless: every row is its vector's reconstruction
    for i, u in enumerate(tcode.ucr):
        np.testing.assert_array_equal(got[i, : u.vector_len],
                                      tucr.ucr_reconstruct(u))


def test_quantize_and_restrict_identical(rng):
    w = rng.normal(size=(6, 5, 3, 3)).astype(np.float32)
    tq, ts = tucr.quantize_int8(w)
    jq, js = jucr.quantize_int8(w)
    np.testing.assert_array_equal(tq, jq)
    assert ts.dtype == js.dtype and ts.tobytes() == js.tobytes()
    for u in (3, 4, 16, 100, 256):
        np.testing.assert_array_equal(tucr.restrict_unique(tq, u),
                                      jucr.restrict_unique(jq, u))


def test_layer_params_search_identical(rng):
    q, _ = tucr.quantize_int8(_sparse(rng, (8, 4, 3, 3), 0.5))
    vecs = [tucr.ucr_transform(q[m0:m0 + 4, n].reshape(-1))
            for m0 in (0, 4) for n in range(4)]
    jvecs = [jucr.ucr_transform(q[m0:m0 + 4, n].reshape(-1))
             for m0 in (0, 4) for n in range(4)]
    assert trle.layer_params_search(vecs, 36) == \
        jrle.layer_params_search(jvecs, 36)


def test_bit_packing_primitives_identical(rng):
    vals = rng.integers(0, 1 << 12, size=40).astype(np.uint64)
    widths = rng.integers(12, 17, size=40)
    tp, tn = tpacking.pack_varbits(vals, widths)
    jp, jn = jpacking.pack_varbits(vals, widths)
    assert tn == jn and tp.tobytes() == jp.tobytes()
    bits = tpacking.unpack_bits(tp, tn)
    offsets = np.cumsum(widths) - widths
    np.testing.assert_array_equal(
        tpacking.gather_bitfields(bits, offsets, widths), vals)
    reader = tpacking.BitReader(tp, tn)
    assert [reader.read(int(w)) for w in widths[:5]] == \
        [int(v) for v in vals[:5]]
    np.testing.assert_array_equal(reader.read_many(widths[5:]), vals[5:])


def test_rle_golden_reproduced_byte_for_byte():
    """The vector of ``tools/regen_goldens.py::build_rle_golden`` through
    the port's ``rle.encode_vector`` gives the frozen bytes."""
    unique_vals = np.array([-90, -17, -5, 3, 12, 101], np.int64)
    reps = np.array([2, 1, 4, 3, 2, 1], np.int64)
    indexes = np.array([1, 20, 7, 0, 3, 9, 15, 2, 11, 23, 5, 18, 4],
                       np.int64)
    enc = trle.encode_vector(unique_vals, reps, indexes, vector_len=24)
    golden = np.load(GOLDEN)
    current = {"total_bits": np.array([enc.total_bits], np.int64)}
    for name in ("deltas", "reps", "indexes"):
        s = getattr(enc, name)
        current[f"{name}_packed"] = np.asarray(s.packed, np.uint8)
        current[f"{name}_meta"] = np.array(
            [s.nbits, s.param, s.count, s.mode_bits], np.int64)
    assert sorted(golden.files) == sorted(current)
    for k in golden.files:
        assert golden[k].dtype == current[k].dtype, k
        assert golden[k].tobytes() == current[k].tobytes(), k
