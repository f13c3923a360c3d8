"""The port's dataflow access counters and energy cost model against the
JAX reference (``repro.core.dataflow`` / ``repro.core.cost_model``),
mirroring ``tests/test_dataflow.py``: the same ``ConvShape``s and the
same encoded codes (bits, unique counts, nonzeros from the reference's
encoder) go through both packages, and every count and energy agrees
within rtol 1e-12.  Both sides are plain Python float arithmetic, so
they agree to the last bit in practice; the tolerance only allows for
a reordered sum."""
import dataclasses

import numpy as np
import pytest

from repro.core import cost_model as jcost
from repro.core import dataflow as jflow
from repro.core import ucr as jucr
from repro.core.baselines import scnn_compress_bits, ucnn_compress_bits
from repro_torch.core import cost_model as tcost
from repro_torch.core import dataflow as tflow

RTOL = 1e-12
# (m, n, rk, ck, ri, ci, stride): test_dataflow's layer, a strided one,
# a 1x1 one and VGG16's conv1_2 at a cut spatial size
SHAPES = [(128, 64, 3, 3, 30, 30, 1), (32, 16, 5, 5, 23, 23, 2),
          (24, 40, 1, 1, 14, 14, 1), (64, 64, 3, 3, 18, 18, 1)]
FLOWS = [("codr_accesses", "CODR_TILING"), ("ucnn_accesses", "UCNN_TILING"),
         ("scnn_accesses", "SCNN_TILING")]


def _stats(shape, seed=0):
    """(bits, n_unique, n_nonzero) of a 60%-sparse layer encoded by the
    reference's encoder, as tests/test_dataflow.py builds them."""
    m, n, rk, ck = shape[:4]
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(m, n, rk, ck)).astype(np.float32)
    w[rng.random(w.shape) < 0.6] = 0
    code = jucr.encode_conv_layer(w, t_m=4, t_n=4)
    return (code.total_bits, sum(len(u.unique_vals) for u in code.ucr),
            sum(u.n_nonzero for u in code.ucr), code)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def layer(request):
    bits, nu, nn, code = _stats(request.param[:4])
    return request.param, bits, nu, nn, code


def _close(a: float, b: float) -> bool:
    return a == b or abs(a - b) <= RTOL * max(abs(a), abs(b))


def _assert_counts_equal(t, j):
    td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
    assert td.keys() == jd.keys()
    assert td.pop("name") == jd.pop("name")
    for k in td:
        assert _close(td[k], jd[k]), (k, td[k], jd[k])
    assert _close(t.total_sram, j.total_sram)
    assert _close(t.feature_sram, j.feature_sram)


def test_tilings_match_reference():
    for name in ("CODR_TILING", "UCNN_TILING", "SCNN_TILING"):
        assert dataclasses.asdict(getattr(tflow, name)) == \
            dataclasses.asdict(getattr(jflow, name))
    assert dataclasses.asdict(tflow.codr_tiling(t_m=8, t_n=2)) == \
        dataclasses.asdict(jflow.codr_tiling(t_m=8, t_n=2))


@pytest.mark.parametrize("fn,tiling", FLOWS)
def test_access_counts_match_reference(layer, fn, tiling):
    shape, bits, nu, nn, _ = layer
    t = getattr(tflow, fn)(tflow.ConvShape(*shape), getattr(tflow, tiling),
                           bits, nu, nn)
    j = getattr(jflow, fn)(jflow.ConvShape(*shape), getattr(jflow, tiling),
                           bits, nu, nn)
    _assert_counts_equal(t, j)


@pytest.mark.parametrize("fn,tiling", FLOWS)
def test_energy_matches_reference(layer, fn, tiling):
    shape, bits, nu, nn, _ = layer
    t = tcost.energy(getattr(tflow, fn)(tflow.ConvShape(*shape),
                                        getattr(tflow, tiling), bits, nu, nn))
    j = jcost.energy(getattr(jflow, fn)(jflow.ConvShape(*shape),
                                        getattr(jflow, tiling), bits, nu, nn))
    td, jd = t.as_dict(), j.as_dict()
    assert td.pop("name") == jd.pop("name")
    for k in td:
        assert _close(td[k], jd[k]), (k, td[k], jd[k])


def test_layer_cost_matches_reference(layer):
    shape, bits, nu, nn, _ = layer
    for t_m in (2, 4, 8):
        t = tcost.layer_cost(tflow.ConvShape(*shape), tflow.codr_tiling(t_m),
                             bits, nu, nn)
        j = jcost.layer_cost(jflow.ConvShape(*shape), jflow.codr_tiling(t_m),
                             bits, nu, nn)
        assert _close(t["sram"], j["sram"])
        assert _close(t["energy_uj"], j["energy_uj"])
        _assert_counts_equal(t["accesses"], j["accesses"])


@pytest.mark.parametrize("bits_pw", [1.7, 3.25, 8.0])
def test_weight_sram_cost_ratio_matches_reference(bits_pw):
    for row in (32, 64, 128):
        assert _close(tcost.weight_sram_cost_ratio(bits_pw, row),
                      jcost.weight_sram_cost_ratio(bits_pw, row))


def test_constants_match_reference():
    for name in ("DRAM_PJ_PER_BYTE", "SRAM_8B_PJ", "SRAM_ROW_PJ", "RF_8B_PJ",
                 "MULT_INT8_PJ", "ADD_INT16_PJ", "XBAR_PJ"):
        assert getattr(tcost, name) == getattr(jcost, name)


# -- test_dataflow.py's claims, held inside the port ------------------------

@pytest.fixture(scope="module")
def first_layer():
    shape = tflow.ConvShape(*SHAPES[0])
    bits, nu, nn, code = _stats(SHAPES[0][:4])
    return shape, bits, nu, nn, code


def test_codr_output_stationary_and_input_fetches(first_layer):
    shape, bits, nu, nn, _ = first_layer
    acc = tflow.codr_accesses(shape, tflow.CODR_TILING, bits, nu, nn)
    assert acc.output_sram == shape.n_outputs
    assert acc.input_sram == shape.n_inputs * int(np.ceil(
        shape.m / (tflow.CODR_TILING.t_pu * tflow.CODR_TILING.t_m)))


def test_codr_fewer_feature_accesses_than_baselines(first_layer):
    shape, bits, nu, nn, _ = first_layer
    codr = tflow.codr_accesses(shape, tflow.CODR_TILING, bits, nu, nn)
    ucnn = tflow.ucnn_accesses(shape, tflow.UCNN_TILING, bits, nu, nn)
    scnn = tflow.scnn_accesses(shape, tflow.SCNN_TILING, scnn_compress_bits(
        jucr.quantize_int8(np.zeros((1, 1)))[0]), nu, nn)
    assert codr.feature_sram < ucnn.feature_sram
    assert codr.feature_sram < scnn.output_sram + scnn.input_sram
    assert codr.weight_bits_streamed > bits          # re-streamed
    assert tcost.weight_sram_cost_ratio(bits / shape.n_weights) > 5.0


def test_energy_model_relative_ordering(first_layer):
    shape, bits, nu, nn, code = first_layer
    q, _ = jucr.quantize_int8(np.random.default_rng(0).normal(
        size=(shape.m, shape.n, shape.rk, shape.ck)).astype(np.float32))
    codr = tcost.energy(tflow.codr_accesses(shape, tflow.CODR_TILING, bits,
                                            nu, nn))
    ucnn = tcost.energy(tflow.ucnn_accesses(
        shape, tflow.UCNN_TILING, ucnn_compress_bits(code.ucr), nu, nn))
    scnn = tcost.energy(tflow.scnn_accesses(
        shape, tflow.SCNN_TILING, scnn_compress_bits(q), nu,
        shape.n_weights * 0.4))
    assert 0 < codr.total_uj < ucnn.total_uj
    assert codr.total_uj < scnn.total_uj


def test_conv_shape_arithmetic_matches_reference():
    for shape in SHAPES:
        t, j = tflow.ConvShape(*shape), jflow.ConvShape(*shape)
        for k in ("ro", "co", "n_weights", "n_outputs", "n_inputs", "macs"):
            assert getattr(t, k) == getattr(j, k)
