"""Property tests for the port's tuning-lane cost-model invariants,
mirroring ``tests/test_tune_props.py`` property for property: each
example runs the port's function and the reference's on the same
inputs, holds them equal, and checks the property on the port.

1. ``codr_accesses`` is monotone in the tile counts — growing ``t_m``
   never increases input SRAM traffic; shrinking the spatial tile never
   decreases weight re-streaming.
2. ``energy()`` totals are exactly the sum of their components.
3. The §III-C per-layer RLE parameter search never beats the exhaustive
   fixed-width sweep over the same space.

Deterministic twins live in ``tests/test_torch_tune.py``.
"""
import dataclasses
import itertools

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import cost_model as jcost_model
from repro.core import dataflow as jdataflow
from repro.core import rle as jrle
from repro.core import ucr as jucr
from repro_torch.core import cost_model, dataflow, rle, ucr
from repro_torch.core.dataflow import ConvShape


def conv_shapes():
    return st.builds(
        ConvShape,
        st.integers(1, 128),          # m
        st.integers(1, 64),           # n
        st.just(3), st.just(3),       # rk, ck
        st.integers(4, 32),           # ri
        st.integers(4, 32),           # ci
        st.just(1))


def _jshape(shape):
    return jdataflow.ConvShape(*dataclasses.astuple(shape))


def _jtiling(tiling):
    return jdataflow.TilingConfig(*dataclasses.astuple(tiling))


def _accesses(shape, tiling, bits, nu, nn):
    """The port's counts, held equal to the reference's."""
    acc = dataflow.codr_accesses(shape, tiling, bits, nu, nn)
    jacc = jdataflow.codr_accesses(_jshape(shape), _jtiling(tiling), bits,
                                   nu, nn)
    assert dataclasses.asdict(acc) == dataclasses.asdict(jacc)
    return acc


@given(conv_shapes(), st.integers(1, 16), st.integers(1, 16),
       st.floats(1e2, 1e7), st.floats(1.0, 1e4), st.floats(1.0, 1e5))
@settings(max_examples=100, deadline=None)
def test_codr_accesses_monotone_in_t_m(shape, t_m_a, t_m_b, bits, nu, nn):
    lo, hi = sorted((t_m_a, t_m_b))
    acc_lo = _accesses(shape, dataflow.codr_tiling(lo), bits, nu, nn)
    acc_hi = _accesses(shape, dataflow.codr_tiling(hi), bits, nu, nn)
    assert acc_hi.input_sram <= acc_lo.input_sram
    assert acc_hi.output_sram == acc_lo.output_sram
    assert acc_hi.weight_sram_rows == acc_lo.weight_sram_rows


@given(conv_shapes(), st.integers(1, 8), st.integers(1, 8),
       st.floats(1e2, 1e7))
@settings(max_examples=100, deadline=None)
def test_weight_restream_monotone_in_spatial_tile(shape, t_sp_a, t_sp_b,
                                                  bits):
    lo, hi = sorted((t_sp_a, t_sp_b))
    cfg_small = dataclasses.replace(dataflow.CODR_TILING, t_ro=lo, t_co=lo)
    cfg_big = dataclasses.replace(dataflow.CODR_TILING, t_ro=hi, t_co=hi)
    a_small = _accesses(shape, cfg_small, bits, 10.0, 10.0)
    a_big = _accesses(shape, cfg_big, bits, 10.0, 10.0)
    assert a_small.weight_sram_rows >= a_big.weight_sram_rows


@given(conv_shapes(), st.floats(1e2, 1e7), st.floats(1.0, 1e4),
       st.floats(1.0, 1e5))
@settings(max_examples=100, deadline=None)
def test_energy_total_is_sum_of_components(shape, bits, nu, nn):
    acc = _accesses(shape, dataflow.CODR_TILING, bits, nu, nn)
    e = cost_model.energy(acc)
    je = jcost_model.energy(jdataflow.codr_accesses(
        _jshape(shape), jdataflow.CODR_TILING, bits, nu, nn))
    assert dataclasses.asdict(e) == dataclasses.asdict(je)
    assert e.total_uj == pytest.approx(
        e.dram_uj + e.sram_uj + e.rf_uj + e.alu_uj + e.crossbar_uj,
        rel=1e-12)


@given(st.lists(st.integers(-128, 127), min_size=1, max_size=64),
       st.integers(1, 4))
@settings(max_examples=30, deadline=None)
def test_rle_search_never_beats_exhaustive_sweep(vals, n_vecs):
    w = np.array(vals * n_vecs, dtype=np.int8)
    vector_len = len(vals)
    vecs = [ucr.ucr_transform(w[i * vector_len:(i + 1) * vector_len])
            for i in range(n_vecs)]
    searched = rle.layer_bits_size_only(vecs, vector_len)
    assert searched == jrle.layer_bits_size_only(
        [jucr.ucr_transform(w[i * vector_len:(i + 1) * vector_len])
         for i in range(n_vecs)], vector_len)
    oracle = min(
        rle.layer_bits_size_only(vecs, vector_len, params=p)
        for p in itertools.product(rle.PARAM_SEARCH_SPACE, repeat=3))
    assert oracle <= searched
