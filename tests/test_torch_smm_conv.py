"""The port's SMM convolution against the JAX reference: the operand
packer, the plain version (the CPU path of the wrapper) and, on a card,
the CUDA kernel.

The SMM lane is integer arithmetic, so every comparison here is exact
(max-abs-diff 0).  The reference side is ``repro.kernels.smm_conv.ref.
smm_conv_ref``, ``repro.kernels.smm_conv.ops.pack_smm_operands`` and
``repro.core.smm.conv2d_smm_batched`` — the Pallas kernel itself does
not run on the installed JAX.  The reference package is imported inside
the tests, so the ``cuda`` tests also run where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_smm_conv.py
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import smm as tsmm
from repro_torch.core import ucr as tucr
from repro_torch.kernels.int8_features import ops as feats
from repro_torch.kernels.int8_features.ref import (epilogue_plain,
                                                   quantize_plain)
from repro_torch.kernels.smm_conv import ops as tops
from repro_torch.kernels.smm_conv import ref as tref


def _jax_ref():
    """(ucr, smm, ops, ref) modules of the JAX reference package."""
    pytest.importorskip("jax")
    from repro.core import smm, ucr
    from repro.kernels.smm_conv import ops, ref
    return ucr, smm, ops, ref


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sparse(rng, shape, density):
    w = rng.normal(size=shape).astype(np.float32)
    w[rng.random(w.shape) > density] = 0
    return w


# (m, n, rk, ck, ri, ci, t_m, t_n); m=6/t_m=4 and m=10/t_m=4 leave a
# ragged last output-channel tile
SHAPES = [(4, 3, 3, 3, 10, 10, 4, 2), (6, 2, 3, 3, 11, 11, 4, 2),
          (10, 3, 2, 2, 12, 12, 4, 4), (8, 5, 1, 1, 6, 6, 2, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", [0.2, 0.8])
def test_pack_smm_operands_equal_reference(shape, density, rng):
    jucr, _, jops, _ = _jax_ref()
    m, n, rk, ck, _, _, t_m, t_n = shape
    w = _sparse(rng, (m, n, rk, ck), density)
    jcode = jucr.encode_conv_layer(w, t_m=t_m, t_n=t_n)
    tcode = tucr.encode_conv_layer(w, t_m=t_m, t_n=t_n)
    jd, je, jm = jops.pack_smm_operands(jcode, n)
    td, te, tm = tops.pack_smm_operands(tcode, n)
    assert td.dtype == jd.dtype and te.dtype == je.dtype
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(te, je)
    # the JAX packer's meta, plus the port's int8 flag
    assert {k: tm[k] for k in jm} == jm and tm["int8_weights"] is True


def test_pack_smm_operands_all_zero_layer_equal_reference():
    jucr, _, jops, _ = _jax_ref()
    w = np.zeros((4, 2, 3, 3), np.float32)
    jd, je, jm = jops.pack_smm_operands(jucr.encode_conv_layer(w, t_m=4,
                                                               t_n=2), 2)
    td, te, tm = tops.pack_smm_operands(tucr.encode_conv_layer(w, t_m=4,
                                                               t_n=2), 2)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(te, je)
    assert {k: tm[k] for k in jm} == jm and tm["int8_weights"] is True


@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_smm_conv_batched_cpu_exact_vs_reference(shape, stride, rng):
    """The wrapper's CPU path (plain version) == JAX ``smm_conv_ref`` ==
    ``conv2d_smm_batched``, exactly, with a batch of 3."""
    jucr, jsmm, _, jref = _jax_ref()
    m, n, rk, ck, ri, ci, t_m, t_n = shape
    w = _sparse(rng, (m, n, rk, ck), 0.5)
    jcode = jucr.encode_conv_layer(w, t_m=t_m, t_n=t_n)
    tcode = tucr.encode_conv_layer(w, t_m=t_m, t_n=t_n)
    x = rng.integers(-127, 128, size=(3, n, ri, ci)).astype(np.int8)
    got = tops.smm_conv_batched(torch.from_numpy(x.astype(np.float32)), tcode,
                                stride=stride)
    assert got.dtype == torch.float32
    want = jsmm.conv2d_smm_batched(x.astype(np.int64), jcode, stride)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    for b in range(3):
        ref = np.asarray(jref.smm_conv_ref(x[b], jcode, stride=stride))
        np.testing.assert_array_equal(got[b].numpy(), ref)
    # the port's own NumPy lane and dense oracle agree too
    np.testing.assert_array_equal(
        tsmm.conv2d_smm_batched(x.astype(np.int64), tcode, stride), want)
    np.testing.assert_array_equal(
        tref.smm_conv_ref(x[0], tcode, stride=stride).numpy(),
        want[0].astype(np.float32))


def test_smm_conv_all_zero_layer_is_zero(rng):
    w = np.zeros((4, 2, 3, 3), np.float32)
    code = tucr.encode_conv_layer(w, t_m=4, t_n=2)
    x = torch.from_numpy(rng.integers(-8, 8, size=(2, 8, 8)).astype(
        np.float32))
    y = tops.smm_conv(x, code)
    assert y.shape == (4, 6, 6) and float(y.abs().max()) == 0.0


def test_decode_dense_weights_equal_reference(rng):
    jucr, _, _, jref = _jax_ref()
    w = _sparse(rng, (10, 3, 3, 3), 0.5)
    np.testing.assert_array_equal(
        tref.decode_dense_weights(tucr.encode_conv_layer(w), 3),
        jref.decode_dense_weights(jucr.encode_conv_layer(w), 3))


def test_cpu_tensors_never_reach_the_kernel(rng):
    """CPU tensors take the plain version and leave the launch count
    alone; the kernel wrapper itself refuses them."""
    w = _sparse(rng, (4, 2, 3, 3), 0.5)
    code = tucr.encode_conv_layer(w, t_m=4, t_n=2)
    deltas, entries, meta = tops.smm_operands_on(code, 2, "cpu")
    x = torch.zeros(1, 2, 8, 8)
    before = tops.launches
    tops.smm_conv_batched(x, code, operands=(deltas, entries, meta))
    assert tops.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.smm_conv_cuda(x, deltas, entries, t_m=4, ro=6, co=6)


def test_stream_buffer_is_kept_per_stream_and_grows_zeroed():
    """``_build.stream_buffer`` (the sm90 scratch, the stats accumulator):
    one buffer per (device, stream), reused while it holds enough, made
    anew and zero when a call needs more."""
    from repro_torch.kernels import _build
    bufs, cpu = {}, torch.device("cpu")
    a = _build.stream_buffer(bufs, cpu, 1, 8, torch.int32)
    assert a.shape == (8,) and not a.any()
    a.fill_(5)
    assert _build.stream_buffer(bufs, cpu, 1, 4, torch.int32) is a
    b = _build.stream_buffer(bufs, cpu, 2, 4, torch.int32)
    assert b is not a and not b.any()
    c = _build.stream_buffer(bufs, cpu, 1, 16, torch.int32)
    assert c.shape == (16,) and not c.any() and bufs[(None, 1)] is c


def test_kernel_caps_is_a_literal_with_the_registry_keys():
    assert {"kinds", "integer_activations", "description"} <= set(
        tops.KERNEL_CAPS)
    assert tops.KERNEL_CAPS["kinds"] == ("conv",)


# -- the sm90 instance's arithmetic, emulated on the host -----------------

def _emulate_sm90(x, deltas, entries, *, t_m, ro, co, store_padding=False,
                  epi=None, quant=None):
    """NumPy emulation of ``smm_conv_sm90.cu`` at stride 1.

    Phase 1 builds the dense int8 weight matrix, K ordered (tap r, tap c,
    input channel n) with n padded to 32, by storing value[u] for each
    entry and skipping padding entries (``store_padding`` stores them, as
    value[U] = 0, which a correct kernel must not do).  Phase 2 stages x
    channel-innermost in int8, pixels linearized as q = y·CI + x, and per
    tile of ``ops.sm90_plan`` takes the int32 sum of the window shifted by
    r·CI + c against the tap's weights; outputs at x ≥ CO are dropped.
    ``quant`` (a scale) emulates phase 1b on raw features: each value
    becomes clamp(rint(x / scale), -127, 127) in float32 (an IEEE
    division, half to even) before it is staged.

    ``epi`` (a dict: ``x_scale``, ``layer_scale``, ``bias``, ``relu``,
    ``m``, ``buf``, ``c0``) emulates the store with the layer's epilogue:
    each of the first ``m`` rows goes int32 → float32, times float32(layer
    scale · x scale), plus the bias, then ReLU, into channels ``c0 ..
    c0 + m`` of the NCHW buffer ``buf``, which it returns; nothing else
    of ``buf`` is written."""
    x = np.asarray(x)
    b, n_in, ri, ci = x.shape
    m_tiles, _, u_plus = deltas.shape
    plan = tops.sm90_plan(x.shape, deltas.shape, t_m=t_m, ro=ro, co=co)
    kh, kw = ri - ro + 1, ci - co + 1
    k_pad, m_out = plan["chunks"] * 32, m_tiles * t_m
    vals = np.cumsum(np.rint(deltas).astype(np.int64), axis=-1)
    w = np.zeros((plan["m_pad"], kh * kw, k_pad), np.int8)
    for mt in range(m_tiles):
        for n in range(n_in):
            for u, ml, r, c in entries[mt, n]:
                if u == u_plus - 1:
                    if not store_padding:
                        continue
                    v = 0
                else:
                    v = vals[mt, n, u]
                assert -128 <= v <= 127
                w[mt * t_m + ml, r * kw + c, n] = v
    if quant is not None:
        x = np.clip(np.rint(x / np.float32(quant)), -127, 127)
    assert np.array_equal(x, np.rint(x)) and np.abs(x).max() <= 127
    plane = ri * ci
    xs = np.zeros((b, plane + plan["p"], k_pad), np.int8)
    xs[:, :plane, :n_in] = x.reshape(b, n_in, plane).transpose(0, 2, 1)
    bn = plan["bn"]
    q_img = ro * ci
    lin = np.zeros((b, plan["m_pad"], -(-q_img // bn) * bn), np.int32)
    for q0 in range(0, q_img, bn):
        win = xs[:, q0 : q0 + plan["p"]].astype(np.int32)   # (B, P, K)
        for r in range(kh):
            for c in range(kw):
                sh = r * ci + c
                assert sh + bn <= plan["p"]
                lin[:, :, q0 : q0 + bn] += np.einsum(
                    "mk,bpk->bmp", w[:, r * kw + c].astype(np.int32),
                    win[:, sh : sh + bn])
    out = lin[:, :m_out, :q_img].reshape(b, m_out, ro, ci)[..., :co]
    if epi is None:
        return out.astype(np.float32)
    s = np.float32(np.float64(epi["layer_scale"]) * np.float64(epi["x_scale"]))
    v = out[:, :epi["m"]].astype(np.float32) * s
    if epi["bias"] is not None:
        v = v + epi["bias"][None, :, None, None]
    if epi["relu"]:
        v = np.where(np.isnan(v), v, np.maximum(v, np.float32(0)))
    buf, c0 = epi["buf"], epi["c0"]
    buf[:, c0:c0 + epi["m"]] = v
    return buf


def _stride1_case(rng, m, n, rk, ck, ri, ci, t_m, t_n, b=2, density=0.5):
    w = _sparse(rng, (m, n, rk, ck), density)
    tcode = tucr.encode_conv_layer(w, t_m=t_m, t_n=t_n)
    deltas, entries, meta = tops.pack_smm_operands(tcode, n)
    x = rng.integers(-127, 128, size=(b, n, ri, ci)).astype(np.float32)
    return w, tcode, deltas, entries, meta, x


SM90_EMU_SHAPES = SHAPES + [(10, 48, 3, 3, 9, 11, 4, 4),   # partial chunk
                            (6, 33, 3, 2, 7, 8, 4, 2),     # 1 channel over
                            # 5x5 past 64 channels: one warpgroup, two
                            # 64-row tiles (two overflow shared memory)
                            (72, 8, 5, 5, 9, 9, 4, 4)]


@pytest.mark.parametrize("shape", SM90_EMU_SHAPES)
def test_sm90_emulation_exact_vs_plain_and_reference(shape, rng):
    """The sm90 instance's int8 arithmetic, emulated: == the plain
    version == JAX ``conv2d_smm_batched``, exactly, at stride 1 (a ragged
    last m_tile at m = 10, t_m = 4; a partial 32-channel chunk at
    n = 48)."""
    jucr, jsmm, _, _ = _jax_ref()
    m, n, rk, ck, ri, ci, t_m, t_n = shape
    w, _, deltas, entries, meta, x = _stride1_case(rng, *shape)
    ro, co = ri - rk + 1, ci - ck + 1
    assert meta["int8_weights"]
    got = _emulate_sm90(x, deltas, entries, t_m=t_m, ro=ro, co=co)
    plain = tref.smm_conv_plain(torch.from_numpy(x), torch.from_numpy(deltas),
                                torch.from_numpy(entries), t_m=t_m, ro=ro,
                                co=co)
    np.testing.assert_array_equal(got, plain.numpy())
    jcode = jucr.encode_conv_layer(w, t_m=t_m, t_n=t_n)
    want = jsmm.conv2d_smm_batched(x.astype(np.int64), jcode, 1)
    np.testing.assert_array_equal(got[:, :m], want.astype(np.float32))


def test_sm90_emulation_skips_padding_entries(rng):
    """A vector with a real weight at (m_local 0, r 0, c 0) and padding
    entries (U, 0, 0, 0): skipping them is exact; storing them, as the
    zero product row, overwrites that weight, and the test tells."""
    w = np.zeros((4, 2, 3, 3), np.float32)
    w[0, 0, 0, 0] = 1.0                 # the slot padding points at
    w[2, 0, 1, 2] = -0.5
    w[1, 1, :, :] = rng.normal(size=(3, 3))   # a longer vector: padding
    code = tucr.encode_conv_layer(w, t_m=4, t_n=2)
    deltas, entries, meta = tops.pack_smm_operands(code, 2)
    u_pad = deltas.shape[2] - 1
    assert (entries[0, 0, :, 0] == u_pad).any()       # vector 0 has padding
    real = entries[0, 0][entries[0, 0, :, 0] != u_pad]
    assert ((real[:, 1:] == 0).all(axis=1)).any()      # and a weight at 0,0,0
    x = rng.integers(-127, 128, size=(2, 2, 8, 8)).astype(np.float32)
    plain = tref.smm_conv_plain(torch.from_numpy(x), torch.from_numpy(deltas),
                                torch.from_numpy(entries), t_m=4, ro=6,
                                co=6).numpy()
    np.testing.assert_array_equal(
        _emulate_sm90(x, deltas, entries, t_m=4, ro=6, co=6), plain)
    wrong = _emulate_sm90(x, deltas, entries, t_m=4, ro=6, co=6,
                          store_padding=True)
    assert not np.array_equal(wrong, plain)


# the layer's epilogue, as the sm90 store applies it: (bias, relu, a
# channel slice of a wider output as (channels before it, after it))
EPILOGUES = [(False, False, None), (True, False, None), (False, True, (0, 3)),
             (True, True, (5, 2))]


def _fused_case(rng, m, b, ro, co, bias, relu, where, scale=0.0173):
    """The epilogue's operands for an ``m``-channel layer: ``(kw, buf,
    c0)``, ``kw`` the fused call's keywords (``out`` a channel slice of
    ``buf``, a 7-filled NCHW buffer, where ``where`` asks for one)."""
    before, after = where or (0, 0)
    buf = torch.full((b, before + m + after, ro, co), 7.0)
    kw = dict(x_scale=torch.tensor([scale], dtype=torch.float32),
              layer_scale=0.0421,
              bias=torch.from_numpy(rng.normal(size=m).astype(np.float32)
                                    * 40) if bias else None,
              relu=relu, out=buf[:, before:before + m] if where else None)
    return kw, buf, before


def _untouched(buf, c0, m) -> bool:
    return bool((buf[:, :c0] == 7).all() and (buf[:, c0 + m:] == 7).all())


# the features of a fused call: int8 features (the scale the epilogue's
# alone), or raw features (``raw_features``) with their scale: whole
# numbers within ±127 at scale 1, half-way points (k + 0.5)·s (s a power
# of two, so each point is exact and rounds half to even), values past
# ±127·s (clamped)
X_KINDS = ("int8", "raw_whole", "raw_half", "raw_clamp")


def _features(rng, kind, x_int):
    """``(x, scale, raw)`` of ``kind`` for whole-number ``x_int`` (NCHW
    within ±127): the call's features, their scale and whether they are
    raw; the raw kinds hold what they stand for."""
    if kind == "int8":
        return x_int, 0.0173, False
    if kind == "raw_whole":
        return x_int, 1.0, True
    if kind == "raw_half":
        x = ((np.minimum(x_int, 126) + 0.5) * 0.125).astype(np.float32)
        assert (np.abs(x / 0.125 - np.rint(x / 0.125)) == 0.5).all()
        return x, 0.125, True
    x = (rng.uniform(-200, 200, size=x_int.shape) * 0.0173).astype(
        np.float32)
    assert (np.abs(x / np.float32(0.0173)) > 127.5).any()
    return x, 0.0173, True


def _int8_of(x, scale, raw):
    """The int8 features of a call's ``x``: ``quantize_plain`` of raw
    features (NCHW), else ``x``."""
    x = torch.from_numpy(x)
    if not raw:
        return x
    return quantize_plain(x.permute(0, 2, 3, 1), torch.tensor([scale]))


@pytest.mark.parametrize("x_kind", X_KINDS)
@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("shape", SM90_EMU_SHAPES)
def test_sm90_fused_store_emulated_equals_the_plain_epilogue(shape, epi,
                                                            x_kind, rng):
    """The sm90 store with the layer's epilogue, emulated, and the
    wrapper's fused call on CPU tensors (``smm_conv_batched``): bit for
    bit ``epilogue_plain(smm_conv_plain(...))``, with and without bias
    and ReLU; the rows past M of a ragged last m_tile (m = 6, 10) are
    not written, nor the channels beside a slice.  On raw features
    phase 1b's quantization, emulated, and the wrapper's are
    ``quantize_plain`` first."""
    m, n, rk, ck, ri, ci, t_m, t_n = shape
    _, code, deltas, entries, meta, x = _stride1_case(rng, *shape)
    x, scale, raw_features = _features(rng, x_kind, x)
    ro, co = ri - rk + 1, ci - ck + 1
    kw, buf, c0 = _fused_case(rng, m, x.shape[0], ro, co, *epi, scale=scale)
    d, e = torch.from_numpy(deltas), torch.from_numpy(entries)
    raw = tref.smm_conv_plain(_int8_of(x, scale, raw_features), d, e,
                              t_m=t_m, ro=ro, co=co)
    want = epilogue_plain(raw[:, :m], kw["x_scale"], kw["layer_scale"],
                          kw["bias"], kw["relu"])
    emu = _emulate_sm90(x, deltas, entries, t_m=t_m, ro=ro, co=co, epi=dict(
        x_scale=kw["x_scale"].numpy()[0], layer_scale=kw["layer_scale"],
        bias=None if kw["bias"] is None else kw["bias"].numpy(),
        relu=kw["relu"], m=m, buf=buf.numpy().copy(), c0=c0),
        quant=scale if raw_features else None)
    np.testing.assert_array_equal(emu[:, c0:c0 + m],
                                  want.permute(0, 3, 1, 2).numpy())
    assert _untouched(torch.from_numpy(emu), c0, m)
    got = tops.smm_conv_batched(torch.from_numpy(x), code,
                                operands=(d, e, meta),
                                raw_features=raw_features, **kw)
    assert got.shape == (x.shape[0], ro, co, m)
    assert torch.equal(got, want) and _untouched(buf, c0, m)
    if kw["out"] is not None:
        assert torch.equal(buf[:, c0:c0 + m], want.permute(0, 3, 1, 2))


@pytest.mark.parametrize("x_kind", X_KINDS)
@pytest.mark.parametrize("epi", EPILOGUES)
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_call_on_cpu_tensors_is_the_plain_epilogue(shape, stride, epi,
                                                         x_kind, rng):
    """``smm_conv_packed`` and ``smm_conv_batched`` with the epilogue's
    operands on CPU tensors: the plain version, then ``epilogue_plain``
    into the slice where there is one, and no launch counted; without
    them the raw sums as before.  Raw features (``raw_features`` of
    ``smm_conv_batched``): ``quantize_plain`` first, bit for bit."""
    m, n, rk, ck, ri, ci, t_m, t_n = shape
    code = tucr.encode_conv_layer(_sparse(rng, (m, n, rk, ck), 0.5),
                                  t_m=t_m, t_n=t_n)
    d, e, meta = tops.smm_operands_on(code, n, "cpu")
    xn, scale, raw_features = _features(
        rng, x_kind, rng.integers(-127, 128, size=(2, n, ri, ci)).astype(
            np.float32))
    x, q = torch.from_numpy(xn), _int8_of(xn, scale, raw_features)
    ro, co = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    raw = tops.smm_conv_packed(q, d, e, t_m=t_m, ro=ro, co=co, stride=stride)
    assert torch.equal(raw, tref.smm_conv_plain(q, d, e, t_m=t_m, ro=ro,
                                                co=co, stride=stride))
    before = (tops.launches, tops.launches_with_epilogue,
              tops.launches_with_quantize)
    for call in ("packed", "batched"):
        kw, buf, c0 = _fused_case(rng, m, 2, ro, co, *epi, scale=scale)
        want = epilogue_plain(raw[:, :m], kw["x_scale"], kw["layer_scale"],
                              kw["bias"], kw["relu"])
        if call == "packed":
            if kw["out"] is None:       # all m_tiles·t_m channels
                kw["bias"] = None if kw["bias"] is None else torch.cat(
                    [kw["bias"], torch.zeros(raw.shape[1] - m)])
                want = epilogue_plain(raw, kw["x_scale"], kw["layer_scale"],
                                      kw["bias"], kw["relu"])
            got = tops.smm_conv_packed(q, d, e, t_m=t_m, ro=ro, co=co,
                                       stride=stride, **kw)
        else:
            got = tops.smm_conv_batched(x, code, stride=stride,
                                        operands=(d, e, meta),
                                        raw_features=raw_features, **kw)
        assert torch.equal(got, want) and _untouched(buf, c0, m)
    assert (tops.launches, tops.launches_with_epilogue,
            tops.launches_with_quantize) == before


_BAD_EPILOGUES = [
    # (x_scale, bias, out, match): int8_features.epilogue's own messages
    (torch.ones(1, dtype=torch.float64), None, None, "x_scale must be"),
    (torch.ones(2), None, None, "x_scale must be"),
    (torch.ones(1, device="meta"), None, None, "x_scale is on meta"),
    (torch.ones(1), torch.ones(3), None, "bias must be"),
    (torch.ones(1), torch.ones(6, device="meta"), None, "bias is on meta"),
    (torch.ones(1), None, torch.zeros(2, 6, 5, 6), "out must be"),
    (torch.ones(1), None, torch.zeros(2, 6, 6, 6, dtype=torch.float64),
     "out must be"),
    (torch.ones(1), None, torch.zeros(2, 9, 6, 6), "out must be"),
    (None, torch.ones(6), None, "pass x_scale"),
    (None, None, torch.zeros(2, 6, 6, 6), "pass x_scale"),
    # raw features (ReLU for smm_conv_packed), and nothing else
    (None, None, None, "pass x_scale"),
]


@pytest.mark.parametrize("entry", ["batched", "packed", "cuda"])
@pytest.mark.parametrize("x_scale, bias, out, match", _BAD_EPILOGUES)
def test_fused_call_rejects_a_bad_epilogue(x_scale, bias, out, match, entry,
                                           rng):
    """Bad epilogue operands raise before anything runs, with
    ``int8_features.epilogue``'s messages (``smm_conv_cuda`` checks them
    before it looks at the device)."""
    code = tucr.encode_conv_layer(_sparse(rng, (6, 2, 3, 3), 0.5), t_m=4,
                                  t_n=2)
    d, e, meta = tops.smm_operands_on(code, 2, "cpu")
    x = torch.zeros(2, 2, 8, 8)
    kw = dict(x_scale=x_scale, bias=bias, out=out, relu=True)
    if all(t is None for t in (x_scale, bias, out)) and entry != "packed":
        kw.update(relu=False, raw_features=True)   # raw features alone
    with pytest.raises(ValueError, match=match):
        if entry == "batched":
            tops.smm_conv_batched(x, code, operands=(d, e, meta), **kw)
        else:
            call = tops.smm_conv_packed if entry == "packed" \
                else tops.smm_conv_cuda
            call(x, d, e, t_m=4, ro=6, co=6, **kw)


# VGG16 conv1_1..conv3_3 as the main path chains them (VALID, no pooling,
# from 226^2) and at their published input sizes
_VGG_MAIN_HW = (226, 224, 222, 220, 218, 216, 214)


def _vgg_calls(published: bool):
    from repro_torch.configs.paper_cnns import VGG16
    for s, hw in zip(VGG16[:7], _VGG_MAIN_HW):
        ri = s.ri if published else hw
        m_tiles = -(-s.m // 4)
        yield ((4, s.n, ri, ri), (m_tiles, s.n, 17),
               dict(t_m=4, ro=ri - 2, co=ri - 2, stride=1))


@pytest.mark.parametrize("published", [False, True])
def test_pick_impl_routes_vgg16_to_sm90(published):
    for x_shape, d_shape, kw in _vgg_calls(published):
        assert tops.pick_impl(x_shape, d_shape, int8_weights=True,
                              **kw) == "sm90", x_shape
        assert tops.sm90_refusal(x_shape, d_shape, int8_weights=True,
                                 **kw) is None
        # weights not known to fit int8 stay on simt
        assert tops.pick_impl(x_shape, d_shape, int8_weights=False,
                              **kw) == "simt"


def test_pick_impl_routes_googlenet_inception_to_sm90():
    """Every convolution of inception 3a-4b at batch 256 (1×1 at 28² and
    14² up to 512 channels in, 3×3 and 5×5 on their borders) takes sm90;
    3b's 5×5 at 96 channels out on one warpgroup of 64-row tiles, whose
    two-warpgroup stages would overflow shared memory."""
    from repro_torch.configs.paper_cnns import GOOGLENET_INCEPTION
    for name in ("3a", "3b", "4a", "4b"):
        hw, c_in, c1, c3r, c3, c5r, c5, pp = GOOGLENET_INCEPTION[name]
        for m, n, k in ((c1, c_in, 1), (c3r, c_in, 1), (c3, c3r, 3),
                        (c5r, c_in, 1), (c5, c5r, 5), (pp, c_in, 1)):
            ri = hw + k - 1
            args = ((256, n, ri, ri), (-(-m // 4), n, 17))
            kw = dict(t_m=4, ro=hw, co=hw)
            assert tops.sm90_refusal(*args, stride=1, int8_weights=True,
                                     **kw) is None, (name, m, n, k)
            plan = tops.sm90_plan(*args, **kw)
            assert plan["bm"] == (128 if m > 64 and (name, k) != ("3b", 5)
                                  else 64)


def test_pick_impl_routes_strided_layers_to_simt():
    from repro_torch.configs.paper_cnns import ALEXNET, GOOGLENET
    for s in (ALEXNET[0], GOOGLENET[0]):
        args = ((4, s.n, s.ri, s.ci), (-(-s.m // 4), s.n, 17))
        kw = dict(t_m=4, ro=s.ro, co=s.co, stride=s.stride,
                  int8_weights=True)
        assert s.stride > 1
        assert tops.pick_impl(*args, **kw) == "simt"
        assert "stride" in tops.sm90_refusal(*args, **kw)


def test_forcing_sm90_on_a_shape_it_does_not_take_raises(rng):
    w = _sparse(rng, (4, 2, 3, 3), 0.5)
    code = tucr.encode_conv_layer(w, t_m=4, t_n=2)
    deltas, entries, meta = tops.smm_operands_on(code, 2, "cpu")
    x = torch.zeros(1, 2, 9, 9)
    with pytest.raises(ValueError, match="stride 2"):
        tops.smm_conv_cuda(x, deltas, entries, t_m=4, ro=4, co=4, stride=2,
                           int8_weights=True, impl="sm90")
    with pytest.raises(ValueError, match="int8 weights"):
        tops.smm_conv_cuda(x, deltas, entries, t_m=4, ro=7, co=7,
                           impl="sm90")
    with pytest.raises(ValueError, match="impl must be"):
        tops.smm_conv_cuda(x, deltas, entries, t_m=4, ro=7, co=7,
                           impl="dense")
    # a window too wide for shared memory
    wide = (1, 2, 3, 40000)
    assert "shared memory" in tops.sm90_refusal(
        wide, deltas.shape, t_m=4, ro=1, co=39998, stride=1,
        int8_weights=True)


def test_pack_meta_int8_flag(rng):
    """``int8_weights`` holds for UCR codes and falls when a unique value
    leaves int8 or a vector names a position twice."""
    w = _sparse(rng, (8, 3, 3, 3), 0.6)
    code = tucr.encode_conv_layer(w, t_m=4, t_n=2)
    assert tops.pack_smm_operands(code, 3)[2]["int8_weights"] is True
    vi = next(i for i, u in enumerate(code.ucr) if len(u.indexes) > 1)
    big = tucr.UCRVector(code.ucr[vi].unique_vals.astype(np.int16) * 3,
                         code.ucr[vi].reps, code.ucr[vi].indexes,
                         code.ucr[vi].vector_len)
    big.unique_vals[-1] = 300
    ucrs = list(code.ucr)
    ucrs[vi] = big
    deltas, _, meta = tops.pack_smm_operands(
        tucr.LayerCode(code.vectors, ucrs, code.shape, code.scale, code.t_m,
                       code.t_n, code.params), 3)
    assert meta["int8_weights"] is False and deltas.sum() > 0
    u = code.ucr[vi]
    dup = tucr.UCRVector(u.unique_vals, u.reps,
                         np.full_like(u.indexes, u.indexes[0]), u.vector_len)
    ucrs[vi] = dup
    meta = tops.pack_smm_operands(
        tucr.LayerCode(code.vectors, ucrs, code.shape, code.scale, code.t_m,
                       code.t_n, code.params), 3)[2]
    assert meta["int8_weights"] is False


# -- on the card -----------------------------------------------------------

CUDA_CASES = [
    # (m, n, rk, ck, ri, ci, t_m, t_n, stride, batch)
    (10, 3, 3, 3, 13, 13, 4, 2, 1, 2),       # ragged tile, short plane
    (6, 2, 3, 3, 40, 70, 4, 2, 2, 3),        # several row/col tiles
    (8, 5, 2, 2, 23, 29, 2, 2, 3, 1),
    (96, 3, 11, 11, 227, 227, 4, 4, 4, 2),   # AlexNet conv1
    (64, 3, 7, 7, 229, 229, 4, 4, 2, 2),     # GoogLeNet conv1
    (64, 64, 3, 3, 66, 66, 4, 4, 1, 2),      # VGG16 conv1_2 widths
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_exact_vs_plain(case, cuda_device, rng):
    m, n, rk, ck, ri, ci, t_m, t_n, stride, b = case
    code = tucr.encode_conv_layer(_sparse(rng, (m, n, rk, ck), 0.4),
                                  t_m=t_m, t_n=t_n, n_unique=16)
    x = torch.from_numpy(rng.integers(-127, 128, size=(b, n, ri, ci)).astype(
        np.float32)).to(cuda_device)
    deltas, entries, meta = tops.smm_operands_on(code, n, cuda_device)
    ro, co = (ri - rk) // stride + 1, (ci - ck) // stride + 1
    before = tops.launches
    got = tops.smm_conv_cuda(x, deltas, entries, t_m=meta["t_m"], ro=ro,
                             co=co, stride=stride)
    torch.cuda.synchronize()
    assert tops.launches == before + 1
    want = tref.smm_conv_plain(x, deltas, entries, t_m=meta["t_m"], ro=ro,
                               co=co, stride=stride)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) == 0.0
    # and the NumPy lane, on the host
    lane = tsmm.conv2d_smm_batched(x.cpu().numpy().astype(np.int64), code,
                                   stride)
    np.testing.assert_array_equal(got[:, :m].cpu().numpy(),
                                  lane.astype(np.float32))


@pytest.mark.cuda
def test_cuda_kernel_rejects_bad_operands(cuda_device):
    x = torch.zeros(1, 2, 8, 8, device=cuda_device)
    deltas = torch.zeros(1, 2, 3, device=cuda_device)
    entries = torch.zeros(1, 2, 4, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        tops.smm_conv_cuda(x, deltas, entries.float(), t_m=4, ro=6, co=6)
    with pytest.raises(ValueError, match="contiguous"):
        tops.smm_conv_cuda(x.transpose(2, 3), deltas, entries, t_m=4, ro=6,
                           co=6)
    with pytest.raises(ValueError, match="geometry"):
        tops.smm_conv_cuda(x, deltas, entries, t_m=4, ro=9, co=6)


# stride-1 cases at VGG16's widths: N = 3 (padded to 32), n_in 64 / 128 /
# 256, M 64 / 128 / 256, a 214-pixel ragged edge, batch 1 and 4
SM90_CASES = [
    (64, 3, 3, 3, 226, 226, 4, 4, 1, 4),      # conv1_1 at its input size
    (128, 64, 3, 3, 66, 66, 4, 4, 1, 4),
    (256, 128, 3, 3, 30, 30, 4, 4, 1, 1),
    (256, 256, 3, 3, 216, 216, 4, 4, 1, 1),   # conv3_2 on the main path
    # GoogLeNet inception 3a-4b (their padded planes)
    (16, 192, 1, 1, 28, 28, 4, 4, 1, 2),      # 3a #5x5 reduce: M = 16
    (32, 16, 5, 5, 32, 32, 4, 4, 1, 2),       # 3a #5x5: half a chunk
    (96, 32, 5, 5, 32, 32, 4, 4, 1, 2),       # 3b #5x5: one warpgroup
    (224, 112, 3, 3, 16, 16, 4, 4, 1, 2),     # 4b #3x3
    (160, 512, 1, 1, 14, 14, 4, 4, 1, 2),     # 4b #1x1
]


def _cuda_layer(rng, case, device):
    m, n, rk, ck, ri, ci, t_m, t_n, stride, b = case
    code = tucr.encode_conv_layer(_sparse(rng, (m, n, rk, ck), 0.4),
                                  t_m=t_m, t_n=t_n, n_unique=16)
    x = torch.from_numpy(rng.integers(-128, 128, size=(b, n, ri, ci)).astype(
        np.float32)).to(device)
    deltas, entries, meta = tops.smm_operands_on(code, n, device)
    kw = dict(t_m=meta["t_m"], ro=(ri - rk) // stride + 1,
              co=(ci - ck) // stride + 1, stride=stride,
              int8_weights=meta["int8_weights"])
    return code, x, deltas, entries, kw


def _plain(x, deltas, entries, kw):
    return tref.smm_conv_plain(x, deltas, entries, t_m=kw["t_m"],
                               ro=kw["ro"], co=kw["co"], stride=kw["stride"])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", tops.IMPLS)
@pytest.mark.parametrize("case", CUDA_CASES + SM90_CASES)
def test_cuda_each_instance_exact_vs_plain(case, impl, cuda_device, rng):
    """Each instance, forced, on every case it takes: max-abs-diff 0
    against the plain version, the same bits on a second call, and one
    launch a call on its own count.  Forcing sm90 on a case it does not
    take raises."""
    _, x, deltas, entries, kw = _cuda_layer(rng, case, cuda_device)
    why = tops.sm90_refusal(tuple(x.shape), tuple(deltas.shape), **kw)
    if impl == "sm90" and why:
        with pytest.raises(ValueError, match="does not take"):
            tops.smm_conv_cuda(x, deltas, entries, impl=impl, **kw)
        assert case[8] > 1        # only the strided cases stay on simt
        return
    before = tops.launches_by_impl[impl]
    got = tops.smm_conv_cuda(x, deltas, entries, impl=impl, **kw)
    again = tops.smm_conv_cuda(x, deltas, entries, impl=impl, **kw)
    torch.cuda.synchronize()
    assert tops.launches_by_impl[impl] == before + 2
    want = _plain(x, deltas, entries, kw)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) == 0.0
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_launches_by_impl_follow_the_rule(cuda_device, rng):
    """Through ``smm_conv_batched`` (the engine's call), each layer runs
    on the instance ``pick_impl`` names, and only there."""
    for case in CUDA_CASES[:3] + SM90_CASES[1:3]:
        code, x, deltas, entries, kw = _cuda_layer(rng, case, cuda_device)
        want = tops.pick_impl(tuple(x.shape), tuple(deltas.shape), **kw)
        assert want == ("sm90" if case[8] == 1 else "simt")
        before = dict(tops.launches_by_impl)
        y = tops.smm_conv_batched(x, code, stride=kw["stride"],
                                  operands=tops.smm_operands_on(
                                      code, case[1], cuda_device))
        torch.cuda.synchronize()
        assert {i: tops.launches_by_impl[i] - before[i]
                for i in tops.IMPLS} == {i: int(i == want)
                                         for i in tops.IMPLS}
        assert float((y - _plain(x, deltas, entries, kw)[:, :case[0]])
                     .abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_sm90_scratch_reuse_on_one_stream(cuda_device, rng):
    """Two layers of different sizes back to back on one stream, with no
    sync between: each launch decodes its own weights into the shared
    scratch, after the one before has finished with it."""
    big = _cuda_layer(rng, (256, 128, 3, 3, 34, 34, 4, 4, 1, 2), cuda_device)
    small = _cuda_layer(rng, (64, 40, 3, 3, 20, 21, 4, 4, 1, 3), cuda_device)
    runs = [(lay, tops.smm_conv_cuda(*lay[1:4], impl="sm90", **lay[4]))
            for lay in (big, small, big, small)]
    torch.cuda.synchronize()
    for (_, x, deltas, entries, kw), got in runs:
        assert float((got - _plain(x, deltas, entries, kw)).abs().max()) == 0


@pytest.mark.cuda
def test_cuda_sm90_refuses_x_outside_int8(cuda_device):
    """x = 200 cannot be staged as int8: the launch stops (``__trap``)
    and the failure shows at the next sync, never as a wrong sum.  A
    trapped launch ends the process's CUDA context, so it runs apart."""
    code = "\n".join([
        "import numpy as np, torch",
        "from repro_torch.core import ucr",
        "from repro_torch.kernels.smm_conv import ops",
        "w = np.random.default_rng(0).normal(size=(8, 4, 3, 3))",
        "c = ucr.encode_conv_layer(w.astype(np.float32), t_m=4, t_n=2)",
        "d, e, meta = ops.smm_operands_on(c, 4, 'cuda')",
        "x = torch.zeros(1, 4, 10, 10, device='cuda')",
        "x[0, 1, 3, 4] = 200.0",
        "y = ops.smm_conv_cuda(x, d, e, t_m=4, ro=8, co=8,",
        "                      int8_weights=meta['int8_weights'],",
        "                      impl='sm90')",
        "print('launched', flush=True)",
        "torch.cuda.synchronize()",
        "print('no error', float(y.abs().max()), flush=True)",
    ])
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert "launched" in proc.stdout, proc.stderr
    assert "no error" not in proc.stdout
    assert proc.returncode != 0


# -- the layer's epilogue in the sm90 store, on the card --------------------

def _both_ways(layer, q, scale, *, bias, relu, width, c0):
    """``layer`` on int8 features ``q`` (its border included) written
    both ways into channels ``c0 ..`` of 7-filled NCHW buffers of
    ``width`` channels: ``smm_conv``'s raw sums then the ``int8_features``
    epilogue, and the fused call.  Returns ``(two_kernel, fused,
    launches)``, ``launches`` the fused call's counts: sm90, with the
    epilogue, separate epilogues."""
    m = layer.code.shape[0]
    b, _, ri, ci = q.shape
    ro, co = layer.out_hw(ri - 2 * layer.padding, ci - 2 * layer.padding)
    bufs = [torch.full((b, width, ro, co), 7.0, device=q.device)
            for _ in range(2)]
    y = tops.smm_conv_batched(q, layer.code, stride=layer.stride,
                              operands=layer.smm_operands())
    feats.epilogue(y, scale, layer.scale, bias, relu=relu,
                   out=bufs[0][:, c0:c0 + m])
    before = (tops.launches_by_impl["sm90"], tops.launches_with_epilogue,
              feats.launches_by_impl["epilogue"])
    got = tops.smm_conv_batched(q, layer.code, stride=layer.stride,
                                operands=layer.smm_operands(), x_scale=scale,
                                layer_scale=layer.scale, bias=bias, relu=relu,
                                out=bufs[1][:, c0:c0 + m])
    torch.cuda.synchronize()
    assert got.shape == (b, ro, co, m)
    assert got.data_ptr() == bufs[1][:, c0:c0 + m].data_ptr()
    after = (tops.launches_by_impl["sm90"], tops.launches_with_epilogue,
             feats.launches_by_impl["epilogue"])
    return bufs[0], bufs[1], tuple(a - c for a, c in zip(after, before))


@pytest.fixture(scope="module")
def vgg16_card():
    """VGG16 conv1_1..conv3_3 (published widths, density 0.4, U = 16) on
    ``smm_kernel`` on the card, encoded once for this file's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import repro_torch.api as codr
    from repro_torch.configs.paper_cnns import VGG16
    spec = codr.ModelSpec.from_shapes(VGG16[:7], None, density=0.4,
                                      rng=np.random.default_rng(7))
    return codr.compile(spec, codr.EncodeConfig(n_unique=16),
                        backend="smm_kernel", device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("index", range(7))
def test_cuda_fused_store_equals_smm_conv_then_epilogue_vgg16(index,
                                                             vgg16_card):
    """At each VGG16 layer (main-path plane, batch 2): the sm90 launch
    with the epilogue in its store is ``torch.equal`` to ``smm_conv``
    then the ``int8_features`` epilogue, with and without bias and ReLU,
    into a whole output and into a channel slice with its neighbours
    untouched; one sm90 launch, counted with the epilogue, and no
    separate epilogue."""
    layer = vgg16_card.model.layers[index]
    m, n = layer.code.shape[:2]
    hw = _VGG_MAIN_HW[index]
    g = torch.Generator(device="cuda").manual_seed(index)
    q = torch.randint(-127, 128, (2, n, hw, hw), device="cuda",
                      generator=g).float()
    scale = torch.tensor([0.0173], device="cuda")
    bias = torch.randn(m, device="cuda", generator=g) * 40
    for b, relu, (width, c0) in ((None, False, (m, 0)),
                                 (bias, True, (m, 0)),
                                 (bias, False, (m + 9, 5)),
                                 (None, True, (m + 3, 3))):
        two, fused, counts = _both_ways(layer, q, scale, bias=b, relu=relu,
                                        width=width, c0=c0)
        assert torch.equal(two, fused), (index, b is None, relu, c0)
        assert counts == (1, 1, 0)


def _counts():
    """sm90 launches, those with the epilogue and with phase 1b's
    quantization, and the ``int8_features`` quantize and epilogue
    launches, so far."""
    return (tops.launches_by_impl["sm90"], tops.launches_with_epilogue,
            tops.launches_with_quantize, feats.launches_by_impl["quantize"],
            feats.launches_by_impl["epilogue"])


def _since(before):
    return tuple(a - b for a, b in zip(_counts(), before))


def _by_kernels(layers, x):
    """``layers`` run one by one on their kernels, every layer's input
    quantized by ``int8_features`` first: features, ``smm_conv``,
    epilogue."""
    for layer in layers:
        q, s = feats.int8_features(x)
        x = feats.epilogue(
            tops.smm_conv_batched(q, layer.code,
                                  operands=layer.smm_operands()),
            s, layer.scale, None if layer.bias is None else layer.bias_device,
            relu=layer.activation == "relu")
    return x


@pytest.mark.cuda
def test_cuda_vgg16_forward_applies_every_epilogue_in_the_store(vgg16_card):
    """A forward of the seven layers: 7 sm90 launches, each counted with
    the epilogue, 6 of them quantizing their raw features in phase 1b (the
    first layer's input is NHWC-contiguous: ``quantize_nhwc``), no
    ``int8_features`` quantize or epilogue launch, and the output of the
    layers run one by one on two kernels (features, ``smm_conv``,
    epilogue).  In ``vgg16.b64``'s form, a model a block, each fed
    NHWC-contiguous: 4 of the 7 quantize in phase 1b."""
    from repro_torch.core.backends import get_backend
    from repro_torch.core.engine import CodrModel
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(2, 30, 30, 3)).astype(np.float32)).cuda()
    vgg16_card.run(x)                        # decode and pack once
    torch.cuda.synchronize()
    before = (dict(tops.launches_by_impl), _counts())
    y = vgg16_card.run(x)
    torch.cuda.synchronize()
    assert {i: tops.launches_by_impl[i] - before[0][i]
            for i in tops.IMPLS} == {"sm90": 7, "simt": 0}
    assert _since(before[1]) == (7, 7, 6, 0, 0)
    assert torch.equal(y, _by_kernels(vgg16_card.model.layers, x))
    layers = vgg16_card.model.layers
    blocks = [CodrModel(layers[:2]), CodrModel(layers[2:4]),
              CodrModel(layers[4:])]
    lane = get_backend("smm_kernel")
    h = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, size=(2, 44, 44, 3)).astype(np.float32)).cuda()
    before, ins, outs = _counts(), [], []
    for k, block in enumerate(blocks):
        if k:
            h = torch.nn.functional.max_pool2d(
                h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
        ins.append(h)
        h = lane.run_model(block, h)
        outs.append(h)
    torch.cuda.synchronize()
    assert _since(before) == (7, 7, 4, 0, 0)
    for block, h, got in zip(blocks, ins, outs):
        assert torch.equal(got, _by_kernels(block.layers, h))


# VGG16's in-block layers as vgg16.b64 runs them (conv1_2, conv2_2,
# conv3_2, conv3_3 of the one-model chain, at their input planes)
_VGG_IN_BLOCK = [(1, 226), (3, 114), (5, 60), (6, 58)]


def _raw_kinds(n, hw, gen):
    """``(kind, x, scale)``: raw NCHW features ``(2, n, hw, hw)`` of four
    kinds, each with its scale: a ReLU's output at the ``stats`` scale,
    whole numbers within ±127 at scale 1, half-way points (k + 0.5) / 8
    at scale 1/8, values past ±127 · s."""
    shape = (2, n, hw, hw)
    relu = torch.relu(torch.randn(shape, device="cuda", generator=gen)) * 30
    whole = torch.randint(-127, 128, shape, device="cuda",
                          generator=gen).float()
    half = (torch.randint(-127, 127, shape, device="cuda", generator=gen)
            + 0.5) * 0.125
    clamp = (torch.rand(shape, device="cuda", generator=gen) - 0.5) * 7
    return [("relu", relu, feats.feature_scale(relu.permute(0, 2, 3, 1))),
            ("whole", whole, torch.ones(1, device="cuda")),
            ("half", half, torch.full((1,), 0.125, device="cuda")),
            ("clamp", clamp, torch.full((1,), 0.0173, device="cuda"))]


def _raw_both_ways(layer, x, scale, out_two, out_one, **epi):
    """``layer`` on raw features ``x`` both ways, into ``out_two`` and
    ``out_one``: the ``int8_features`` quantize then ``smm_conv`` with the
    epilogue, and one launch that quantizes in phase 1b.  Returns the
    one-launch call's counts (:func:`_counts`)."""
    kw = dict(stride=layer.stride, operands=layer.smm_operands(),
              x_scale=scale, layer_scale=layer.scale, **epi)
    tops.smm_conv_batched(feats.quantize(x.permute(0, 2, 3, 1), scale),
                          layer.code, out=out_two, **kw)
    before = _counts()
    got = tops.smm_conv_batched(x, layer.code, out=out_one,
                                raw_features=True, **kw)
    torch.cuda.synchronize()
    assert got.data_ptr() == out_one.data_ptr()
    return _since(before)


def _identity_layer(n: int):
    """A 1×1 convolution whose int8 weights are 127 times the identity:
    each output value is one input value's int8 times 127, so a call's
    output shows every quantized value on its own."""
    code = tucr.encode_conv_layer(np.eye(n, dtype=np.float32)[:, :, None,
                                                              None],
                                  t_m=4, t_n=4)
    d, e, meta = tops.smm_operands_on(code, n, "cuda")
    assert meta["int8_weights"]
    return code, (d, e, meta)


def _near_midpoints(s: float, shape, gen) -> torch.Tensor:
    """Raw features that test a quantization at scale ``s``: the floats
    nearest (k + 0.5)·s and k·s and up to three ulps either side, for k in
    ±130 (past the clamp), and magnitudes from 2^-40·s to 2^40·s, signs
    mixed."""
    k = torch.randint(-130, 131, shape, device="cuda", generator=gen)
    half = torch.randint(0, 2, shape, device="cuda", generator=gen) * 0.5
    x = ((k + half).double() * s).float()
    for _ in range(3):
        step = torch.randint(-1, 2, shape, device="cuda", generator=gen)
        x = torch.where(step > 0, torch.nextafter(x, torch.full_like(
            x, float("inf"))), torch.where(step < 0, torch.nextafter(
                x, torch.full_like(x, -float("inf"))), x))
    wide = (torch.rand(shape, device="cuda", generator=gen) * 80 - 40).exp2()
    sign = torch.randint(0, 2, shape, device="cuda", generator=gen) * 2 - 1
    pick = torch.rand(shape, device="cuda", generator=gen) < 0.25
    return torch.where(pick, (wide * sign * s).float(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 0.0173, 0.125, 3.7e-19, 9.1e18,
                                   2.0 ** -70, 2.0 ** 70, "stats"])
def test_cuda_phase1b_quantize_is_the_quantize_pass_value_by_value(
        scale, cuda_device):
    """Phase 1b's quantization of raw features, one value at a time (a
    1×1 layer of 127 times the identity, so no sum mixes two values):
    ``torch.equal`` to the ``int8_features`` quantize (``__fdiv_rn``)
    then the same launch, over 8.4 M values near the half-way points
    (k + 0.5)·s and the whole multiples k·s, past the clamp and from
    2^-40·s to 2^40·s, at scales inside the reciprocal's range and past
    it (2^±70: the ``__fdiv_rn`` loop), and at the ``stats`` scale of a
    ReLU's output."""
    n = 32
    code, operands = _identity_layer(n)
    gen = torch.Generator(device="cuda").manual_seed(17)
    shape = (8, n, 128, 256)
    if scale == "stats":
        x = torch.relu(torch.randn(shape, device="cuda", generator=gen)) * 30
        s = feats.feature_scale(x.permute(0, 2, 3, 1))
    else:
        x = _near_midpoints(scale, shape, gen)
        s = torch.tensor([scale], dtype=torch.float32, device="cuda")
    kw = dict(operands=operands, x_scale=s, layer_scale=1.0)
    two = tops.smm_conv_batched(feats.quantize(x.permute(0, 2, 3, 1), s),
                                code, **kw)
    before = _counts()
    one = tops.smm_conv_batched(x, code, raw_features=True, **kw)
    torch.cuda.synchronize()
    assert _since(before) == (1, 1, 1, 0, 0)
    bad = (one != two).sum().item()
    assert bad == 0, (scale, bad, float((one - two).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("index, hw", _VGG_IN_BLOCK)
def test_cuda_phase1b_quantize_equals_quantize_then_smm_conv_vgg16(
        index, hw, vgg16_card):
    """At each VGG16 in-block layer (batch 2, its input plane in
    ``vgg16.b64``), on raw features of four kinds: the sm90 launch that
    quantizes them in phase 1b is ``torch.equal`` to the ``int8_features``
    quantize then ``smm_conv`` (whole numbers at scale 1, half-way points
    rounded to even, values past ±127·s clamped); one sm90 launch, with
    the epilogue and the quantization, no ``int8_features`` launch."""
    layer = vgg16_card.model.layers[index]
    m, n = layer.code.shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(index)
    bias = torch.randn(m, device="cuda", generator=gen) * 40
    for kind, x, scale in _raw_kinds(n, hw, gen):
        bufs = [torch.full((2, m, hw - 2, hw - 2), 7.0, device="cuda")
                for _ in range(2)]
        counts = _raw_both_ways(layer, x, scale, *bufs, bias=bias, relu=True)
        assert torch.equal(bufs[0], bufs[1]), (index, kind)
        assert counts == (1, 1, 1, 0, 0), kind


@pytest.mark.cuda
def test_cuda_simt_routed_layers_keep_the_separate_epilogue(cuda_device,
                                                            rng):
    """A strided layer, and one whose operands are not known to fit int8,
    go to simt, which has no fused store: ``smm_conv`` then the
    ``int8_features`` epilogue launch, the plain epilogue's numbers, into
    the slice; through the backend too.  On raw features the
    ``int8_features`` quantize launches first, as it would have before
    ``sm90`` took the quantization in."""
    import repro_torch.api as codr
    w = _sparse(rng, (10, 6, 3, 3), 0.5)
    b = rng.normal(size=10).astype(np.float32)
    x = torch.from_numpy(rng.integers(-127, 128, size=(2, 6, 17, 17))
                         .astype(np.float32)).to(cuda_device)
    scale = torch.tensor([0.0211], device=cuda_device)
    bias = torch.from_numpy(b).to(cuda_device)
    code = tucr.encode_conv_layer(w, t_m=4, t_n=2, n_unique=16)
    d, e, meta = tops.smm_operands_on(code, 6, cuda_device)
    for stride, flag in ((2, True), (1, False)):
        ro = (17 - 3) // stride + 1
        buf = torch.full((2, 14, ro, ro), 7.0, device=cuda_device)
        before = (dict(tops.launches_by_impl), tops.launches_with_epilogue,
                  feats.launches_by_impl["epilogue"])
        got = tops.smm_conv_batched(
            x, code, stride=stride, operands=(d, e, dict(
                meta, int8_weights=flag)), x_scale=scale, layer_scale=0.37,
            bias=bias, relu=True, out=buf[:, 3:13])
        torch.cuda.synchronize()
        assert tops.launches_by_impl["simt"] - before[0]["simt"] == 1
        assert tops.launches_by_impl["sm90"] == before[0]["sm90"]
        assert tops.launches_with_epilogue == before[1]
        assert feats.launches_by_impl["epilogue"] - before[2] == 1
        raw = tref.smm_conv_plain(x, d, e, t_m=4, ro=ro, co=ro,
                                  stride=stride)[:, :10]
        assert torch.equal(got, epilogue_plain(raw, scale, 0.37, bias, True))
        assert _untouched(buf.cpu(), 3, 10)
        before = _counts()
        again = tops.smm_conv_batched(
            x * 0.0211, code, stride=stride, operands=(d, e, dict(
                meta, int8_weights=flag)), x_scale=scale, layer_scale=0.37,
            bias=bias, relu=True, raw_features=True)
        torch.cuda.synchronize()
        assert _since(before) == (0, 0, 0, 1, 1)
        assert torch.equal(again, got)
    spec = codr.ModelSpec([codr.LayerSpec.conv(w, b, stride=2,
                                               activation="relu")])
    xin = x[:1].permute(0, 2, 3, 1).contiguous()
    card = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                        backend="smm_kernel", device=cuda_device)
    host = codr.compile(spec, codr.EncodeConfig(n_unique=16),
                        backend="smm_kernel", device="cpu")
    card.run(xin)
    before = (tops.launches_with_epilogue, feats.launches_by_impl["epilogue"])
    y = card.run(xin)
    torch.cuda.synchronize()
    assert (tops.launches_with_epilogue,
            feats.launches_by_impl["epilogue"] - 1) == before
    assert torch.equal(y.cpu(), host.run(xin.cpu()))
    # a layer's output as its input (NCHW storage): raw features, which
    # the simt-routed layer has quantized by the int8_features quantize
    from repro_torch.core.backends import get_backend
    lane, layer = get_backend("smm_kernel"), card.model.layers[0]
    xr = (xin * 0.3).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    before = _counts()
    y = lane.conv(layer, xr)
    torch.cuda.synchronize()
    assert _since(before) == (0, 0, 0, 1, 1)
    assert torch.equal(y.cpu(), get_backend("smm_kernel").conv(
        host.model.layers[0], xr.cpu()))


@pytest.mark.cuda
def test_cuda_fused_store_refuses_a_slice_without_whole_planes(cuda_device,
                                                              rng):
    """The fused store writes whole channel planes: an ``out`` cut inside
    the plane raises as the ``int8_features`` epilogue does."""
    code = tucr.encode_conv_layer(_sparse(rng, (8, 4, 3, 3), 0.5), t_m=4,
                                  t_n=2)
    d, e, meta = tops.smm_operands_on(code, 4, cuda_device)
    x = torch.zeros(2, 4, 10, 10, device=cuda_device)
    buf = torch.zeros(2, 12, 8, 9, device=cuda_device)
    with pytest.raises(ValueError, match="whole channel planes"):
        tops.smm_conv_batched(x, code, operands=(d, e, meta),
                              x_scale=torch.ones(1, device=cuda_device),
                              out=buf[:, 2:10, :, :8])
