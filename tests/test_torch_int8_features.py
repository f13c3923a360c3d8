"""The ``smm_kernel`` lane's 8-bit feature path and epilogue
(``repro_torch.kernels.int8_features``): the plain versions against the
JAX reference's ``_int_activations`` and the port's ``_finish``, the
wrapper's checks and its CPU route and, on a card, the CUDA kernels bit
for bit against the plain versions.

The reference package is imported inside the tests, so the ``cuda``
tests also run where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_int8_features.py
"""
import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro_torch.api as codr
from repro_torch.core import backends, spans
from repro_torch.kernels.int8_features import ops, ref


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(kind: str, shape, seed: int = 0) -> np.ndarray:
    """NHWC float32 test features of one kind."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.normal(size=shape) * 3).astype(np.float32)
    if kind == "whole_int8":
        return rng.integers(-127, 128, size=shape).astype(np.float32)
    if kind == "whole_pixels":          # whole, but beyond ±127
        return rng.integers(0, 256, size=shape).astype(np.float32)
    if kind == "relu_out":              # half zeros, the rest fractional
        return np.maximum(rng.normal(size=shape) * 50, 0).astype(np.float32)
    assert kind == "zero"
    return np.zeros(shape, np.float32)


KINDS = ("random", "whole_int8", "whole_pixels", "relu_out", "zero")
SHAPES = [(2, 5, 7, 3), (1, 4, 4, 64), (3, 6, 5, 33)]
# the card tests' shapes: the CPU test of the plain version against the
# reference takes them too, on the same inputs
CUDA_SHAPES = [
    (2, 5, 7, 3),          # 210 elements: no whole float4 tail
    (3, 9, 11, 64),
    (2, 13, 17, 33),       # a ragged channel tile
    (1, 1, 1, 1),
    (16, 114, 114, 64),    # past the stats grid's cap
]


def _nchw_storage(x: torch.Tensor) -> torch.Tensor:
    """``x`` (NHWC) as an NHWC view of NCHW storage: what a layer's
    output looks like inside a block."""
    return x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)


# -- the plain versions, on the CPU ------------------------------------------

@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("shape", SHAPES + CUDA_SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_features_equal_the_jax_reference(kind, shape, nchw):
    """``int8_features_plain`` gives the reference's integers and its
    scale (correctly rounded amax / 127) in either storage of x; at
    ``CUDA_SHAPES`` on the inputs the card test hands the kernels, which
    it holds to the plain version (the reference does not run on the
    card)."""
    pytest.importorskip("jax")
    from repro.core.backends import _int_activations as jax_int_activations
    xn = _inputs(kind, shape, seed=sum(shape))
    want_q, want_s = jax_int_activations(xn)
    x = torch.from_numpy(xn)
    q, s = ref.int8_features_plain(_nchw_storage(x) if nchw else x)
    assert q.is_contiguous() and q.shape == (shape[0], shape[3], *shape[1:3])
    assert s.shape == (1,) and s.dtype == torch.float32
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(),
                                  want_q.astype(np.float32))
    assert s.item() == np.float32(want_s)
    if kind in ("whole_int8", "zero"):
        assert s.item() == 1.0 and torch.equal(q.permute(0, 2, 3, 1), x)


@pytest.mark.parametrize("kind", KINDS)
def test_host_path_features_equal_the_plain_version(kind):
    """The host path (``backends._int_activations``) and the plain version
    agree on the features and the scale."""
    x = torch.from_numpy(_inputs(kind, (2, 6, 6, 5)))
    xi, s = backends._int_activations(x)
    q, qs = ref.int8_features_plain(x)
    assert torch.equal(xi.permute(0, 3, 1, 2), q) and s == qs.item()


def _layer(m: int, bias: bool, relu: bool, scale: float = 0.0123):
    rng = np.random.default_rng(5)
    b = rng.normal(size=m).astype(np.float32) if bias else None
    return types.SimpleNamespace(
        bias=b, bias_device=None if b is None else torch.from_numpy(b),
        activation="relu" if relu else None,
        code=types.SimpleNamespace(scale=np.float32(scale)))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_plain_epilogue_equals_finish(bias, relu):
    """``epilogue_plain`` is the parent chain's ``_finish(layer,
    y.permute(0, 2, 3, 1) * scale)``, the scale's product in double."""
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.integers(-5000, 5000, size=(2, 7, 5, 6))
                         .astype(np.float32))
    layer = _layer(7, bias, relu)
    x_scale = torch.tensor([0.7431], dtype=torch.float32)
    want = backends._finish(layer, y.permute(0, 2, 3, 1) * (
        float(np.asarray(layer.code.scale)) * x_scale.item()))
    got = ref.epilogue_plain(y, x_scale, float(layer.code.scale),
                             layer.bias_device, relu)
    assert torch.equal(got, want)
    assert got.permute(0, 3, 1, 2).is_contiguous()


@pytest.mark.parametrize("pad", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_padded_features_are_the_features_on_a_zero_border(kind, pad):
    """``quantize_plain`` with a border: the unpadded features, zero
    around them, at the unpadded tensor's scale."""
    x = torch.from_numpy(_inputs(kind, (2, 5, 7, 3), seed=pad))
    q, s = ref.int8_features_plain(x)
    qp = ref.quantize_plain(x, s, pad)
    assert qp.is_contiguous() and qp.shape == (2, 3, 5 + 2 * pad, 7 + 2 * pad)
    assert torch.equal(qp, torch.nn.functional.pad(q, (pad,) * 4))
    assert torch.equal(ops.quantize(x, s, pad), qp)


def test_epilogue_into_a_channel_slice_on_cpu():
    """``out``: the result lands in a channel slice of a larger NCHW
    buffer, the rest of it untouched, equal to the plain epilogue."""
    y = torch.randn(2, 6, 3, 4) * 1000
    layer = _layer(5, True, True)
    s = torch.tensor([0.25])
    buf = torch.full((2, 9, 3, 4), 7.0)
    got = ops.epilogue(y[:, :5], s, 0.5, layer.bias_device, relu=True,
                       out=buf[:, 2:7])
    want = ref.epilogue_plain(y[:, :5], s, 0.5, layer.bias_device, True)
    assert torch.equal(got, want) and torch.equal(buf[:, 2:7],
                                                  want.permute(0, 3, 1, 2))
    assert (buf[:, :2] == 7).all() and (buf[:, 7:] == 7).all()
    with pytest.raises(ValueError, match="out must be"):
        ops.epilogue(y, s, 0.5, out=buf[:, :5])


@pytest.mark.parametrize("args", [(3, 1, 1, False), (3, 2, 0, True),
                                  (2, 2, 0, False)])
@pytest.mark.parametrize("kind", KINDS + ("nan",))
def test_pooled_raw_features_quantize_to_the_pooled_int8_features(kind,
                                                                  args):
    """A pool branch on raw features (``smm_kernel``'s where a module's
    input is a layer's output): max pooling, then quantizing at the
    features' scale, equals quantizing, then pooling -- max and the
    quantization are both monotone under one positive scale, and both
    keep a NaN -- in the plain versions and through the wrappers."""
    xn = _inputs("random" if kind == "nan" else kind, (2, 9, 9, 5),
                 seed=len(args) + args[1])
    if kind == "nan":
        xn[0, 1, 2, 0] = np.nan
    x = torch.from_numpy(xn)
    s = ref.feature_scale_plain(x)
    raw = x.permute(0, 3, 1, 2)
    want = ref.max_pool_plain(ref.quantize_plain(x, s), *args)
    for pool, quantize in ((ref.max_pool_plain, ref.quantize_plain),
                           (ops.max_pool, ops.quantize)):
        got = quantize(pool(raw, *args).permute(0, 2, 3, 1), s)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_max_pool_on_cpu_tensors_runs_the_plain_version():
    x = torch.from_numpy(_inputs("relu_out", (2, 9, 9, 5))).permute(
        0, 3, 1, 2)
    before = (ops.launches, dict(ops.launches_by_impl))
    for args in ((3, 1, 1, False), (3, 2, 0, True), (2, 2, 0, False)):
        got = ops.max_pool(x, *args)
        assert torch.equal(got, ref.max_pool_plain(x, *args))
        assert got.is_contiguous()
    assert (ops.launches, ops.launches_by_impl) == before
    with pytest.raises(ValueError, match="at most half"):
        ops.max_pool(x, 3, 1, 2)
    with pytest.raises(ValueError, match="float32"):
        ops.max_pool(x.double(), 3, 1, 1)


# -- the wrapper's checks and its CPU route ----------------------------------

def test_wrapper_on_cpu_tensors_runs_the_plain_version():
    x = torch.from_numpy(_inputs("random", (2, 5, 5, 4)))
    before = (ops.launches, dict(ops.launches_by_impl))
    q, s = ops.int8_features(x)
    pq, ps = ref.int8_features_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    y = torch.randn(2, 6, 3, 3)
    layer = _layer(6, True, True)
    assert torch.equal(ops.epilogue(y, s, 0.5, layer.bias_device, relu=True),
                       ref.epilogue_plain(y, s, 0.5, layer.bias_device, True))
    assert (ops.launches, ops.launches_by_impl) == before


@pytest.mark.parametrize("bad, match", [
    (torch.zeros(2, 3, 3, 4, dtype=torch.float64), "float32"),
    (torch.zeros(2, 3, 4), "4-D"),
    (torch.zeros(0, 3, 3, 4), "empty"),
    (torch.zeros(2, 3, 3, 4, device="meta"), "CPU or CUDA"),
])
@pytest.mark.parametrize("entry", ["int8_features", "feature_scale",
                                   "quantize"])
def test_wrapper_rejects_bad_features(entry, bad, match):
    call = {"int8_features": ops.int8_features,
            "feature_scale": ops.feature_scale,
            "quantize": lambda x: ops.quantize(x, torch.ones(1,
                                                             device=x.device))
            }[entry]
    with pytest.raises(ValueError, match=match):
        call(bad)


@pytest.mark.parametrize("scale", [torch.ones(1, dtype=torch.float64),
                                   torch.ones(2), torch.ones(()),
                                   torch.ones(1, device="meta")])
def test_quantize_rejects_a_bad_scale(scale):
    with pytest.raises(ValueError, match="scale must be one float32"):
        ops.quantize(torch.zeros(2, 3, 3, 4), scale)


@pytest.mark.parametrize("y, x_scale, bias, match", [
    (torch.zeros(2, 4, 3, 3, dtype=torch.float64), torch.ones(1), None,
     "float32"),
    (torch.zeros(4, 3, 3), torch.ones(1), None, "4-D"),
    (torch.zeros(2, 4, 3, 3), torch.ones(1, dtype=torch.float64), None,
     "x_scale must be"),
    (torch.zeros(2, 4, 3, 3), torch.ones(2), None, "x_scale must be"),
    (torch.zeros(2, 4, 3, 3), torch.ones(1, device="meta"), None,
     "x_scale is on meta"),
    (torch.zeros(2, 4, 3, 3), torch.ones(1), torch.ones(3), "bias must be"),
    (torch.zeros(2, 4, 3, 3), torch.ones(1), torch.ones(4, device="meta"),
     "bias is on meta"),
    (torch.zeros(2, 4, 3, 3, device="meta"), torch.ones(1, device="meta"),
     None, "CPU or CUDA"),
])
def test_wrapper_rejects_a_bad_epilogue(y, x_scale, bias, match):
    with pytest.raises(ValueError, match=match):
        ops.epilogue(y, x_scale, 0.5, bias)


def _conv(rng, m, n, k, **kw):
    w = rng.normal(size=(m, n, k, k)).astype(np.float32)
    w[rng.random(w.shape) > 0.5] = 0
    return codr.LayerSpec.conv(w, rng.normal(size=m).astype(np.float32),
                               activation="relu", **kw)


def _module(rng, name: str, c_in: int):
    """An inception module of 40 channels out: a 1×1, a 3×3 and a 5×5 on
    their borders after their reduces, a pooling branch."""
    c = [_conv(rng, m, n, k, padding=k // 2, name=f"{name}.{i}")
         for i, (m, n, k) in enumerate(((8, c_in, 1), (8, c_in, 1),
                                        (16, 8, 3), (4, c_in, 1), (8, 4, 5),
                                        (8, c_in, 1)))]
    return codr.ModuleSpec(([c[0]], [c[1], c[2]], [c[3], c[4]],
                            [codr.PoolSpec(3, 1, 1), c[5]]), name=name)


# which of a module's six convolutions take its input's features: raw
# features where the input is a layer's output (NCHW storage)
_SHARED = [True, True, False, True, False, True]


def _cpu_net(net: str):
    """``(spec, x, pads, raws, pools, slices)``: a VGG-like chain (VALID,
    a padded 3×3, a pooling between layers), an inception module, or two
    modules with the 3×3/2 pooling between them (the second on raw
    features: its input is NCHW storage), with the pads its
    ``int8_features`` calls take, which convolutions take raw features,
    the poolings and the channel offsets of the branches' slices."""
    rng = np.random.default_rng(3)
    if net == "chain":
        steps = [_conv(rng, 4, 3, 3, name="c0"),
                 _conv(rng, 8, 4, 3, padding=1, name="c1"),
                 codr.PoolSpec(2, 2), _conv(rng, 8, 8, 3, name="c2")]
        x = _inputs("whole_pixels", (2, 12, 12, 3))
        return codr.ModelSpec(steps), x, [0, 1], [False, False, True], 1, []
    x = _inputs("relu_out", (2, 10, 10, 24))
    if net == "module":
        return codr.ModelSpec([_module(rng, "3a", 24)]), x, [0, 1, 2], \
            [False] * 6, 1, [0, 8, 24, 32]
    spec = codr.ModelSpec([_module(rng, "3a", 24),
                           codr.PoolSpec(3, 2, ceil_mode=True),
                           _module(rng, "3b", 40)])
    return spec, x, [0, 1, 2, 1, 2], [False] * 6 + _SHARED, 3, \
        [0, 8, 24, 32] * 2


@pytest.mark.parametrize("net", ["chain", "module", "modules"])
def test_smm_kernel_on_cpu_tensors_runs_the_kernel_wrappers(net,
                                                            monkeypatch):
    """CPU tensors on ``smm_kernel`` take the card's path: the
    ``int8_features`` wrapper for the features (``stats`` alone where a
    layer's input is a layer's output with no border: raw features, which
    ``smm_conv_batched`` quantizes) and the poolings (a pool branch's of
    raw features too), ``smm_conv_batched`` with the layer's epilogue (a
    branch's last layer into its channel slice of the module's output),
    no host read; the wrappers run their plain versions, and the output
    is ``smm``'s exactly."""
    from repro_torch.kernels.smm_conv import ops as smm_ops
    spec, x, pads, raws, pools, slices = _cpu_net(net)
    cfg = codr.EncodeConfig(n_unique=16)
    want = codr.compile(spec, cfg, backend="smm", device="cpu").run(x)
    model = codr.compile(spec, cfg, backend="smm_kernel", device="cpu")
    calls = {"int8_features": [], "max_pool": [], "smm_conv_batched": []}

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*a, **k):
            calls[name].append((a, k))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, call)
    spy(ops, "int8_features")
    spy(ops, "max_pool")
    spy(smm_ops, "smm_conv_batched")

    def refuse(*a, **k):
        raise AssertionError("smm_kernel read the host path")
    monkeypatch.setattr(backends, "_int_activations", refuse)
    before = (ops.launches, smm_ops.launches)
    got = model.run(x)
    assert torch.equal(got, want)
    assert (ops.launches, smm_ops.launches) == before
    assert [a[1] for a, _ in calls["int8_features"]] == pads
    assert len(calls["max_pool"]) == pools
    convs = [(a[0], k) for a, k in calls["smm_conv_batched"]]
    assert len(convs) == len(spec.layers)
    assert all(k["x_scale"].shape == (1,) and k["relu"] for _, k in convs)
    assert [k["raw_features"] for _, k in convs] == raws
    # raw features are a layer's own output, never quantized: fractional
    assert all(not torch.equal(q, torch.round(q))
               for q, k in convs if k["raw_features"])
    outs = [k["out"] for _, k in convs if k["out"] is not None]
    assert [o.storage_offset() // (o.shape[2] * o.shape[3])
            for o in outs] == slices
    assert all(o.untyped_storage().data_ptr()
               == got.untyped_storage().data_ptr() for o in outs[-4:])


# -- on the card -------------------------------------------------------------

def _both(q, s, want_q, want_s):
    assert q.shape == want_q.shape and q.is_contiguous()
    assert torch.equal(q, want_q), float((q - want_q).abs().max())
    assert torch.equal(s, want_s), (s.item(), want_s.item())


@pytest.mark.cuda
@pytest.mark.parametrize("nchw", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_features_equal_the_plain_version(shape, kind, nchw,
                                               cuda_device):
    """stats + quantize, in either storage of x, equal the plain version
    bit for bit, on the card and on the host; scale 1 and q == x for whole
    numbers within ±127 and for zeros.  The plain version equals the JAX
    reference on these very inputs in
    ``test_plain_features_equal_the_jax_reference`` (on the CPU)."""
    xc = torch.from_numpy(_inputs(kind, shape, seed=sum(shape)))
    x = xc.to(cuda_device)
    x = _nchw_storage(x) if nchw else x
    before = dict(ops.launches_by_impl)
    q, s = ops.int8_features(x)
    torch.cuda.synchronize()
    quant = "quantize" if nchw or shape[3] == 1 else "quantize_nhwc"
    assert {k: ops.launches_by_impl[k] - before[k] for k in ops.IMPLS} == \
        {k: int(k in ("stats", quant)) for k in ops.IMPLS}
    _both(q, s, *ref.int8_features_plain(x))
    pq, ps = ref.int8_features_plain(xc)
    _both(q.cpu(), s.cpu(), pq, ps)
    if kind in ("whole_int8", "zero"):
        assert s.item() == 1.0
        assert torch.equal(q.permute(0, 2, 3, 1).cpu(), xc)


@pytest.mark.cuda
def test_cuda_features_of_an_unaligned_view(cuda_device):
    """x one float past a 16-byte boundary: the scalar paths."""
    xn = _inputs("random", (2, 6, 7, 4))
    buf = torch.zeros(xn.size + 1, device=cuda_device)
    buf[1:] = torch.from_numpy(xn.ravel()).to(cuda_device)
    x = buf[1:].view(xn.shape)
    q, s = ops.int8_features(x)
    _both(q, s, *ref.int8_features_plain(x))
    x2 = buf[1:].view(2, 4, 6, 7).permute(0, 2, 3, 1)
    _both(*ops.int8_features(x2), *ref.int8_features_plain(x2))


@pytest.mark.cuda
def test_cuda_stats_left_ready_across_calls_without_a_sync(cuda_device):
    """Back-to-back calls on one stream, no sync between: each launch
    leaves the stream's accumulator zero for the next, so a large amax
    does not leak into a small one, nor a fractional input into a whole
    one."""
    xs = [torch.from_numpy(_inputs(kind, shape, seed=i)).to(cuda_device)
          for i, (kind, shape) in enumerate([
              ("random", (8, 33, 33, 64)), ("whole_int8", (2, 9, 9, 3)),
              ("relu_out", (4, 17, 17, 32)), ("zero", (1, 3, 3, 5)),
              ("whole_pixels", (3, 8, 8, 3))])]
    xs[0] = xs[0] * 100
    got = [ops.int8_features(x) for x in xs + xs[::-1]]
    torch.cuda.synchronize()
    for x, (q, s) in zip(xs + xs[::-1], got):
        _both(q, s, *ref.int8_features_plain(x))


def _padded_y(rng, b, m, m_pad, ro, co, device):
    full = torch.from_numpy(rng.integers(-20000, 20000, size=(
        b, m_pad, ro, co)).astype(np.float32)).to(device)
    return full[:, :m]


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("b, m, m_pad, ro, co", [
    (2, 7, 8, 5, 6),        # a padded channel axis
    (3, 16, 16, 7, 7),      # 49 pixels: no float4 rows
    (1, 5, 8, 4, 4),        # one image, padded
    (4, 64, 64, 56, 56),
])
def test_cuda_epilogue_equals_finish(b, m, m_pad, ro, co, bias, relu,
                                     cuda_device):
    """The epilogue on smm_conv's (padded) NCHW output equals
    ``_finish(layer, y.permute(0, 2, 3, 1) * scale)`` bit for bit, in the
    same NCHW storage behind the NHWC view."""
    rng = np.random.default_rng(b * m + ro)
    y = _padded_y(rng, b, m, m_pad, ro, co, cuda_device)
    layer = _layer(m, bias, relu, scale=0.0371)
    if bias:
        layer.bias_device = layer.bias_device.to(cuda_device)
    x_scale = torch.tensor([1.8930412], device=cuda_device)
    before = ops.launches_by_impl["epilogue"]
    got = ops.epilogue(y, x_scale, float(layer.code.scale),
                       layer.bias_device, relu=relu)
    torch.cuda.synchronize()
    assert ops.launches_by_impl["epilogue"] == before + 1
    want = backends._finish(layer, y.permute(0, 2, 3, 1) * (
        float(np.asarray(layer.code.scale)) * x_scale.item()))
    assert got.shape == want.shape == (b, ro, co, m)
    assert got.permute(0, 3, 1, 2).is_contiguous()
    assert torch.equal(got, want)
    assert torch.equal(got, ref.epilogue_plain(y, x_scale,
                                               float(layer.code.scale),
                                               layer.bias_device, relu))


def _vgg_like(device: str, hw: int = 20):
    """Two blocks of VGG16's first widths at a small plane, on
    ``smm_kernel``: conv 3→64→64, then 64→128→128."""
    rng = np.random.default_rng(3)
    def conv(m, n, name):
        w = rng.normal(size=(m, n, 3, 3)).astype(np.float32) * 0.5
        w[rng.random(w.shape) > 0.4] = 0
        return codr.LayerSpec.conv(w, activation="relu", name=name)
    blocks = [[conv(64, 3, "c0"), conv(64, 64, "c1")],
              [conv(128, 64, "c2"), conv(128, 128, "c3")]]
    return [codr.compile(codr.ModelSpec(b), codr.EncodeConfig(n_unique=16),
                         backend="smm_kernel", device=device)
            for b in blocks]


@pytest.mark.cuda
def test_cuda_vgg_like_chain_reads_nothing_and_equals_the_reference(
        cuda_device):
    """A small VGG16-shaped chain on ``smm_kernel``: ``stats`` a layer,
    ``quantize_nhwc`` at a block's first layer and no other quantize
    launch (a block's later layers hand ``smm_conv`` their raw features,
    which ``sm90`` quantizes in its phase 1b), ``smm_conv`` with the
    epilogue in its store, no ``codr.host_read`` span under a profiler,
    and the output of every block equal to the host lane (``smm``:
    ``_int_activations``, NumPy SMM, ``_finish``) and to the plain
    chain."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.smm_conv import ops as smm_ops
    from repro_torch.kernels.smm_conv import ref as smm_ref
    models = _vgg_like("cuda")
    x0 = torch.from_numpy(_inputs("whole_pixels", (4, 24, 24, 3))).to(
        cuda_device)

    def chain(run):
        outs, x = [], x0
        for k, model in enumerate(models):
            if k:
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(
                    0, 2, 3, 1).contiguous()
            x = run(model, x)
            outs.append(x)
        return outs

    chain(lambda mdl, x: mdl.run(x))             # builds and packs first
    torch.cuda.synchronize()
    before = dict(ops.launches_by_impl)
    with_epilogue = smm_ops.launches_with_epilogue
    with_quantize = smm_ops.launches_with_quantize
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = chain(lambda mdl, x: mdl.run(x))
        torch.cuda.synchronize()
    recorded = [s.name for s in spans.spans()]
    spans.clear()
    assert recorded.count("codr.features") == 4
    assert "codr.host_read" not in recorded
    assert {k: ops.launches_by_impl[k] - before[k] for k in ops.IMPLS} == \
        {"stats": 4, "quantize": 0, "quantize_nhwc": 2, "quantize_pad": 0,
         "max_pool": 0, "epilogue": 0}
    assert smm_ops.launches_with_epilogue - with_epilogue == 4
    assert smm_ops.launches_with_quantize - with_quantize == 2
    host = chain(lambda mdl, x: mdl.run(x, backend="smm"))

    def plain(mdl, x):
        for layer in mdl.model.layers:
            q, s = ref.int8_features_plain(x)
            d, e, meta = layer.smm_operands()
            ro, co = layer.out_hw(*x.shape[1:3])
            y = smm_ref.smm_conv_plain(q, d, e, t_m=meta["t_m"], ro=ro,
                                       co=co)[:, :layer.code.shape[0]]
            x = ref.epilogue_plain(y, s, layer.scale, None, True)
        return x
    for g, h, p in zip(got, host, chain(plain)):
        assert torch.equal(g, h) and torch.equal(g, p)


@pytest.mark.cuda
def test_cuda_a_nan_input_still_fails_loudly(cuda_device):
    """A NaN feature keeps the scale at 1 and reaches ``smm_conv`` as NaN,
    whose sm90 instance stops the launch (``__trap``): the failure shows
    at the next sync, never as a number.  A trapped launch ends the
    process's CUDA context, so it runs apart."""
    code = "\n".join([
        "import numpy as np, torch",
        "import repro_torch.api as codr",
        "w = np.random.default_rng(0).normal(size=(8, 4, 3, 3))",
        "spec = codr.ModelSpec([codr.LayerSpec.conv(w.astype(np.float32),",
        "                                           activation='relu')])",
        "m = codr.compile(spec, codr.EncodeConfig(n_unique=16),",
        "                 backend='smm_kernel', device='cuda')",
        "x = torch.rand(2, 10, 10, 4, device='cuda')",
        "m.run(x); torch.cuda.synchronize()",
        "x[1, 3, 4, 2] = float('nan')",
        "y = m.run(x)",
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


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["nhwc", "nchw"])
@pytest.mark.parametrize("value", ["inf", "-inf", "nan"])
def test_cuda_an_infinite_or_nan_feature_fails_loudly(value, storage,
                                                      cuda_device):
    """An infinite feature makes the scale infinite, and inf / inf is NaN;
    a NaN keeps the scale at 1 and stays NaN: either way ``smm_conv``'s
    sm90 instance stops the launch (``__trap``), whether the features
    were quantized first (NHWC-contiguous input: ``quantize_nhwc``) or
    reach it raw (NCHW storage: quantized in its phase 1b, counted in
    ``launches_with_quantize``).  A trapped launch ends the process's CUDA
    context, so it runs apart."""
    code = "\n".join([
        "import numpy as np, torch",
        "import repro_torch.api as codr",
        "from repro_torch.kernels.smm_conv import ops",
        "w = np.random.default_rng(0).normal(size=(8, 4, 3, 3))",
        "spec = codr.ModelSpec([codr.LayerSpec.conv(w.astype(np.float32),",
        "                                           activation='relu')])",
        "m = codr.compile(spec, codr.EncodeConfig(n_unique=16),",
        "                 backend='smm_kernel', device='cuda')",
        "x = torch.rand(2, 10, 10, 4, device='cuda')",
        f"if {storage == 'nchw'}:",
        "    x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)",
        "m.run(x); torch.cuda.synchronize()",
        "n = ops.launches_with_quantize",
        f"x[1, 3, 4, 2] = float('{value}')",
        "y = m.run(x)",
        "print('launched', ops.launches_with_quantize - n, flush=True)",
        "torch.cuda.synchronize()",
        "print('no error', float(y.abs().max()), flush=True)",
    ])
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert f"launched {int(storage == 'nchw')}" in proc.stdout, proc.stderr
    assert "no error" not in proc.stdout
    assert proc.returncode != 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape, pad", [
    ((2, 5, 7, 3), 1),
    ((4, 28, 28, 96), 1),   # inception 3a's #3x3 reduce output
    ((2, 28, 28, 16), 2),   # 3a's #5x5 reduce output
    ((3, 14, 14, 24), 2),   # 4b's
    ((1, 1, 1, 1), 2),
    ((2, 40, 300, 3), 1),   # rows wider than a block
])
def test_cuda_padded_features_equal_the_plain_version(shape, pad, kind,
                                                      cuda_device):
    """``quantize_pad`` from NCHW storage (an epilogue's output) and from
    NHWC-contiguous x (copied first): the plain version's features on its
    zero border, bit for bit, one ``quantize_pad`` launch."""
    xc = torch.from_numpy(_inputs(kind, shape, seed=sum(shape)))
    for x in (_nchw_storage(xc.to(cuda_device)), xc.to(cuda_device)):
        before = dict(ops.launches_by_impl)
        q, s = ops.int8_features(x, pad)
        torch.cuda.synchronize()
        assert {k: ops.launches_by_impl[k] - before[k] for k in ops.IMPLS} \
            == {k: int(k in ("stats", "quantize_pad")) for k in ops.IMPLS}
        _both(q.cpu(), s.cpu(), *ref.int8_features_plain(xc, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("b, m, m_pad, m_out, c0, ro, co", [
    (2, 7, 8, 20, 5, 5, 6),          # no float4 rows
    (4, 64, 64, 256, 0, 28, 28),     # 3a's #1x1 slice
    (4, 32, 32, 256, 224, 28, 28),   # 3a's pool proj, the last slice
    (3, 48, 48, 512, 400, 14, 14),   # 4a's #5x5
])
def test_cuda_epilogue_into_a_channel_slice(b, m, m_pad, m_out, c0, ro, co,
                                            relu, cuda_device):
    """The epilogue writes channels ``c0 .. c0 + m`` of an ``m_out``-channel
    NCHW buffer, bit for bit the plain epilogue, the rest untouched."""
    rng = np.random.default_rng(m + c0)
    y = _padded_y(rng, b, m, m_pad, ro, co, cuda_device)
    layer = _layer(m, True, relu, scale=0.0371)
    bias = layer.bias_device.to(cuda_device)
    x_scale = torch.tensor([1.8930412], device=cuda_device)
    buf = torch.full((b, m_out, ro, co), 7.0, device=cuda_device)
    got = ops.epilogue(y, x_scale, float(layer.code.scale), bias, relu=relu,
                       out=buf[:, c0:c0 + m])
    torch.cuda.synchronize()
    want = ref.epilogue_plain(y, x_scale, float(layer.code.scale), bias,
                              relu)
    assert torch.equal(got, want)
    rest = torch.cat([buf[:, :c0], buf[:, c0 + m:]], dim=1)
    assert (rest == 7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu_out", "random", "nan"])
@pytest.mark.parametrize("shape, args", [
    ((4, 28, 28, 192), (3, 1, 1, False)),   # inception 3a's pool branch
    ((4, 28, 28, 480), (3, 2, 0, True)),    # the 3x3/2 pool, 28 -> 14
    ((2, 14, 14, 512), (3, 1, 1, False)),
    ((2, 7, 9, 5), (3, 2, 1, True)),
    ((3, 8, 8, 4), (2, 2, 0, False)),
    ((2, 113, 113, 3), (3, 2, 1, True)),    # a plane past shared memory
    ((1, 120, 130, 2), (2, 2, 0, False)),
])
def test_cuda_max_pool_equals_the_plain_version(shape, args, kind,
                                                cuda_device):
    """The ``max_pool`` kernel on NCHW storage (whole or a channel slice
    copied first) is ``F.max_pool2d`` bit for bit, a NaN kept; one
    launch."""
    xn = _inputs("random" if kind == "nan" else kind, shape, seed=len(args))
    if kind == "nan":
        xn[0, 1, 2, 0] = np.nan
    x = torch.from_numpy(xn).permute(0, 3, 1, 2).contiguous()
    before = ops.launches_by_impl["max_pool"]
    got = ops.max_pool(x.to(cuda_device), *args)
    torch.cuda.synchronize()
    assert ops.launches_by_impl["max_pool"] == before + 1
    want = ref.max_pool_plain(x, *args)
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                               equal_nan=True)
