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
import numpy as np
import pytest
import torch

from repro_torch.core import smm as tsmm
from repro_torch.core import ucr as tucr
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
    assert tm == jm


def test_pack_smm_operands_all_zero_layer_equal_reference():
    jucr, _, jops, _ = _jax_ref()
    w = np.zeros((4, 2, 3, 3), np.float32)
    jd, je, jm = jops.pack_smm_operands(jucr.encode_conv_layer(w, t_m=4,
                                                               t_n=2), 2)
    td, te, tm = tops.pack_smm_operands(tucr.encode_conv_layer(w, t_m=4,
                                                               t_n=2), 2)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(te, je)
    assert tm == jm


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


def test_kernel_caps_is_a_literal_with_the_registry_keys():
    assert {"kinds", "integer_activations", "description"} <= set(
        tops.KERNEL_CAPS)
    assert tops.KERNEL_CAPS["kinds"] == ("conv",)


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
