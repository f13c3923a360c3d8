"""The port's CoDR compressed matmul against the JAX reference: the plain
version (the CPU path of the wrapper) against JAX's Pallas kernel in
interpret mode and JAX's plain ``codr_matmul_ref``; the ``codr_matmul``
backend; and, on a card, the CUDA kernel against the plain version.

Tolerances are the reference's own (``tests/test_kernels.py``): rtol
2e-3 / atol 2e-4 in float32 (the kernels sum in another order than the
plain product), 2e-2 in bfloat16 (one bf16 rounding of the output).
The reference package is imported inside the tests, so the ``cuda``
tests also run where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_codr_matmul.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import backends as tbackends
from repro_torch.core import codr_linear as tcl
from repro_torch.kernels.codr_matmul import ops as tops
from repro_torch.kernels.codr_matmul import ref as tref

F32 = dict(rtol=2e-3, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _jax():
    """(jnp, ucr, codr_linear, codr_matmul, codr_matmul_ref) of the JAX
    reference package."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import codr_linear, ucr
    from repro.kernels.codr_matmul import codr_matmul
    from repro.kernels.codr_matmul.ref import codr_matmul_ref
    return jnp, ucr, codr_linear, codr_matmul, codr_matmul_ref


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _q(rng, k, n, n_unique):
    """int8 (K, N) weights restricted to ``n_unique`` levels + scale, by
    the port's NumPy codec (byte-equal to the reference's)."""
    from repro_torch.core import ucr
    w = rng.normal(size=(k, n)).astype(np.float32)
    q, s = ucr.quantize_int8(w)
    return ucr.restrict_unique(q, n_unique), s


def _both_packs(rng, k, n, n_unique, dtype="float32"):
    jnp, _, jcl, _, _ = _jax()
    q, s = _q(rng, k, n, n_unique)
    return (jcl.pack_unique(q, s, dtype=getattr(jnp, dtype)),
            tcl.pack_unique(q, s, dtype=getattr(torch, dtype)))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# the plain version against the reference (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mkn", [(64, 64, 64), (128, 256, 128),
                                 (32, 384, 512), (256, 128, 256)])
@pytest.mark.parametrize("n_unique", [4, 16])
def test_plain_matches_reference_kernel_and_ref(mkn, n_unique):
    jnp, _, _, jmm, jref = _jax()
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n + n_unique)
    jw, tw = _both_packs(rng, k, n, n_unique)
    x = rng.normal(size=(m, k)).astype(np.float32)
    yj = np.asarray(jmm(jnp.asarray(x), jw, interpret=True))
    yr = np.asarray(jref(jnp.asarray(x), jw.packed, jw.table,
                         jw.scale.reshape(-1), bits=jw.bits, n=n))
    yt = tref.codr_matmul_ref(torch.from_numpy(x), tw.packed, tw.table,
                              tw.scale.reshape(-1), bits=tw.bits, n=n)
    assert yt.dtype == torch.float32 and yt.shape == (m, n)
    np.testing.assert_allclose(_np(yt), yj, **F32)
    np.testing.assert_allclose(_np(yt), yr, **F32)
    # the wrapper's CPU route is the plain version itself
    np.testing.assert_array_equal(_np(tops.codr_matmul(
        torch.from_numpy(x), tw)), _np(yt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_in_each_dtype(dtype):
    jnp, _, _, jmm, jref = _jax()
    rng = np.random.default_rng(12)
    jw, tw = _both_packs(rng, 128, 128, 16, dtype=dtype)
    x = rng.normal(size=(64, 128)).astype(np.float32)
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    yj = np.asarray(jmm(xj, jw, interpret=True), np.float32)
    yr = np.asarray(jref(xj, jw.packed, jw.table, jw.scale.reshape(-1),
                         bits=jw.bits, n=128), np.float32)
    yt = tops.codr_matmul(xt, tw)
    assert yt.dtype == xt.dtype
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(yt), yj, **tol)
    np.testing.assert_allclose(_np(yt), yr, **tol)


def test_wrapper_refuses_cpu_tensors_for_the_kernel():
    rng = np.random.default_rng(13)
    q, s = _q(rng, 32, 64, 16)
    w = tcl.pack_unique(q, s, dtype=torch.float32)
    x = torch.zeros(4, 32)
    before = tops.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.codr_matmul_cuda(x, w.packed, w.table, w.scale, bits=w.bits,
                              n=64)
    tops.codr_matmul(x, w)              # the plain version: no launch
    assert tops.launches == before


def test_kernel_caps_is_a_literal_with_the_registry_keys():
    assert {"kinds", "integer_activations", "description",
            "packed_matmul"} <= set(tops.KERNEL_CAPS)
    assert tops.KERNEL_CAPS["kinds"] == ("linear",)
    caps = tbackends.get_backend("codr_matmul").caps
    assert caps.packed_matmul and caps.native_kinds == {"linear"}
    assert tbackends.get_backend("tiled").caps.packed_matmul
    assert not tbackends.get_backend("smm_kernel").caps.packed_matmul


# ---------------------------------------------------------------------------
# the codr_matmul backend (CPU: the kernel's plain version)
# ---------------------------------------------------------------------------

def test_backend_matmul_crops_casts_and_rejects_stacks():
    rng = np.random.default_rng(14)
    w = rng.normal(size=(2, 32, 37)).astype(np.float32)
    pl = tcl.pack_projection(w, n_unique=16)
    be = tbackends.get_backend("codr_matmul")
    with pytest.raises(ValueError, match="stacked pack"):
        be.matmul(torch.zeros(3, 32), pl)
    x = torch.from_numpy(rng.normal(size=(2, 3, 32)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        y = be.matmul(x.to(dtype), pl[1])
        assert y.shape == (2, 3, 37) and y.dtype == dtype
        ref = x.to(dtype).to(torch.float32) @ pl[1].dense()
        np.testing.assert_allclose(_np(y), ref.numpy(),
                                   **(F32 if dtype == torch.float32
                                      else BF16))
    # the decode-then-matmul default (tiled) is the dense product exactly
    yt = tbackends.get_backend("tiled").matmul(x, pl[0])
    np.testing.assert_array_equal(yt.numpy(),
                                  (x @ pl[0].dense()).numpy())


@pytest.mark.parametrize("m_out", [10, 40])        # both pad to 32 columns
def test_cnn_linear_lane_matches_reference(m_out):
    """The CNN lane's linear-only path: a linear model compiled onto the
    ``codr_matmul`` backend in both packages."""
    import repro.api as jcodr

    import repro_torch.api as tcodr
    rng = np.random.default_rng(15)
    w = rng.normal(size=(m_out, 24)).astype(np.float32)
    b = rng.normal(size=m_out).astype(np.float32)
    cfg = dict(n_unique=16, t_m_linear=8)
    jc = jcodr.compile(jcodr.ModelSpec([jcodr.LayerSpec.dense(
        w, b, activation="relu", name="fc")]), jcodr.EncodeConfig(**cfg),
        backend="codr_matmul")
    tc = tcodr.compile(tcodr.ModelSpec([tcodr.LayerSpec.dense(
        w, b, activation="relu", name="fc")]), tcodr.EncodeConfig(**cfg),
        backend="codr_matmul", device="cpu")
    x = rng.normal(size=(5, 24)).astype(np.float32)
    y = tc.run(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jc.run(x)), **F32)
    np.testing.assert_allclose(y.numpy(), tc.run(x, backend="tiled").numpy(),
                               **F32)
    with pytest.raises(ValueError, match="codr_matmul"):
        tcodr.compile(tcodr.ModelSpec([tcodr.LayerSpec.conv(
            np.ones((4, 2, 3, 3), np.float32), name="c0")]),
            backend="codr_matmul", device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (M, K, N): the reference's kernel sweep (tests/test_kernels.py); ragged
# M and K against the 64-row chunks and row tiles, N a whole number of
# words but not of 64-column tiles; and the decode / prefill widths of
# qwen2.5-3b
CUDA_SHAPES = [(64, 64, 64), (128, 256, 128), (32, 384, 512),
               (256, 128, 256), (1, 16, 32), (5, 70, 96), (33, 130, 192),
               (4, 2048, 256), (128, 2048, 256), (4, 11008, 2048)]


def _random_pack(rng, k, n, bits, table_dtype, device):
    """Random words and a random 2^bits table (covers bits = 16, which no
    int8 weight reaches)."""
    words = rng.integers(0, 1 << 32, size=(k, n * bits // 32),
                         dtype=np.uint64).astype(np.uint32)
    table = rng.normal(size=1 << bits).astype(np.float32)
    return (torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(table).to(device=device, dtype=table_dtype),
            torch.tensor([0.37], dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", CUDA_SHAPES)
@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(mkn, bits, x_dtype, table_dtype,
                                      cuda_device):
    m, k, n = mkn
    rng = np.random.default_rng(m * 7 + k + n + bits)
    packed, table, scale = _random_pack(rng, k, n, bits, table_dtype,
                                        cuda_device)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda_device, x_dtype)
    before = tops.launches
    y = tops.codr_matmul_cuda(x, packed, table, scale, bits=bits, n=n)
    torch.cuda.synchronize()
    assert tops.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (m, n)
    torch.backends.cuda.matmul.allow_tf32 = False
    yr = tref.codr_matmul_ref(x, packed, table, scale, bits=bits, n=n)
    tol = F32 if x_dtype == torch.float32 else BF16
    np.testing.assert_allclose(_np(y.cpu()), _np(yr.cpu()), **tol)


@pytest.mark.cuda
def test_kernel_runs_the_packed_projection_lane(cuda_device):
    rng = np.random.default_rng(16)
    w = rng.normal(size=(3, 256, 300)).astype(np.float32)
    pl = tcl.pack_projection(torch.from_numpy(w).to(cuda_device),
                             n_unique=16)
    be = tbackends.get_backend("codr_matmul")
    x = torch.from_numpy(rng.normal(size=(2, 4, 256)).astype(np.float32)
                         ).to(cuda_device, torch.bfloat16)
    before = tops.launches
    y = be.matmul(x, pl[2])
    torch.cuda.synchronize()
    assert tops.launches == before + 1
    ref = x.to(torch.float32) @ pl[2].dense()
    np.testing.assert_allclose(_np(y.cpu()), ref.cpu().numpy(), **BF16)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    rng = np.random.default_rng(17)
    packed, table, scale = _random_pack(rng, 64, 64, 4, torch.float32,
                                        cuda_device)
    x = torch.zeros(4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="does not hold"):
        tops.codr_matmul_cuda(x, packed, table, scale, bits=4, n=128)
    with pytest.raises(ValueError, match="contiguous"):
        tops.codr_matmul_cuda(x.T.contiguous().T, packed, table, scale,
                              bits=4, n=64)
    with pytest.raises(ValueError, match="2\\^4 entries"):
        tops.codr_matmul_cuda(x, packed, table[:8], scale, bits=4, n=64)
    with pytest.raises(ValueError, match="bits"):
        tops.codr_matmul_cuda(x, packed, table, scale, bits=3, n=64)
