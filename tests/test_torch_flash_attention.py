"""The port's flash attention against the JAX reference: the wrapper on
CPU tensors (the plain version) and the plain version itself against
JAX's Pallas kernel in interpret mode and JAX's plain
``flash_attention_ref``; the plain version against the port's chunked
model attention; and, on a card, the CUDA kernel against the plain
version.

The inputs are made from a NumPy seed and handed to both packages.
Tolerances: the reference's own in float32 (``tests/test_kernels.py``),
rtol 1e-4 / atol 1e-5, since the online softmax sums in another order
than the plain one; in bfloat16 one bf16 ulp of the plain output (rtol
2^-7, atol 1e-6), since every side computes in float32 and rounds the
output once.  A version that rounds the probabilities to bf16 before
P·V, as a tensor-core kernel would, falls outside that bound, and a test
here shows it does.  The JAX side gets the reference test's ``bq`` / ``bk``, which
pick its grid only; the port's kernel has fixed tiles.  The reference
package is imported inside the tests, so the ``cuda`` tests also run
where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=1e-6)


def _jax():
    """(jnp, flash_attention_kernel, flash_attention_ref) of the JAX
    reference package."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.flash_attention import (flash_attention_kernel,
                                               flash_attention_ref)
    return jnp, flash_attention_kernel, flash_attention_ref


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b, sq, sk, hq, hkv, d, dv=None):
    """float32 (q, k, v) NumPy arrays in the (B, S, H, D) layout."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dv or d)).astype(np.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _against_reference(arrays, *, causal, bq=64, bk=64, dtype="float32"):
    """Run both packages on the same arrays and hold the port to JAX:
    the port's plain version to JAX's, the port's wrapper (CPU route) to
    JAX's kernel in interpret mode."""
    jnp, jkernel, jref = _jax()
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    yj = jkernel(*jx, causal=causal, bq=bq, bk=bk, interpret=True)
    yjr = jref(*jx, causal=causal)
    yt = tops.flash_attention_kernel(*tx, causal=causal)
    ytr = tref.flash_attention_ref(*tx, causal=causal)
    b, sq, hq, _ = arrays[0].shape
    assert yt.dtype == tx[0].dtype and yt.shape == (b, sq, hq,
                                                    arrays[2].shape[-1])
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(_np(ytr), np.asarray(yjr, np.float32), **tol)
    np.testing.assert_allclose(_np(yt), np.asarray(yj, np.float32), **tol)
    # the wrapper's CPU route is the plain version itself
    np.testing.assert_array_equal(_np(yt), _np(ytr))


# ---------------------------------------------------------------------------
# the wrapper (CPU: the plain version) against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 128, 4, 2, 32), (1, 256, 8, 8, 16),
                                   (2, 96, 4, 1, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_at_its_shapes(shape, causal):
    b, s, hq, hkv, d = shape
    _against_reference(_inputs(sum(shape), b, s, s, hq, hkv, d),
                       causal=causal)


@pytest.mark.parametrize("bq,bk", [(32, 32), (128, 64), (64, 128)])
def test_matches_reference_block_sweep(bq, bk):
    _against_reference(_inputs(3, 1, 128, 128, 2, 2, 32), causal=True,
                       bq=bq, bk=bk)


def test_matches_reference_at_a_prime_length():
    """S = 97: the reference snaps bq = bk = 64 down to blocks of 1."""
    _against_reference(_inputs(97, 1, 97, 97, 4, 2, 16), causal=True)


@pytest.mark.parametrize("sq,sk", [(64, 128), (128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_when_sq_differs_from_sk(sq, sk, causal):
    _against_reference(_inputs(sq + sk, 2, sq, sk, 4, 2, 32), causal=causal)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_with_dv_unlike_d(causal):
    _against_reference(_inputs(5, 2, 64, 64, 4, 2, 32, dv=16), causal=causal)


@pytest.mark.parametrize("causal", [True, False])
def test_matches_reference_in_bfloat16(causal):
    _against_reference(_inputs(6, 2, 128, 128, 4, 2, 32), causal=causal,
                       dtype="bfloat16")


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_the_models_chunked_attention(causal):
    """A small qwen2.5-3b-shaped case (8 q heads per kv head) through the
    port's chunked model attention, with chunks that split both axes."""
    q, k, v = map(torch.from_numpy, _inputs(7, 2, 48, 48, 16, 2, 32))
    want = tattn.flash_attention(q, k, v, causal=causal, q_chunk=16,
                                 kv_chunk=8)
    got = tops.flash_attention_kernel(q, k, v, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)


def _plain_with_bf16_probabilities(q, k, v, *, causal):
    """The plain version with P rounded to bf16 before P·V: what a kernel
    that feeds P to bf16 tensor cores computes."""
    b, s, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    qg = q.reshape(b, s, hkv, hq // hkv, d).float()
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / d ** 0.5
    if causal:
        mask = torch.tril(torch.ones(s, sk, dtype=torch.bool))
        scores = torch.where(mask, scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, hq, dv).to(q.dtype)


def test_bfloat16_tolerance_rejects_bfloat16_probabilities():
    """At qwen2.5-3b's head widths (16 / 2 heads, D 128) the bf16 bound
    holds JAX's float32 plain version to the port's, and tells either
    from one that rounds P to bf16."""
    jnp, _, jref = _jax()
    arrays = _inputs(9, 1, 256, 256, 16, 2, 128)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    want = tref.flash_attention_ref(q, k, v, causal=True)
    got = _plain_with_bf16_probabilities(q, k, v, causal=True)
    assert not np.allclose(_np(got), _np(want), **BF16)
    yj = jref(*(jnp.asarray(a, jnp.bfloat16) for a in arrays), causal=True)
    np.testing.assert_allclose(np.asarray(yj, np.float32), _np(want), **BF16)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _inputs(8, 1, 16, 16, 4, 2, 8))
    before = tops.launches
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tops.flash_attention_kernel(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tops.flash_attention_kernel(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tops.flash_attention_kernel(*(t.to(torch.float16) for t in (q, k, v)))
    with pytest.raises(ValueError, match="1..256"):
        big = torch.zeros(1, 16, 2, 257)
        tops.flash_attention_kernel(big, big, big)
    with pytest.raises(ValueError, match="Sk must be at least 1"):
        tops.flash_attention_kernel(q, k[:, :0], v[:, :0])
    with pytest.raises(ValueError, match="do not fit"):
        tops.flash_attention_kernel(q, k[..., :4], v)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.flash_attention_cuda(q, k, v, causal=True)
    tops.flash_attention_kernel(q, k, v)         # the plain version: no launch
    assert tops.launches == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (B, Sq, Sk, Hq, Hkv, D, Dv, causal, dtype): the reference's shapes both
# ways; ragged lengths against the 64-row tiles; Sq != Sk; Dv != D; the
# largest head dim; and the attention of qwen2.5-3b (16 / 2 heads, D 128)
# in f32 at S = 1024 and in bf16 at the serve path's prefill and at long
# prompts — the cases chip_smoke.py holds
CUDA_CASES = [
    *[(b, s, s, hq, hkv, d, d, causal, torch.float32)
      for (b, s, hq, hkv, d) in ((2, 128, 4, 2, 32), (1, 256, 8, 8, 16),
                                 (2, 96, 4, 1, 64))
      for causal in (True, False)],
    *[(1, s, s, 4, 2, 64, 64, True, torch.float32)
      for s in (1, 63, 65, 97, 1000)],
    (2, 64, 128, 4, 2, 64, 64, True, torch.float32),
    (2, 128, 64, 4, 2, 64, 64, True, torch.float32),
    (2, 96, 96, 4, 2, 32, 16, True, torch.float32),
    (1, 130, 130, 4, 2, 256, 256, True, torch.float32),
    (1, 1024, 1024, 16, 2, 128, 128, True, torch.float32),
    (4, 32, 32, 16, 2, 128, 128, True, torch.bfloat16),
    (1, 4096, 4096, 16, 2, 128, 128, True, torch.bfloat16),
    (4, 2048, 2048, 16, 2, 128, 128, True, torch.bfloat16),
]


def _on_card(case, device):
    b, sq, sk, hq, hkv, d, dv, _, dtype = case
    arrays = _inputs(sq * 7 + sk + d + dv, b, sq, sk, hq, hkv, d, dv)
    return [torch.from_numpy(a).to(device, dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_kernel_matches_plain_version(case, cuda_device):
    from repro_torch.core.engine import full_fp32
    causal, dtype = case[7], case[8]
    q, k, v = _on_card(case, cuda_device)
    before = tops.launches
    y = tops.flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.launches == before + 1
    assert y.dtype == dtype and y.shape == (*q.shape[:3], v.shape[-1])
    with full_fp32():
        yr = tref.flash_attention_ref(q, k, v, causal=causal)
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(_np(y.cpu()), _np(yr.cpu()), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gives_the_same_bits_twice(dtype, cuda_device):
    case = (2, 300, 300, 16, 2, 128, 128, True, dtype)
    q, k, v = _on_card(case, cuda_device)
    before = tops.launches
    a = tops.flash_attention_cuda(q, k, v, causal=True)
    b = tops.flash_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tops.launches == before + 2
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_takes_strided_inputs(cuda_device):
    """A non-contiguous view is copied by the wrapper, not misread."""
    q, k, v = _on_card((1, 80, 80, 4, 2, 32, 32, True, torch.float32),
                       cuda_device)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert not qt.is_contiguous()
    y = tops.flash_attention_kernel(qt, k, v)
    yc = tops.flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(y, yc)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _on_card((1, 16, 16, 4, 2, 8, 8, True, torch.float32),
                       cuda_device)
    before = tops.launches
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tops.flash_attention_kernel(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        tops.flash_attention_kernel(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="is on"):
        tops.flash_attention_kernel(q, k.cpu(), v)
    assert tops.launches == before
