"""The port's flash attention against the JAX reference: the wrapper on
CPU tensors (the plain version) and the plain version itself against
JAX's Pallas kernel in interpret mode and JAX's plain
``flash_attention_ref``; the plain version against the port's chunked
model attention; the routing rule between the two CUDA instances and a
plain emulation of the tensor-core instance's split-P arithmetic; and,
on a card, each CUDA instance against the plain version.

The inputs are made from a NumPy seed and handed to both packages.
Tolerances: the reference's own in float32 (``tests/test_kernels.py``),
rtol 1e-4 / atol 1e-5, since the online softmax sums in another order
than the plain one; in bfloat16 one bf16 ulp of the plain output (rtol
2^-7, atol 1e-6), since every side computes in float32 and rounds the
output once.  A version that rounds the probabilities to bf16 before
P·V, as a tensor-core kernel would, falls outside that bound, and a test
here shows it does; so does one that feeds P as two bf16 parts, while
three parts (what the ``sm90`` instance does) stay inside it.  The JAX
side gets the reference test's ``bq`` / ``bk``, which pick its grid
only; the port's kernels have fixed tiles.  The reference
package is imported inside the tests, so the ``cuda`` tests also run
where JAX is absent:

    python -m pytest -q --noconftest -m cuda tests/test_torch_flash_attention.py
"""
import math

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


@pytest.mark.parametrize("dtype,d,dv,impl", [
    (torch.bfloat16, 64, 64, "sm90"), (torch.bfloat16, 128, 128, "sm90"),
    (torch.bfloat16, 32, 32, "simt"), (torch.bfloat16, 256, 256, "simt"),
    (torch.bfloat16, 128, 64, "simt"), (torch.bfloat16, 64, 128, "simt"),
    (torch.bfloat16, 96, 96, "simt"), (torch.float32, 64, 64, "simt"),
    (torch.float32, 128, 128, "simt"), (torch.float32, 16, 8, "simt")])
def test_routing_rule(dtype, d, dv, impl):
    """bf16 with D = Dv in {64, 128} runs the tensor-core instance; every
    other shape, and float32, the CUDA-core one."""
    assert tops.pick_impl(dtype, d, dv) == impl


@pytest.mark.parametrize("dtype,d,dv", [(torch.float32, 64, 64),
                                        (torch.bfloat16, 32, 32),
                                        (torch.bfloat16, 128, 64)])
def test_sm90_refuses_a_shape_it_does_not_take(dtype, d, dv):
    q, k, v = (torch.zeros(1, 8, 4, d, dtype=dtype),
               torch.zeros(1, 8, 2, d, dtype=dtype),
               torch.zeros(1, 8, 2, dv, dtype=dtype))
    before = dict(tops.launches_by_impl)
    with pytest.raises(ValueError, match="sm90 instance takes"):
        tops.flash_attention_cuda(q, k, v, causal=True, impl="sm90")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.flash_attention_cuda(q, k, v, causal=True, impl="wgmma")
    assert tops.launches_by_impl == before


def _split_p_emulation(q, k, v, *, causal, parts, block=64):
    """The ``sm90`` instance's arithmetic in plain PyTorch: float32 online
    softmax over 64-row kv tiles in the log2 domain, P fed to P·V as
    ``parts`` bf16 parts (hi, then bf16 of what is left, ...), each part's
    product exact and summed in float32."""
    b, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d)
    scale = d ** -0.5 * math.log2(math.e)
    m = torch.full((b, hkv, hq // hkv, sq, 1), -1e30)
    l = torch.zeros_like(m)
    o = torch.zeros(b, hkv, hq // hkv, sq, dv)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block):
        kb, vb = k[:, k0:k0 + block].float(), v[:, k0:k0 + block].float()
        x = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        if causal:
            x = torch.where(k0 + torch.arange(kb.shape[1]) > rows, -1e30, x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr
        for _ in range(parts):
            part = p.to(torch.bfloat16).float()
            o = o + torch.einsum("bhgqk,bkhd->bhgqd", part, vb)
            p = p - part
        m = m_new
    out = o / l.clamp_min(1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv).to(q.dtype)


def _beyond_bf16_bound(y, want) -> int:
    y, want = _np(y), _np(want)
    return int((np.abs(y - want) > BF16["atol"]
                + BF16["rtol"] * np.abs(want)).sum())


@pytest.mark.parametrize("causal", [True, False])
def test_split_probabilities_hold_the_bf16_bound(causal):
    """At qwen2.5-3b's head widths (16 / 2 heads, D 128), S = 256, the
    kernel's arithmetic with P in three bf16 parts is within one bf16 ulp
    of the plain version; with P in one bf16 part it is not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(9, 1, 256, 256, 16, 2, 128))
    want = tref.flash_attention_ref(q, k, v, causal=causal)
    got = _split_p_emulation(q, k, v, causal=causal, parts=3)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    one = _split_p_emulation(q, k, v, causal=causal, parts=1)
    assert _beyond_bf16_bound(one, want) > 0


def test_two_bf16_parts_of_p_miss_the_bf16_bound():
    """Two bf16 parts leave up to 2^-18 of P: in a row with few keys whose
    output cancels to ~1e-4 of its terms that is beyond one ulp (a few
    elements in these seeds).  Three parts leave none."""
    two = three = 0
    for seed in (11, 13, 14):
        q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(seed, 1, 256, 256, 16, 2, 128))
        want = tref.flash_attention_ref(q, k, v, causal=True)
        two += _beyond_bf16_bound(
            _split_p_emulation(q, k, v, causal=True, parts=2), want)
        three += _beyond_bf16_bound(
            _split_p_emulation(q, k, v, causal=True, parts=3), want)
    assert two > 0 and three == 0


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

# the tensor-core instance's shapes, bf16 with D = Dv in {64, 128}: S
# ragged against the 128-row q and 64-row kv tiles, both masks; Sq != Sk
# both ways; GQA groups 1, 2 and 8; qwen2.5-3b's long prompts
SM90_CASES = [
    *[(1, s, s, 16 if s == 4096 else 4, 2, d, d, causal, torch.bfloat16)
      for d in (64, 128) for causal in (True, False)
      for s in (1, 63, 65, 1000, 4096)],
    *[(2, sq, sk, 4, 2, d, d, causal, torch.bfloat16)
      for d in (64, 128) for causal in (True, False)
      for sq, sk in ((64, 300), (300, 64))],
    *[(1, 300, 300, hq, hkv, 128, 128, True, torch.bfloat16)
      for hq, hkv in ((4, 4), (4, 2), (16, 2))],
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
    impl = tops.pick_impl(dtype, case[5], case[6])
    if dtype == torch.float32:
        assert impl == "simt"
    before, by_impl = tops.launches, dict(tops.launches_by_impl)
    y = tops.flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.launches == before + 1
    assert tops.launches_by_impl[impl] == by_impl[impl] + 1
    assert y.dtype == dtype and y.shape == (*q.shape[:3], v.shape[-1])
    with full_fp32():
        yr = tref.flash_attention_ref(q, k, v, causal=causal)
    tol = F32 if dtype == torch.float32 else BF16
    np.testing.assert_allclose(_np(y.cpu()), _np(yr.cpu()), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SM90_CASES, ids=str)
def test_sm90_matches_plain_version(case, cuda_device):
    """The tensor-core instance, routed there by the rule, within one bf16
    ulp of the plain version."""
    from repro_torch.core.engine import full_fp32
    causal = case[7]
    q, k, v = _on_card(case, cuda_device)
    assert tops.pick_impl(q.dtype, q.shape[-1], v.shape[-1]) == "sm90"
    before = dict(tops.launches_by_impl)
    y = tops.flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.launches_by_impl == dict(before, sm90=before["sm90"] + 1)
    assert y.dtype == torch.bfloat16 and y.shape == (*q.shape[:3],
                                                     v.shape[-1])
    with full_fp32():
        yr = tref.flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(y.cpu()), _np(yr.cpu()), **BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,impl", [(torch.float32, "simt"),
                                        (torch.bfloat16, "simt"),
                                        (torch.bfloat16, "sm90")])
def test_kernel_gives_the_same_bits_twice(dtype, impl, cuda_device):
    case = (2, 300, 300, 16, 2, 128, 128, True, dtype)
    q, k, v = _on_card(case, cuda_device)
    before, by_impl = tops.launches, tops.launches_by_impl[impl]
    a = tops.flash_attention_cuda(q, k, v, causal=True, impl=impl)
    b = tops.flash_attention_cuda(q, k, v, causal=True, impl=impl)
    torch.cuda.synchronize()
    assert tops.launches == before + 2
    assert tops.launches_by_impl[impl] == by_impl + 2
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_sm90_takes_unaligned_inputs(cuda_device):
    """A contiguous view that starts off a 16-byte boundary (which the TMA
    cannot address) is copied by the wrapper, not misread."""
    q, k, v = _on_card((1, 100, 100, 4, 2, 64, 64, True, torch.bfloat16),
                       cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    qu = flat[1:].view(q.shape)
    qu.copy_(q)
    assert qu.is_contiguous() and qu.data_ptr() % 16 != 0
    y = tops.flash_attention_cuda(qu, k, v, causal=True, impl="sm90")
    yc = tops.flash_attention_cuda(q, k, v, causal=True, impl="sm90")
    torch.cuda.synchronize()
    assert torch.equal(y, yc)


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
    with pytest.raises(ValueError, match="sm90 instance takes"):
        tops.flash_attention_cuda(q, k, v, causal=True, impl="sm90")
    assert tops.launches == before
