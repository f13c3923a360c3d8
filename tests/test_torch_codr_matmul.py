"""The port's CoDR compressed matmul against the JAX reference: the plain
version (the CPU path of the wrapper) against JAX's Pallas kernel in
interpret mode and JAX's plain ``codr_matmul_ref``; the ``codr_matmul``
backend; the routing rule and an exact emulation of the tensor-core
instance's arithmetic; and, on a card, every CUDA instance against the
plain version.

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
# routing, grids and the sm90 arithmetic (CPU)
# ---------------------------------------------------------------------------

# qwen2.5-3b's projections (K, N): q/o, k/v, up/gate, down
MAIN_KN = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]


@pytest.mark.parametrize("m,bits,impl", [
    (1, 4, "splitk"), (4, 4, "splitk"), (16, 4, "splitk"),
    (16, 16, "splitk"), (17, 4, "sm90"), (128, 1, "sm90"), (128, 8, "sm90"),
    (4096, 2, "sm90"), (17, 16, "splitk"), (96, 16, "splitk"),
    (97, 16, "simt"), (128, 16, "simt")])
def test_pick_impl_routes_by_rows_and_bits(m, bits, impl):
    assert tops.pick_impl(m, bits) == impl
    assert tops.SPLITK_MAX_M == 16 and tops.BITS16_SPLITK_MAX_M == 96
    assert tops.IMPLS == ("simt", "splitk", "sm90")


@pytest.mark.parametrize("kn", MAIN_KN)
def test_grids_fill_the_card_and_cover_k(kn):
    k, n = kn
    for m in (1, 4, 8, 16):
        p = tops.splitk_plan(m, k, n)
        blocks = p["slices"] * p["m_tiles"] * p["n_tiles"]
        assert blocks >= 132, (m, p)
        assert p["ks"] * p["slices"] >= k > p["ks"] * (p["slices"] - 1)
        assert p["ks"] * p["rm"] * 4 <= 32768 and p["rm"] >= m
        if m <= 4:              # two blocks an SM: one round of the card
            assert blocks <= 264, p
    for m in (17, 128, 1000):
        p = tops.sm90_plan(m, k, n)
        k_tiles = -(-k // 64)
        assert p["kt"] * p["slices"] >= k_tiles > p["kt"] * (p["slices"] - 1)
        assert p["m_tiles"] * 128 >= m and p["n_tiles"] * 128 >= n


def test_forcing_an_instance_is_checked_before_the_device():
    rng = np.random.default_rng(18)
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(8, 2),
                                          dtype=np.int64).astype(np.int32))
    table = torch.zeros(1 << 16)
    with pytest.raises(ValueError, match="sm90 instance takes bits"):
        tops.codr_matmul_cuda(torch.zeros(32, 8), words, table,
                              torch.ones(1), bits=16, n=4, impl="sm90")
    with pytest.raises(ValueError, match="impl must be one of"):
        tops.codr_matmul_cuda(torch.zeros(4, 8), words, table,
                              torch.ones(1), bits=16, n=4, impl="tiled")


def _bf16_parts(t: torch.Tensor, parts: int) -> list:
    """``t`` (float32) as ``parts`` bf16 values hi, mid, lo, …, each the
    top 16 bits of what the earlier ones leave (three hold it exactly)."""
    out, rest = [], t.clone()
    for _ in range(parts):
        h = (rest.view(torch.int32) & -65536).view(torch.float32)
        out.append(h)
        rest = rest - h
    return out


def _sm90_emulate(x, packed, table, scale, *, bits, n, x_parts):
    """The sm90 instance's arithmetic on the CPU: x in ``x_parts`` bf16
    parts; the decoded weights in one bf16 part or, where a table entry
    is not exact in bf16, three, of which part
    j meets x's parts i with i + j <= 2; every product of a 64-row k-tile
    summed exactly (float64 holds the sums of bf16 × bf16 products) and
    added to the slice's f32 accumulator in the kernel's order; the
    slices' f32 partials summed in slice order; times the scale.  Returns
    the float32 result and the number of weight parts."""
    m, k = x.shape
    plan = tops.sm90_plan(m, k, n)
    dense = tref.decode_ref(packed, table, bits=bits, n=n)
    wp = _bf16_parts(dense, 3)
    wp = wp[:1] if not bool(wp[1].any()) else wp
    xp = _bf16_parts(x.to(torch.float32), x_parts)
    pairs = [(j, i) for j in range(len(wp)) for i in range(x_parts)
             if j == 0 or i + j <= 2]
    total = torch.zeros(m, n)
    k_tiles = -(-k // 64)
    for s in range(plan["slices"]):
        acc = torch.zeros(m, n)
        for t in range(s * plan["kt"], min((s + 1) * plan["kt"], k_tiles)):
            ks = slice(64 * t, min(64 * t + 64, k))
            tile = torch.zeros(m, n, dtype=torch.float64)
            for j, i in pairs:
                tile += xp[i][:, ks].double() @ wp[j][ks].double()
            acc += tile.to(torch.float32)
        total += acc
    return total * scale.reshape(-1), len(wp)


def _beyond(y: torch.Tensor, yr: torch.Tensor) -> int:
    rtol, atol = F32["rtol"], F32["atol"]
    return int(((y - yr).abs() > atol + rtol * yr.abs()).sum())


@pytest.mark.parametrize("kn", MAIN_KN)
def test_sm90_arithmetic_emulated_at_the_main_path_shapes(kn):
    """At M = 128 and each projection of qwen2.5-3b, with pack_unique's
    integer levels (exact in bf16, one weight part): the kernel's part
    count puts no output beyond rtol 2e-3 / atol 2e-4 of the plain
    version, and two parts would (which is why x goes in three)."""
    k, n = kn
    rng = np.random.default_rng(k + n)
    q, s = _q(rng, k, n, 16)
    w = tcl.pack_unique(q, s, dtype=torch.float32)
    x = torch.from_numpy(rng.normal(size=(128, k)).astype(np.float32))
    args = (x, w.packed, w.table, w.scale.reshape(-1))
    yr = tref.codr_matmul_ref(*args, bits=w.bits, n=n)
    # three x parts: Smem<float>::kXParts in csrc/codr_matmul_sm90.cu
    y3, w_parts = _sm90_emulate(*args, bits=w.bits, n=n, x_parts=3)
    assert w_parts == 1
    assert _beyond(y3, yr) == 0
    y2, _ = _sm90_emulate(*args, bits=w.bits, n=n, x_parts=2)
    assert _beyond(y2, yr) > 0


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_sm90_arithmetic_splits_inexact_tables(bits):
    """A random normal table is not exact in bf16: the emulation takes
    the kernel's three weight parts and stays within the f32 tolerance at
    down_proj's depth.  (With two, on the card, some outputs of a 1-bit
    pack at K = 11008 fell beyond it: the tensor cores' sums within a
    k-tile are not exact, which this emulation does not model.)"""
    m, k, n = 64, 11008, 256
    rng = np.random.default_rng(19 + bits)
    words = rng.integers(0, 1 << 32, size=(k, n * bits // 32),
                         dtype=np.uint64).astype(np.uint32)
    packed = torch.from_numpy(words.view(np.int32))
    table = torch.from_numpy(rng.normal(size=1 << bits).astype(np.float32))
    scale = torch.tensor([0.37])
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    yr = tref.codr_matmul_ref(x, packed, table, scale, bits=bits, n=n)
    y, w_parts = _sm90_emulate(x, packed, table, scale, bits=bits, n=n,
                               x_parts=3)
    assert w_parts == 3
    assert _beyond(y, yr) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (M, K, N): the reference's kernel sweep (tests/test_kernels.py); ragged
# M and K against every instance's row tiles, 64-row k-tiles and K slices
# (K not a multiple of a slice), N a whole number of words but not of the
# column tiles; M in {1, 4, 16, 17, 64, 128}; and the decode / prefill
# widths of qwen2.5-3b
CUDA_SHAPES = [(64, 64, 64), (128, 256, 128), (32, 384, 512),
               (256, 128, 256), (1, 16, 32), (5, 70, 96), (33, 130, 192),
               (4, 2048, 256), (128, 2048, 256), (4, 11008, 2048),
               (16, 1000, 320), (17, 777, 384), (64, 1111, 64),
               (1, 3001, 128)]
# every instance with the bits it takes
IMPL_BITS = [(impl, bits) for impl in ("simt", "splitk", "sm90")
             for bits in (1, 2, 4, 8, 16)
             if not (impl == "sm90" and bits == 16)]


def _random_pack(rng, k, n, bits, table_dtype, device):
    """Random words and a random 2^bits table (covers bits = 16, which no
    int8 weight reaches, and tables that are not exact in bf16)."""
    words = rng.integers(0, 1 << 32, size=(k, n * bits // 32),
                         dtype=np.uint64).astype(np.uint32)
    table = rng.normal(size=1 << bits).astype(np.float32)
    return (torch.from_numpy(words.view(np.int32)).to(device),
            torch.from_numpy(table).to(device=device, dtype=table_dtype),
            torch.tensor([0.37], dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", CUDA_SHAPES)
@pytest.mark.parametrize("impl,bits", IMPL_BITS)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(mkn, impl, bits, x_dtype, table_dtype,
                                      cuda_device):
    m, k, n = mkn
    rng = np.random.default_rng(m * 7 + k + n + bits)
    packed, table, scale = _random_pack(rng, k, n, bits, table_dtype,
                                        cuda_device)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda_device, x_dtype)
    before = tops.launches
    y = tops.codr_matmul_cuda(x, packed, table, scale, bits=bits, n=n,
                              impl=impl)
    torch.cuda.synchronize()
    assert tops.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (m, n)
    torch.backends.cuda.matmul.allow_tf32 = False
    yr = tref.codr_matmul_ref(x, packed, table, scale, bits=bits, n=n)
    tol = F32 if x_dtype == torch.float32 else BF16
    np.testing.assert_allclose(_np(y.cpu()), _np(yr.cpu()), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,m", [("splitk", 4), ("splitk", 16),
                                    ("sm90", 17), ("sm90", 128)])
def test_split_k_instances_repeat_bit_for_bit(impl, m, cuda_device):
    """The K slices are summed in a fixed order: two calls, the same bits
    (down_proj's shape, many slices)."""
    rng = np.random.default_rng(20 + m)
    q, s = _q(rng, 11008, 2048, 16)
    w = tcl.pack_unique(torch.from_numpy(q).to(cuda_device), s,
                        dtype=torch.float32)
    x = torch.from_numpy(rng.normal(size=(m, 11008)).astype(np.float32)
                         ).to(cuda_device)
    args = (x, w.packed, w.table, w.scale.reshape(-1))
    y1 = tops.codr_matmul_cuda(*args, bits=w.bits, n=2048, impl=impl)
    y2 = tops.codr_matmul_cuda(*args, bits=w.bits, n=2048, impl=impl)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    plan = (tops.splitk_plan if impl == "splitk" else tops.sm90_plan)(
        m, 11008, 2048)
    assert plan["slices"] > 1
    yr = tref.codr_matmul_ref(*args, bits=w.bits, n=2048)
    np.testing.assert_allclose(y1.cpu().numpy(), yr.cpu().numpy(), **F32)


@pytest.mark.cuda
def test_launches_by_impl_counts_one_per_call_as_routed(cuda_device):
    rng = np.random.default_rng(21)
    packed, table, scale = _random_pack(rng, 256, 128, 4, torch.float32,
                                        cuda_device)
    before, by = tops.launches, dict(tops.launches_by_impl)
    expect = dict.fromkeys(tops.IMPLS, 0)
    for m in (1, 4, 16, 17, 128):
        x = torch.ones(m, 256, device=cuda_device)
        tops.codr_matmul_cuda(x, packed, table, scale, bits=4, n=128)
        expect[tops.pick_impl(m, 4)] += 1
    x = torch.ones(32, 256, device=cuda_device)
    tops.codr_matmul_cuda(x, packed, table, scale, bits=4, n=128,
                          impl="simt")
    expect["simt"] += 1
    torch.cuda.synchronize()
    assert tops.launches == before + 6
    assert {i: tops.launches_by_impl[i] - by[i] for i in tops.IMPLS} == expect
    assert expect == {"simt": 1, "splitk": 3, "sm90": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_sm90_splits_tables_that_bf16_does_not_hold(bits, cuda_device):
    """The same words through a table of int8 levels (one weight part)
    and a random normal one (three, decided on the device).  The kernel
    is held within the f32 tolerance of the exact (float64) product of
    the same operands in every case, and of the plain f32 version where
    that one's own rounding allows: the levels at the scale pack_unique
    gives them (max |w| / 127 of unit-normal weights, outputs of the
    model's size) and the normal table.  At scale 0.37 the levels'
    outputs reach ~5000, and the plain f32 product's rounding alone can
    put an output beyond the tolerance of the exact one; the kernel
    stays within it there, which an x in two bf16 parts would not."""
    rng = np.random.default_rng(22 + bits)
    packed, table, scale = _random_pack(rng, 1000, 256, bits, torch.float32,
                                        cuda_device)
    levels = torch.from_numpy(rng.integers(-127, 128, size=1 << bits).astype(
        np.float32)).to(cuda_device)
    x = torch.from_numpy(rng.normal(size=(128, 1000)).astype(np.float32)
                         ).to(cuda_device)
    step = torch.tensor([4.5 / 127], device=cuda_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    for t, sc, against_plain in ((levels, step, True), (levels, scale, False),
                                 (table, scale, True)):
        assert bool((t.to(torch.bfloat16).float() != t).any()) == (t is table)
        y = tops.codr_matmul_cuda(x, packed, t, sc, bits=bits, n=256,
                                  impl="sm90")
        w = tref.decode_ref(packed, t, bits=bits, n=256).double()
        exact = (x.double() @ w) * sc.double()
        np.testing.assert_allclose(y.double().cpu().numpy(),
                                   exact.cpu().numpy(), **F32)
        if not against_plain:       # the control: x in two bf16 parts
            x2 = sum(_bf16_parts(x, 2)).double()
            assert _beyond((x2 @ w) * sc.double(), exact) > 0
        else:
            yr = tref.codr_matmul_ref(x, packed, t, sc, bits=bits, n=256)
            np.testing.assert_allclose(y.cpu().numpy(), yr.cpu().numpy(),
                                       **F32)


# (K, N) of the narrow projections the SSM models bring: xlstm-350m's
# if_proj, jamba-v0.1-52b's router, x_proj, dt_proj (K = 256) and
# in_proj, at published widths
NARROW_KN = [(2048, 8), (4096, 16), (8192, 288), (256, 8192),
             (4096, 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("kn", NARROW_KN, ids=lambda kn: f"{kn[0]}x{kn[1]}")
def test_kernel_takes_the_narrow_projection_shapes(kn, m, cuda_device):
    """The instance the routing rule gives the SSM models' narrow and
    K = 256 projections at decode (M = 4, ``splitk``) and prefill (M =
    128, ``sm90``), 4-bit packs of 16 levels: within the f32 tolerance
    of the plain version (N is a whole number of words but not of the
    column tiles)."""
    k, n = kn
    impl = tops.pick_impl(m, 4)
    rng = np.random.default_rng(k + n + m)
    q, s = _q(rng, k, n, 16)
    w = tcl.pack_unique(torch.from_numpy(q).to(cuda_device), s,
                        dtype=torch.float32)
    assert w.bits == 4 and tuple(w.packed.shape) == (k, n // 8)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
        cuda_device)
    args = (x, w.packed, w.table, w.scale.reshape(-1))
    before = tops.launches_by_impl[impl]
    y = tops.codr_matmul_cuda(*args, bits=4, n=n)
    torch.cuda.synchronize()
    assert tops.launches_by_impl[impl] == before + 1
    assert y.shape == (m, n)
    torch.backends.cuda.matmul.allow_tf32 = False
    yr = tref.codr_matmul_ref(*args, bits=4, n=n)
    np.testing.assert_allclose(y.cpu().numpy(), yr.cpu().numpy(), **F32)


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
