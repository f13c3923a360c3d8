"""The port's unique-index packs (``repro_torch.core.codr_linear``) and
serving accounting (``repro_torch.core.serving`` and the UCNN/SCNN
baselines) against the JAX reference.

Packs are bytes: every comparison of words, tables, scales and
accounting here is exact.  Inputs come from NumPy with fixed seeds.
"""
import numpy as np
import pytest
import torch

from repro.core import codr_linear as jcl
from repro.core import serving as jserving
from repro.core import ucr as jucr
from repro.core.baselines import scnn_compress_bits as j_scnn
from repro.core.baselines import ucnn_compress_bits as j_ucnn
from repro_torch.core import codr_linear as tcl
from repro_torch.core import serving as tserving
from repro_torch.core import ucr as tucr
from repro_torch.core.baselines import scnn_compress_bits as t_scnn
from repro_torch.core.baselines import ucnn_compress_bits as t_ucnn

GOLDEN = "tests/golden/packed_weight.npz"


def _bits(a) -> np.ndarray:
    """Bit pattern of a JAX array or torch tensor (uint32 words, uint16
    for bfloat16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    a = np.asarray(a)
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _assert_weight_equal(tw: tcl.PackedWeight, jw) -> None:
    assert tw.bits == jw.bits and tuple(tw.shape) == tuple(jw.shape)
    assert tw.packed.dtype == torch.int32
    np.testing.assert_array_equal(_bits(tw.packed), _bits(jw.packed))
    np.testing.assert_array_equal(_bits(tw.table), _bits(jw.table))
    np.testing.assert_array_equal(_bits(tw.scale), _bits(jw.scale))
    assert tw.hbm_bytes == jw.hbm_bytes
    assert tw.dense_bf16_bytes == jw.dense_bf16_bytes


# ---------------------------------------------------------------------------
# packing: bytes equal to the reference
# ---------------------------------------------------------------------------

# (K, N) needs no padding at 4 bits; 37 and 12 pad the output features to
# a whole word; the 3-D and 4-D leaves carry stack axes
PACK_SHAPES = [(24, 40), (3, 16, 37), (2, 2, 8, 12), (1, 64, 128)]


@pytest.mark.parametrize("shape", PACK_SHAPES)
@pytest.mark.parametrize("n_unique", [2, 4, 16, 256])
def test_pack_projection_bytes_equal_reference(shape, n_unique):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    j = jcl.pack_projection(w, n_unique=n_unique)
    t = tcl.pack_projection(w, n_unique=n_unique)
    _assert_weight_equal(t.weight, j.weight)
    assert t.out_features == j.out_features and t.backend == j.backend
    assert t.n_weights == j.n_weights and t.hbm_bytes == j.hbm_bytes
    # the tensor path (a leaf already in torch) packs the same bytes
    tt = tcl.pack_projection(torch.from_numpy(w), n_unique=n_unique)
    np.testing.assert_array_equal(_bits(tt.weight.packed), _bits(j.weight.packed))


@pytest.mark.parametrize("shape", [(50, 20), (40, 64)])
@pytest.mark.parametrize("n_unique", [4, 16, 256])
def test_pack_embedding_bytes_equal_reference(shape, n_unique):
    w = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    j = jcl.pack_embedding(w, n_unique=n_unique)
    t = tcl.pack_embedding(w, n_unique=n_unique)
    _assert_weight_equal(t.weight, j.weight)
    assert (t.d_model, t.vocab_size, t.n_weights) == \
        (j.d_model, j.vocab_size, j.n_weights)
    tokens = np.array([[0, 3, 7], [shape[0] - 1, 1, 3]])
    np.testing.assert_array_equal(
        t.lookup(torch.from_numpy(tokens)).numpy(),
        np.asarray(j.lookup(tokens)))
    np.testing.assert_array_equal(t.dense().numpy(), np.asarray(j.dense()))


@pytest.mark.parametrize("n_unique", [2, 4, 16, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unique_bytes_equal_reference(n_unique, dtype):
    import jax.numpy as jnp
    w = np.random.default_rng(3).normal(size=(32, 64)).astype(np.float32)
    q, s = jucr.quantize_int8(w)
    q = jucr.restrict_unique(q, n_unique)
    j = jcl.pack_unique(q, s, dtype=getattr(jnp, dtype))
    t = tcl.pack_unique(q, s, dtype=getattr(torch, dtype))
    _assert_weight_equal(t, j)


def test_pack_unique_rejects_a_ragged_word():
    q = np.ones((4, 6), np.int8)
    q[0, 0] = 2                                  # 2 levels → 1 bit, 32/word
    with pytest.raises(ValueError, match="not divisible"):
        tcl.pack_unique(q, 1.0)


def test_packed_weight_golden_bytes():
    """The port's build of ``tests/golden/packed_weight.npz`` (the builder
    in ``tools/regen_goldens.py``) equals the frozen file."""
    gold = np.load(GOLDEN)
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(12, 10)) * 0.2).astype(np.float32)
    pl = tcl.pack_projection(w, n_unique=16)
    np.testing.assert_array_equal(_bits(pl.weight.packed), gold["packed"])
    np.testing.assert_array_equal(pl.weight.table.numpy(), gold["table"])
    np.testing.assert_array_equal(pl.weight.scale.numpy(), gold["scale"])
    np.testing.assert_array_equal(
        np.array([pl.weight.bits, *pl.weight.shape, pl.out_features]),
        gold["meta"])


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
def test_unpack_unique_equals_reference(bits):
    import jax.numpy as jnp
    rng = np.random.default_rng(bits)
    k, words = 6, 3
    packed = rng.integers(0, 1 << 32, size=(k, words), dtype=np.uint64
                          ).astype(np.uint32)
    packed[0, 0] = 0xFFFFFFFF                     # every field at its max
    packed[1, 0] = 0x80000000                     # only the top bit
    table = rng.normal(size=1 << bits).astype(np.float32)
    n = words * (32 // bits)
    j = jcl.unpack_unique(jnp.asarray(packed), jnp.asarray(table), bits=bits,
                          n=n)
    t = tcl.unpack_unique(torch.from_numpy(packed.view(np.int32)),
                          torch.from_numpy(table), bits=bits, n=n)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_stacked_dense_and_slices_equal_reference():
    w = np.random.default_rng(4).normal(size=(3, 16, 37)).astype(np.float32)
    j = jcl.pack_projection(w, n_unique=16)
    t = tcl.pack_projection(w, n_unique=16)
    np.testing.assert_array_equal(t.dense().numpy(), np.asarray(j.dense()))
    for i in range(3):
        ti = t[i]
        assert ti.weight.packed.dim() == 2 and ti.out_features == 37
        np.testing.assert_array_equal(ti.dense().numpy(),
                                      np.asarray(j.dense())[i])
    with pytest.raises(ValueError, match="not a stacked pack"):
        t[0][0]
    # decode-then-matmul reference of one slice
    x = np.random.default_rng(5).normal(size=(4, 16)).astype(np.float32)
    j0 = jcl.PackedWeight(j.weight.packed[0], j.weight.table[0],
                          j.weight.scale[0], j.weight.bits, j.weight.shape)
    np.testing.assert_allclose(
        tcl.codr_matmul_ref(torch.from_numpy(x), t.weight[0]).numpy(),
        np.asarray(jcl.codr_matmul_ref(x, j0)), rtol=1e-6, atol=1e-6)


def test_dense_weight_passes_tensors_through():
    w = torch.ones(3, 4)
    assert tcl.dense_weight(w) is w
    pl = tcl.pack_projection(np.eye(8, dtype=np.float32), n_unique=16)
    d = tcl.dense_weight(pl, torch.bfloat16)
    assert d.dtype == torch.bfloat16 and d.shape == (8, 8)


@pytest.mark.parametrize("n_unique", [3, 16, 256])
@pytest.mark.parametrize("kind", ["normal", "zeros", "ties"])
def test_quantize_restrict_equals_numpy_codec(n_unique, kind):
    rng = np.random.default_rng(6)
    w = rng.normal(size=(40, 33)).astype(np.float32)
    if kind == "zeros":
        w[:] = 0                                  # amax 0 → scale 1
    elif kind == "ties":                          # exact .5 quotients
        w = (rng.integers(-254, 255, size=w.shape) / 2).astype(np.float32)
        w[0, 0] = 127.0
    q, s, present = tcl.quantize_restrict(torch.from_numpy(w), n_unique)
    jq, js = jucr.quantize_int8(w)
    jq = jucr.restrict_unique(jq, n_unique)
    np.testing.assert_array_equal(q.numpy(), jq)
    assert s.dtype == torch.float32 and float(s) == float(js)
    np.testing.assert_array_equal(np.nonzero(present.numpy())[0] - 128,
                                  np.unique(jq))
    # the port's NumPy codec agrees too, and its new dequantize_int8
    tq, ts = tucr.quantize_int8(w)
    np.testing.assert_array_equal(tucr.restrict_unique(tq, n_unique), jq)
    np.testing.assert_array_equal(tucr.dequantize_int8(jq, ts),
                                  jucr.dequantize_int8(jq, js))


# ---------------------------------------------------------------------------
# serving accounting: equal to the reference's
# ---------------------------------------------------------------------------

def test_baselines_equal_reference():
    rng = np.random.default_rng(8)
    q = rng.integers(-20, 21, size=(64, 48)).astype(np.int8)
    q[rng.random(q.shape) < 0.6] = 0
    jvecs = [jucr.ucr_transform(q[:, i]) for i in range(q.shape[1])]
    tvecs = [tucr.ucr_transform(q[:, i]) for i in range(q.shape[1])]
    assert t_ucnn(tvecs) == j_ucnn(jvecs)
    assert t_scnn(q) == j_scnn(q)
    assert t_scnn(np.zeros(40, np.int8)) == j_scnn(np.zeros(40, np.int8))


@pytest.mark.parametrize("n_unique", [4, 16, 256])
@pytest.mark.parametrize("sample_rows", [None, 32])
def test_account_tensor_equals_reference(n_unique, sample_rows):
    w = np.random.default_rng(9).normal(size=(96, 40)).astype(np.float32)
    assert tserving.account_tensor(w, n_unique=n_unique,
                                   sample_rows=sample_rows) == \
        jserving.account_tensor(w, n_unique=n_unique,
                                sample_rows=sample_rows)
    td, tr = tserving.compress_tensor(w, n_unique=n_unique)
    jd, jr = jserving.compress_tensor(w, n_unique=n_unique)
    np.testing.assert_array_equal(td, jd)
    assert tr == jr


def test_codr_compress_params_equals_reference():
    import jax
    rng = np.random.default_rng(10)
    tree = {"embed": rng.normal(size=(64, 32)).astype(np.float32),
            "stack": {"b0": {"mixer": {
                "q_proj": rng.normal(size=(2, 32, 48)).astype(np.float32),
                "q_bias": rng.normal(size=(2, 48)).astype(np.float32)}}},
            "final_norm": {"w": np.ones(32, np.float32)}}
    jp, jrep = jserving.codr_compress_params(
        jax.tree.map(jax.numpy.asarray, tree), n_unique=16, sample_rows=16)
    tp, trep = tserving.codr_compress_params(
        {"embed": torch.from_numpy(tree["embed"]),
         "stack": {"b0": {"mixer": {
             k: torch.from_numpy(v)
             for k, v in tree["stack"]["b0"]["mixer"].items()}}},
         "final_norm": {"w": torch.from_numpy(tree["final_norm"]["w"])}},
        n_unique=16, sample_rows=16)
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    for k in ("q_proj", "q_bias"):
        np.testing.assert_array_equal(
            tp["stack"]["b0"]["mixer"][k].numpy(),
            np.asarray(jp["stack"]["b0"]["mixer"][k]))
    assert tp["final_norm"]["w"] is not None
    assert [vars(r) for r in trep] == [vars(r) for r in jrep]
    assert tserving.codr_report(trep, per_tensor=True) == \
        jserving.codr_report(jrep, per_tensor=True)


def test_codr_serving_stats_equals_reference():
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    w = np.random.default_rng(11).normal(size=(64, 32)).astype(np.float32)
    rep = jserving.account_tensor(w, n_unique=16, sample_rows=None)
    jr = [jserving.TensorReport(path="w", n_weights=w.size, **rep)]
    tr = [tserving.TensorReport(path="w", n_weights=w.size, **rep)]
    for kw in ({}, {"n_unique": 4}):
        assert tserving.codr_serving_stats(tget("qwen2.5-3b"), **kw) == \
            jserving.codr_serving_stats(jget("qwen2.5-3b"), **kw)
    assert tserving.codr_serving_stats(tget("qwen2.5-3b"), reports=tr) == \
        jserving.codr_serving_stats(jget("qwen2.5-3b"), reports=jr)
