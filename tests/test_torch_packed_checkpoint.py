"""The port's packed checkpoint artifact (``repro_torch.checkpoint
.packed``) on the CPU, mirroring ``tests/test_packed_checkpoint.py``
(the qwen2.5-3b half; the seamless-m4t-medium half is in
``tests/test_torch_encdec.py``) and held against the JAX package:

* the port's ``build_manifest`` on the golden's params reproduces
  ``tests/golden/packed_checkpoint.npz`` byte for byte — the manifest
  and every ``arr_N``;
* an artifact JAX ``save_packed`` wrote boots in the port, and one the
  port wrote boots in JAX: the same packed bytes both ways, the port's
  logits bit-identical to its own compile and within one bf16 step
  (rtol / atol 2e-2, the bound ``tests/test_torch_models.py`` states
  for bfloat16 activations) of JAX's;
* an artifact carrying a ``TunePlan`` boots across the packages both
  ways with the plan's JSON and the logits bits of the booting
  package's own compile under that plan.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as jcodr
import repro_torch.api as codr
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.checkpoint.packed import build_manifest
from repro_torch.configs import get_config, smoke_variant
from repro_torch.models import get_model

N_UNIQUE = 16
BF16 = dict(rtol=2e-2, atol=2e-2)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "packed_checkpoint.npz")


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX api, JAX params, port cfg, port api, port params)."""
    jcfg = jsmoke(jget_config("qwen2.5-3b"))
    japi = jget_model(jcfg)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = smoke_variant(get_config("qwen2.5-3b"))
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, japi, jparams, tcfg, get_model(tcfg), tparams


@pytest.fixture(scope="module")
def compiled(model):
    *_, tcfg, tapi, tparams = model
    return tcfg, tapi, codr.compile_params(
        tparams, codr.EncodeConfig(n_unique=N_UNIQUE),
        backend="codr_matmul", device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(4).integers(0, 256, (2, 6))


def _logits(api, params, cfg, tokens) -> np.ndarray:
    lg, _ = api.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    return lg.to(torch.float32).numpy()


def _saved(compiled, tmp_path) -> str:
    path = str(tmp_path / "ck.codr")
    codr.save_packed(compiled[2], path)
    return path


def _words(leaf) -> list[np.ndarray]:
    w = leaf.weight
    return [np.asarray(w.packed.numpy() if isinstance(w.packed, torch.Tensor)
                       else w.packed).view(np.uint32),
            np.asarray(w.table, np.float32), np.asarray(w.scale, np.float32)]


# ---------------------------------------------------------------------------
# the reference's tests
# ---------------------------------------------------------------------------

def test_roundtrip_bit_identical_logits(compiled, tokens, tmp_path):
    cfg, api, cp = compiled
    ref = _logits(api, cp.params, cfg, tokens)
    path = str(tmp_path / "ck.codr")
    assert codr.save_packed(cp, path) == path
    cp2 = codr.load_packed(path, device="cpu")
    np.testing.assert_array_equal(ref, _logits(api, cp2.params, cfg, tokens))
    assert cp2.config == cp.config
    assert cp2.backend == cp.backend
    assert cp2.packed_paths == cp.packed_paths
    assert cp2.quantized_paths == cp.quantized_paths
    assert cp2.embed_paths == cp.embed_paths
    assert cp2.reports == cp.reports
    assert cp2.hbm_bytes() == cp.hbm_bytes()
    for (pa, a), (pb, b) in zip(cp.packed_leaves(), cp2.packed_leaves()):
        assert pa == pb and a.weight.bits == b.weight.bits
        for x, y in zip((a.weight.packed, a.weight.table, a.weight.scale),
                        (b.weight.packed, b.weight.table, b.weight.scale)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_deepseek_roundtrip_bit_identical_logits(tmp_path):
    """The MLA + MoE tree (the prologue list, the stacked expert packs,
    the router, the shared experts) through ``save_packed`` /
    ``load_packed``: the same packs and the same logits bits, prefill
    and two decode steps."""
    cfg = smoke_variant(get_config("deepseek-v2-236b"))
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    cp = codr.compile_params(params, codr.EncodeConfig(n_unique=N_UNIQUE),
                             backend="codr_matmul", accounting=False,
                             min_size=256, device="cpu")
    assert "stack/b0/mlp/router" in cp.packed_paths
    assert any(p.startswith("prologue/0/") for p in cp.packed_paths)
    path = str(tmp_path / "deepseek.codr")
    codr.save_packed(cp, path)
    cp2 = codr.load_packed(path, device="cpu")
    assert isinstance(cp2.params["prologue"], list)
    assert cp2.packed_paths == cp.packed_paths
    for (pa, a), (pb, b) in zip(cp.packed_leaves(), cp2.packed_leaves()):
        assert pa == pb and a.weight.bits == b.weight.bits
        for x, y in zip((a.weight.packed, a.weight.table, a.weight.scale),
                        (b.weight.packed, b.weight.table, b.weight.scale)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 6)))
    assert torch.equal(api.prefill(cp.params, {"tokens": tokens}, cfg)[0],
                       api.prefill(cp2.params, {"tokens": tokens}, cfg)[0])
    caches = [api.init_cache(cfg, 2, 4, device="cpu") for _ in range(2)]
    for i in range(2):
        a, caches[0] = api.decode_step(cp.params, caches[0], tokens[:, i], i,
                                       cfg)
        b, caches[1] = api.decode_step(cp2.params, caches[1], tokens[:, i],
                                       i, cfg)
        assert torch.equal(a, b)


def test_atomic_overwrite(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    codr.save_packed(compiled[2], path)        # overwrite is clean
    assert not os.path.exists(path + ".tmp")   # no stale staging dir
    codr.load_packed(path, device="cpu")


def test_missing_artifact_raises(tmp_path):
    with pytest.raises(codr.PackedCheckpointError, match="manifest"):
        codr.load_packed(str(tmp_path / "nope.codr"), device="cpu")


def test_version_mismatch_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    m = json.load(open(os.path.join(path, "manifest.json")))
    m["format_version"] = codr.CODR_FORMAT_VERSION + 1
    json.dump(m, open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(codr.PackedCheckpointError, match="format version"):
        codr.load_packed(path, device="cpu")


def test_truncated_array_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    apath = os.path.join(path, "arr_0.npy")
    blob = open(apath, "rb").read()
    open(apath, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(codr.PackedCheckpointError):
        codr.load_packed(path, device="cpu")


def test_missing_array_file_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    os.remove(os.path.join(path, "arr_1.npy"))
    with pytest.raises(codr.PackedCheckpointError, match="missing array"):
        codr.load_packed(path, device="cpu")


def test_wrong_dtype_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    a = np.load(os.path.join(path, "arr_0.npy"))
    np.save(os.path.join(path, "arr_0.npy"), a.astype(np.float64))
    with pytest.raises(codr.PackedCheckpointError, match="dtype"):
        codr.load_packed(path, device="cpu")


def test_wrong_shape_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    a = np.load(os.path.join(path, "arr_0.npy"))
    np.save(os.path.join(path, "arr_0.npy"), a.reshape(-1))
    with pytest.raises(codr.PackedCheckpointError, match="shape"):
        codr.load_packed(path, device="cpu")


def test_bad_magic_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    m = json.load(open(os.path.join(path, "manifest.json")))
    m["magic"] = "not-a-codr-checkpoint"
    json.dump(m, open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(codr.PackedCheckpointError, match="magic"):
        codr.load_packed(path, device="cpu")


def test_corrupt_manifest_json_raises(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    mpath = os.path.join(path, "manifest.json")
    blob = open(mpath).read()
    open(mpath, "w").write(blob[:len(blob) // 2])
    with pytest.raises(codr.PackedCheckpointError, match="JSON"):
        codr.load_packed(path, device="cpu")


def test_mmap_false_loads_materialized(compiled, tokens, tmp_path):
    cfg, api, cp = compiled
    ref = _logits(api, cp.params, cfg, tokens)
    path = _saved(compiled, tmp_path)
    cp2 = codr.load_packed(path, mmap=False, device="cpu")
    np.testing.assert_array_equal(ref, _logits(api, cp2.params, cfg, tokens))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_build_manifest_reproduces_the_golden_bytes():
    """``tools/regen_goldens.py::build_checkpoint_golden``'s params
    through the port: the manifest JSON and every array, byte for
    byte."""
    rng = np.random.default_rng(3)
    params = {
        "blk": {"q_proj": (rng.normal(size=(16, 12)) * 0.1
                           ).astype(np.float32)},
        "embed": (rng.normal(size=(24, 8)) * 0.1).astype(np.float32),
        "norm": np.ones((12,), np.float32),
    }
    cp = codr.compile_params(convert.params_from_reference(params, "cpu"),
                             codr.EncodeConfig(n_unique=16), min_size=0,
                             sample_rows=None, device="cpu")
    manifest, arrays = build_manifest(cp)
    golden = np.load(GOLDEN)
    assert json.dumps(manifest, indent=1).encode() == \
        golden["manifest"].tobytes()
    assert len(arrays) == len(golden.files) - 1
    for i, a in enumerate(arrays):
        g = golden[f"arr_{i}"]
        assert a.dtype == g.dtype and a.shape == g.shape, i
        assert a.tobytes() == g.tobytes(), i


def test_bf16_leaves_are_stored_as_uint16_bits(tmp_path):
    """A bfloat16 dense leaf: ``uint16`` on disk with the manifest saying
    ``bfloat16`` (as the reference writes it), back bit for bit."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(16, 12)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(12,)).astype(np.float32)
                            ).to(torch.bfloat16)
    cp = codr.compile_params({"q_proj": q, "q_bias": bias},
                             codr.EncodeConfig(n_unique=16), min_size=0,
                             sample_rows=None, device="cpu")
    path = str(tmp_path / "bf16.codr")
    codr.save_packed(cp, path)
    m = json.load(open(os.path.join(path, "manifest.json")))
    ref = m["tree"]["items"]["q_bias"]["ref"]
    assert m["arrays"][ref]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, f"arr_{ref}.npy")).dtype == np.uint16
    back = codr.load_packed(path, device="cpu").params["q_bias"]
    assert back.dtype == torch.bfloat16 and torch.equal(back, bias)
    # and JAX reads the same bits
    jback = np.asarray(jcodr.load_packed(path).params["q_bias"])
    np.testing.assert_array_equal(jback.view(np.uint16),
                                  bias.view(torch.int16).numpy().view(
                                      np.uint16))


def test_jax_artifact_boots_in_the_port(model, compiled, tokens, tmp_path):
    jcfg, japi, jparams, tcfg, tapi, _ = model
    jcp = jcodr.compile_params(jparams, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul")
    path = str(tmp_path / "jax.codr")
    jcodr.save_packed(jcp, path)
    cp = codr.load_packed(path, device="cpu")
    own = compiled[2]
    assert cp.packed_paths == own.packed_paths == list(jcp.packed_paths)
    assert cp.embed_paths == own.embed_paths
    assert cp.reports == own.reports
    assert cp.config == own.config
    for (_, a), (_, b) in zip(cp.packed_leaves(), own.packed_leaves()):
        for x, y in zip(_words(a), _words(b)):
            assert x.tobytes() == y.tobytes()
    got = _logits(tapi, cp.params, tcfg, tokens)
    np.testing.assert_array_equal(got, _logits(tapi, own.params, tcfg,
                                               tokens))
    want, _ = japi.prefill(jcp.params, {"tokens": jnp.asarray(tokens)}, jcfg)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **BF16)


def test_port_artifact_boots_in_jax(model, compiled, tokens, tmp_path):
    jcfg, japi, jparams, tcfg, tapi, _ = model
    path = _saved(compiled, tmp_path)
    jcp = jcodr.load_packed(path)
    own = jcodr.compile_params(jparams, jcodr.EncodeConfig(n_unique=N_UNIQUE),
                               backend="codr_matmul")
    assert list(jcp.packed_paths) == list(own.packed_paths)
    assert jcp.reports == own.reports
    leaves = [leaf for leaf in jax.tree_util.tree_leaves(
        jcp.params, is_leaf=lambda x: hasattr(x, "weight"))
        if hasattr(leaf, "weight")]
    mine = [leaf for _, leaf in compiled[2].packed_leaves()]
    assert len(leaves) == len(mine)
    for a, b in zip(leaves, mine):
        assert np.asarray(a.weight.packed).dtype == np.uint32
        for x, y in zip(_words(a), _words(b)):
            assert x.tobytes() == y.tobytes()
    got, _ = japi.prefill(jcp.params, {"tokens": jnp.asarray(tokens)}, jcfg)
    want, _ = japi.prefill(own.params, {"tokens": jnp.asarray(tokens)}, jcfg)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(want, np.float32))
    np.testing.assert_allclose(_logits(tapi, compiled[2].params, tcfg,
                                       tokens),
                               np.asarray(got, np.float32), **BF16)


def test_roundtrip_preserves_plan(model, tmp_path):
    from repro_torch.tune import TunePlan
    *_, tparams = model
    plan = TunePlan({}, default=codr.EncodeConfig(n_unique=N_UNIQUE))
    cp = codr.compile_params(tparams, codr.EncodeConfig(n_unique=N_UNIQUE),
                             plan=plan, device="cpu")
    path = str(tmp_path / "ck.codr")
    codr.save_packed(cp, path)
    cp2 = codr.load_packed(path, device="cpu")
    assert cp2.plan is not None
    assert cp2.plan.to_json() == plan.to_json()


def test_dict_plan_cannot_be_saved(model, tmp_path):
    """A ``{path: EncodeConfig}`` plan has no serialized form: TypeError
    before anything is written (the reference fails there with an
    AttributeError)."""
    *_, tparams = model
    cp = codr.compile_params(tparams, codr.EncodeConfig(n_unique=N_UNIQUE),
                             accounting=False, device="cpu",
                             plan={"embed": codr.EncodeConfig(n_unique=8)})
    with pytest.raises(TypeError, match="cannot be serialized"):
        codr.save_packed(cp, str(tmp_path / "never.codr"))
    assert not os.path.exists(str(tmp_path / "never.codr.tmp"))
    assert not os.path.exists(str(tmp_path / "never.codr"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_tuned_artifact_boots_across_packages(model, tokens, tmp_path,
                                              direction):
    """A ``tune_params`` plan mixing U = 16 and 32 (4- and 8-bit packs):
    the artifact one package writes boots in the other with the plan's
    JSON, the same packed bytes, and the logits bits of the booting
    package's own compile under the same plan."""
    from repro import tune as jtune
    from repro_torch import tune
    jcfg, japi, jparams, tcfg, tapi, tparams = model
    kw = dict(n_uniques=(4, 8, 16, 32))
    jplan = jtune.tune_params(jparams, budget=jtune.TuneBudget(
        max_rel_err=0.15), **kw)
    tplan = tune.tune_params(tparams, budget=tune.TuneBudget(
        max_rel_err=0.15), **kw)
    assert {p: lp.config.n_unique for p, lp in tplan.layers.items()} == \
        {p: lp.config.n_unique for p, lp in jplan.layers.items()}
    assert len({lp.config.n_unique for lp in tplan.layers.values()}) == 2
    tcp = codr.compile_params(tparams, codr.EncodeConfig(n_unique=N_UNIQUE),
                              plan=tplan, backend="codr_matmul", device="cpu")
    jcp = jcodr.compile_params(jparams, jcodr.EncodeConfig(
        n_unique=N_UNIQUE), plan=jplan, backend="codr_matmul")
    path = str(tmp_path / "tuned.codr")
    if direction == "jax_to_port":
        jcodr.save_packed(jcp, path)
        cp = codr.load_packed(path, device="cpu")
        assert cp.plan.to_json() == jplan.to_json()
        assert cp.packed_paths == tcp.packed_paths
        for (_, a), (_, b) in zip(cp.packed_leaves(), tcp.packed_leaves()):
            assert a.weight.bits == b.weight.bits
            for x, y in zip(_words(a), _words(b)):
                assert x.tobytes() == y.tobytes()
        np.testing.assert_array_equal(_logits(tapi, cp.params, tcfg, tokens),
                                      _logits(tapi, tcp.params, tcfg, tokens))
    else:
        codr.save_packed(tcp, path)
        cp = jcodr.load_packed(path)
        assert cp.plan.to_json() == tplan.to_json()
        assert list(cp.packed_paths) == list(jcp.packed_paths)
        got, _ = japi.prefill(cp.params, {"tokens": jnp.asarray(tokens)},
                              jcfg)
        want, _ = japi.prefill(jcp.params, {"tokens": jnp.asarray(tokens)},
                               jcfg)
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))
    assert {leaf.weight.bits for p, leaf in tcp.packed_leaves()
            if p in tplan.layers} == {4, 8}


def test_load_defaults_to_the_card(compiled, tmp_path):
    path = _saved(compiled, tmp_path)
    if torch.cuda.is_available():      # with a card it loads there
        cp = codr.load_packed(path)
        assert cp.packed_leaves()[0][1].weight.packed.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        codr.load_packed(path)
