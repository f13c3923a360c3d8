"""The port's paged KV cache (``repro_torch.models.cache``) against the
JAX reference, mirroring ``tests/test_paged_kv.py``:

* unit level: bf16 pages round-trip bit for bit, int8 pages stay within
  two quantization steps, and the port's int8 write sequence produces
  the reference's bytes — the replayed golden write sequence of
  ``tools/regen_goldens.py`` equals ``tests/golden/paged_kv_int8.npz``
  byte for byte, and random sequences equal JAX's ``PagedKV.update``;
* batcher level, inside the port: bf16-paged == dense bit for bit, int8
  pooled == int8 solo bit for bit, int8 within 0.10 of the dense logit
  spread under teacher forcing, page exhaustion serializes;
* against JAX: the port's ``replay_logits`` within ``0.02 · max(|JAX|,
  1)`` of JAX's in every KV mode (the bound of
  ``tests/test_torch_serve.py``), and equal ``kv_bytes``.

The smoke variant of qwen2.5-3b, params made by JAX and carried over;
the MLA lane (``(ckv, krot)`` pages of features ``(kv_lora_rank,)`` and
``(rope_head_dim,)``) on the smoke variant of deepseek-v2-236b, whose
prologue layer pages as well as its stack (mirrors of
``tests/test_paged_kv.py``'s MLA cases).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.core.batching import ContinuousBatcher as JBatcher
from repro.models import cache as jcache
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.batching import ContinuousBatcher
from repro_torch.models import cache, get_model

ARCH = "qwen2.5-3b"
MLA = "deepseek-v2-236b"
GOLDEN = pathlib.Path(__file__).parent / "golden" / "paged_kv_int8.npz"
T = 120


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke(jget_config(ARCH))
    tcfg = smoke_variant(get_config(ARCH))
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def mla_setup():
    jcfg = jsmoke(jget_config(MLA))
    tcfg = smoke_variant(get_config(MLA))
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(n, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, size=n).astype(np.int32)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# PagedKV unit level
# ---------------------------------------------------------------------------

def _roundtrip(kv_dtype, page_size, seq_len, feat, rng, *, n_slots=2):
    spec = cache.PagedSpec(page_size=page_size,
                           max_len=-(-seq_len // page_size) * page_size,
                           n_slots=n_slots, kv_dtype=kv_dtype)
    pkv = cache.paged_kv_init(spec, feat, device="cpu")
    table = np.arange(1, 1 + n_slots * spec.max_pages,
                      dtype=np.int32).reshape(n_slots, spec.max_pages)
    cache.set_tables(pkv, table)
    dense = rng.normal(size=(n_slots, seq_len, *feat)).astype(np.float32)
    dense = _bf16(dense).to(torch.float32).numpy()
    for t in range(seq_len):
        pkv.update(_bf16(dense[:, t:t + 1]), t)
    got = pkv.gather()[:, :seq_len].to(torch.float32).numpy()
    return dense, got


def test_paged_bf16_roundtrip_bitwise(rng):
    dense, got = _roundtrip("bf16", 4, 10, (3, 5), rng)
    np.testing.assert_array_equal(got, dense)


def test_paged_int8_roundtrip_within_quant_floor(rng):
    dense, got = _roundtrip("int8", 4, 10, (3, 5), rng)
    err = np.abs(got - dense).max()
    assert err <= 2.0 * np.abs(dense).max() / 127.0
    assert err > 0                           # int8 is genuinely lossy


def test_paged_int8_tail_positions_zero():
    spec = cache.PagedSpec(page_size=4, max_len=8, n_slots=1,
                           kv_dtype="int8")
    pkv = cache.paged_kv_init(spec, (2,), device="cpu")
    cache.set_tables(pkv, np.asarray([[1, 2]], np.int32))
    pkv.update(torch.ones((1, 1, 2), dtype=torch.bfloat16), 0)
    g = pkv.gather().to(torch.float32).numpy()
    assert g.shape == (1, 8, 2)
    np.testing.assert_array_equal(g[:, 1:], 0.0)


def test_golden_int8_write_sequence_bytes():
    """``tools/regen_goldens.py::build_paged_kv_golden`` replayed in the
    port: the final page bytes, scales and table equal the golden."""
    golden = np.load(GOLDEN)
    spec = cache.PagedSpec(page_size=4, max_len=12, n_slots=2,
                           kv_dtype="int8")
    pkv = cache.paged_kv_init(spec, (2, 3), device="cpu")
    table = np.arange(1, 1 + 2 * spec.max_pages,
                      dtype=np.int32).reshape(2, spec.max_pages)
    cache.set_tables(pkv, table)
    rng = np.random.default_rng(21)
    for t in range(10):
        pkv.update(_bf16(rng.normal(size=(2, 1, 2, 3)).astype(np.float32)),
                   t)
    for name, got in (("data", pkv.data), ("scale", pkv.scale),
                      ("table", pkv.table)):
        want = golden[name]
        got = got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("page_size,seq_len,feat,per_row", [
    (4, 10, (3, 5), False), (3, 11, (2, 4), True), (8, 8, (1, 16), True),
    (1, 5, (4,), False)])
def test_int8_updates_match_reference_bytes(page_size, seq_len, feat,
                                            per_row):
    """Random write sequences (uniform or per-row positions, rows of
    growing and shrinking magnitude) give the reference's int8 bytes and
    scales exactly: f32 arithmetic, grow-only scale, half-to-even."""
    n_slots = 3
    rng = np.random.default_rng(page_size * 100 + seq_len)
    spec_kw = dict(page_size=page_size, n_slots=n_slots, kv_dtype="int8",
                   max_len=seq_len + 3)
    tspec, jspec = cache.PagedSpec(**spec_kw), jcache.PagedSpec(**spec_kw)
    table = (1 + rng.permutation(n_slots * tspec.max_pages)).astype(
        np.int32).reshape(n_slots, tspec.max_pages)
    tp = cache.paged_kv_init(tspec, feat, device="cpu")
    cache.set_tables(tp, table)
    jp = jcache.set_tables(jcache.paged_kv_init(jspec, feat),
                           jnp.asarray(table))
    start = rng.integers(0, 3, size=n_slots)
    for t in range(seq_len):
        row = (rng.normal(size=(n_slots, 1, *feat))
               * rng.choice([0.1, 1.0, 7.0])).astype(np.float32)
        row = _bf16(row).to(torch.float32).numpy()
        pos = (start + t) if per_row else np.full(n_slots, t)
        tp.update(_bf16(row), torch.from_numpy(pos.astype(np.int64)))
        jp = jp.update(jnp.asarray(row, jnp.bfloat16),
                       jnp.asarray(pos, jnp.int32))
    assert tp.data.numpy().tobytes() == np.asarray(jp.data).tobytes()
    assert tp.scale.numpy().tobytes() == np.asarray(jp.scale).tobytes()
    np.testing.assert_array_equal(
        tp.gather().to(torch.float32).numpy(),
        np.asarray(jp.gather(), np.float32))


def test_prefill_write_matches_reference(rng):
    """``write_slot_paged`` of a prefill cache over a previous tenant's
    bytes: the reference's pages, scales (reserved pages and scratch
    reset to 0) and table."""
    feat = (2, 3)
    kw = dict(page_size=4, max_len=16, n_slots=2, kv_dtype="int8")
    tspec, jspec = cache.PagedSpec(**kw), jcache.PagedSpec(**kw)
    stale = rng.integers(-127, 128, size=(tspec.total_pages, 4, *feat))
    stale_s = rng.random(tspec.total_pages).astype(np.float32)
    tp = cache.paged_kv_init(tspec, feat, device="cpu")
    tp.data.copy_(torch.from_numpy(stale.astype(np.int8)))
    tp.scale.copy_(torch.from_numpy(stale_s))
    jp = jcache.paged_kv_init(jspec, feat)
    jp = jcache.PagedKV(jnp.asarray(stale, jnp.int8), jnp.asarray(stale_s),
                        jp.table, jp.page_size, jp.seq_len, jp.quantized)
    dense = rng.normal(size=(1, 7, *feat)).astype(np.float32)
    pages = np.array([5, 2, 7, 0], np.int32)
    tpool = cache.write_slot_paged({"k": tp}, {"k": _bf16(dense)}, 1, pages)
    jpool = jcache.write_slot_paged({"k": jp}, {"k": jnp.asarray(
        dense, jnp.bfloat16)}, 1, pages)
    for name in ("data", "scale", "table"):
        assert getattr(tpool["k"], name).numpy().tobytes() == \
            np.asarray(getattr(jpool["k"], name)).tobytes(), name


def test_page_pool_all_or_nothing_and_free():
    spec = cache.PagedSpec(page_size=4, max_len=8, n_slots=2)
    pool = cache.PagePool(spec)
    assert pool.available == 4
    a, b = pool.alloc(2), pool.alloc(2)
    assert a is not None and b is not None
    assert cache.SCRATCH_PAGE not in a + b
    assert pool.alloc(1) is None
    assert pool.available == 0
    pool.free(a)
    assert pool.available == 2
    assert pool.alloc(2) is not None


def test_paged_spec_validation():
    with pytest.raises(ValueError):
        cache.PagedSpec(page_size=0, max_len=8, n_slots=1)
    with pytest.raises(ValueError):
        cache.PagedSpec(page_size=4, max_len=8, n_slots=1, kv_dtype="fp4")
    with pytest.raises(ValueError):
        cache.PagedSpec(page_size=4, max_len=16, n_slots=1,
                        n_pages=2).total_pages


# ---------------------------------------------------------------------------
# batcher level
# ---------------------------------------------------------------------------

def test_bf16_paged_bit_identical_to_dense(setup):
    *_, cfg, params = setup
    prompt = _prompt(6, cfg.vocab_size)
    dense = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              device="cpu")
    paged = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              kv_dtype="bf16", kv_page_size=4, device="cpu")
    ref_toks, _ = dense.generate_reference(prompt, max_new_tokens=6)
    got_toks, _ = paged.generate_reference(prompt, max_new_tokens=6)
    assert got_toks == ref_toks
    np.testing.assert_array_equal(paged.replay_logits(prompt, ref_toks),
                                  dense.replay_logits(prompt, ref_toks))
    prompts = [_prompt(4 + i, cfg.vocab_size, seed=i) for i in range(3)]
    with paged:
        hs = [paged.submit(p, max_new_tokens=5) for p in prompts]
        outs = [h.result(timeout=T) for h in hs]
    assert outs == [dense.generate_reference(p, max_new_tokens=5)[0]
                    for p in prompts]


def test_int8_paged_teacher_forced_within_bound(setup):
    *_, cfg, params = setup
    prompt = _prompt(6, cfg.vocab_size, seed=1)
    dense = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              device="cpu")
    paged = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              kv_dtype="int8", kv_page_size=4, device="cpu")
    ref_toks, _ = dense.generate_reference(prompt, max_new_tokens=6)
    ref_rows = dense.replay_logits(prompt, ref_toks)
    got_rows = paged.replay_logits(prompt, ref_toks)
    np.testing.assert_array_equal(got_rows[0], ref_rows[0])
    spread = float(ref_rows.max() - ref_rows.min())
    dev = float(np.abs(got_rows - ref_rows).max()) / spread
    assert dev < 0.10, dev


def test_mla_bf16_paged_bit_identical_to_dense(mla_setup):
    """MLA's ``(ckv, krot)`` pages in bf16 reproduce the dense cache:
    the same tokens and, teacher-forced, the same logits bits."""
    *_, cfg, params = mla_setup
    prompt = _prompt(6, cfg.vocab_size)
    dense = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              device="cpu")
    paged = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              kv_dtype="bf16", kv_page_size=4, device="cpu")
    pool = paged._pool
    for pkv in (*pool["prologue"][0], *pool["stack"]["b0"]):
        assert isinstance(pkv, cache.PagedKV)
    assert pool["prologue"][0][0].data.shape[-1] == cfg.kv_lora_rank
    assert pool["stack"]["b0"][1].data.shape[-1] == cfg.rope_head_dim
    ref_toks, _ = dense.generate_reference(prompt, max_new_tokens=6)
    got_toks, _ = paged.generate_reference(prompt, max_new_tokens=6)
    assert got_toks == ref_toks
    np.testing.assert_array_equal(paged.replay_logits(prompt, ref_toks),
                                  dense.replay_logits(prompt, ref_toks))


def test_mla_int8_paged_teacher_forced_within_bound(mla_setup):
    *_, cfg, params = mla_setup
    prompt = _prompt(6, cfg.vocab_size, seed=1)
    dense = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              device="cpu")
    paged = ContinuousBatcher(params, cfg, n_slots=2, max_len=32,
                              kv_dtype="int8", kv_page_size=4, device="cpu")
    ref_toks, _ = dense.generate_reference(prompt, max_new_tokens=6)
    ref_rows = dense.replay_logits(prompt, ref_toks)
    got_rows = paged.replay_logits(prompt, ref_toks)
    np.testing.assert_array_equal(got_rows[0], ref_rows[0])
    spread = float(ref_rows.max() - ref_rows.min())
    dev = float(np.abs(got_rows - ref_rows).max()) / spread
    assert dev < 0.10, dev


@pytest.mark.parametrize("mode", ["dense", "bf16-paged", "int8-paged"])
def test_mla_replay_logits_match_reference(mla_setup, mode):
    """The MLA pools against JAX's, as ``test_replay_logits_match_
    reference`` holds the GQA ones: within ``0.02 · max(|JAX|, 1)``, the
    same pool bytes."""
    jcfg, jparams, cfg, params = mla_setup
    kv = {"dense": {}, "bf16-paged": dict(kv_dtype="bf16", kv_page_size=4),
          "int8-paged": dict(kv_dtype="int8", kv_page_size=4)}[mode]
    prompt = _prompt(7, cfg.vocab_size, seed=3)
    toks, _ = JBatcher(jparams, jcfg, n_slots=2,
                       max_len=24).generate_reference(prompt,
                                                      max_new_tokens=6)
    jb = JBatcher(jparams, jcfg, n_slots=2, max_len=24, **kv)
    tb = ContinuousBatcher(params, cfg, n_slots=2, max_len=24,
                           device="cpu", **kv)
    j_rows = jb.replay_logits(prompt, toks)
    t_rows = tb.replay_logits(prompt, toks)
    bound = 0.02 * max(float(np.abs(j_rows).max()), 1.0)
    assert float(np.abs(t_rows - j_rows).max()) <= bound
    assert tb.kv_bytes() == jb.kv_bytes()


def test_int8_pooled_bit_identical_to_int8_solo(setup):
    *_, cfg, params = setup
    b = ContinuousBatcher(params, cfg, n_slots=3, max_len=32,
                          kv_dtype="int8", kv_page_size=4, device="cpu")
    prompts = [_prompt(4 + i, cfg.vocab_size, seed=i) for i in range(5)]
    with b:
        hs = [b.submit(p, max_new_tokens=5) for p in prompts]
        outs = [h.result(timeout=T) for h in hs]
    for p, s in zip(prompts, outs):
        ref, _ = b.generate_reference(p, max_new_tokens=5)
        assert s == ref


def test_live_tables_never_point_at_scratch(setup):
    """Inactive slots all write the scratch page in one step (in no
    defined order on the card); that is harmless only if no live slot
    reads page 0 at or below its position.  Checked at every pooled step
    of a run with retirements and re-admissions."""
    *_, cfg, params = setup
    b = ContinuousBatcher(params, cfg, n_slots=3, max_len=24,
                          kv_dtype="int8", kv_page_size=4, device="cpu")
    real, seen = b._step_fn, []

    def step(p, pool, toks, poss):
        for leaf in (pool["stack"]["b0"][0], pool["stack"]["b0"][1]):
            table = leaf.table[0].numpy()
            for i, pos in enumerate(poss):
                if pos > 0:                      # active: pos >= prompt len
                    assert (table[i, :pos // 4 + 1] != 0).all(), (i, table)
                else:
                    assert (table[i] == 0).all(), (i, table)
        seen.append(int((poss > 0).sum()))
        return real(p, pool, toks, poss)
    b._step_fn = step
    prompts = [_prompt(3 + i, cfg.vocab_size, seed=i) for i in range(6)]
    with b:
        hs = [b.submit(p, max_new_tokens=3 + 2 * (i % 3))
              for i, p in enumerate(prompts)]
        [h.result(timeout=T) for h in hs]
    assert max(seen) == 3 and min(seen) >= 1 and len(seen) > 6


def test_page_exhaustion_serializes_not_corrupts(setup):
    *_, cfg, params = setup
    b = ContinuousBatcher(params, cfg, n_slots=2, max_len=16,
                          kv_dtype="int8", kv_page_size=4, kv_pages=5,
                          device="cpu")
    prompts = [_prompt(5, cfg.vocab_size, seed=i) for i in range(2)]
    with b:
        hs = [b.submit(p, max_new_tokens=5) for p in prompts]
        outs = [h.result(timeout=T) for h in hs]
    assert b.peak_active == 1
    for p, s in zip(prompts, outs):
        ref, _ = b.generate_reference(p, max_new_tokens=5)
        assert s == ref


def test_paged_rejections(setup):
    *_, cfg, params = setup
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatcher(params, cfg, kv_dtype="fp8", device="cpu")
    api = get_model(cfg)
    spec = cache.PagedSpec(page_size=4, max_len=16, n_slots=2)
    with pytest.raises(ValueError, match="geometry"):
        api.init_cache(cfg, 3, 16, paged=spec, device="cpu")


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------

MODES = {"dense": {}, "bf16-paged": dict(kv_dtype="bf16", kv_page_size=4),
         "int8-paged": dict(kv_dtype="int8", kv_page_size=4)}


@pytest.mark.parametrize("mode", list(MODES))
def test_replay_logits_match_reference(setup, mode):
    """Teacher-forced through the same tokens (JAX's dense reference
    generation), the port's logits are within ``0.02 · max(|JAX|, 1)``
    of JAX's in each KV mode, and the pools hold the same bytes."""
    jcfg, jparams, cfg, params = setup
    prompt = _prompt(7, cfg.vocab_size, seed=3)
    jdense = JBatcher(jparams, jcfg, n_slots=2, max_len=24)
    toks, _ = jdense.generate_reference(prompt, max_new_tokens=6)
    jb = JBatcher(jparams, jcfg, n_slots=2, max_len=24, **MODES[mode])
    tb = ContinuousBatcher(params, cfg, n_slots=2, max_len=24,
                           device="cpu", **MODES[mode])
    j_rows = jb.replay_logits(prompt, toks)
    t_rows = tb.replay_logits(prompt, toks)
    assert t_rows.shape == j_rows.shape == (6, cfg.vocab_size)
    bound = 0.02 * max(float(np.abs(j_rows).max()), 1.0)
    assert float(np.abs(t_rows - j_rows).max()) <= bound
    assert tb.kv_bytes() == jb.kv_bytes()
