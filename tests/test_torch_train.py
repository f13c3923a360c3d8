"""The port's training path on the CPU (``repro_torch.optim``,
``repro_torch.data``, the models' ``mode="train"`` and ``train_loss``,
``repro_torch.runtime.loop`` and ``repro_torch.launch.train``), mirroring
``tests/test_optim.py``, ``tests/test_data.py`` and the ``TrainLoop``
half of ``tests/test_runtime.py``, and held against ``repro``.

Tolerances:

* data batches: bit for bit (both packages draw with NumPy);
* AdamW and the schedule on the same trees: within rtol 1e-6 /
  atol 1e-7 (float32 arithmetic, the same operations in the same order;
  ``pow`` may differ in its last bit);
* ``train_loss`` and its gradients, all ten architectures at smoke size
  from the reference's params: in float32 activations (both packages'
  ``DEFAULT_DTYPE`` swapped, as the reference's tests do) the loss
  within 1e-5 · max(|loss|, 1) and each gradient leaf within
  1e-4 · max(|reference leaf|); in bfloat16 the loss within
  2e-3 · max(|loss|, 1) only — bf16 rounding moves single gradient
  entries by several percent in both packages, and a near tie flips the
  top-k routing of the MoE models;
* one train step (``make_train_step``: autograd, the cosine schedule,
  clip and AdamW) against the reference's jitted step, without and with
  the bf16 gradient cast: in float32 the loss and the grad norm within
  rtol 1e-5, the params after the step within atol 1e-2 · lr; in
  bfloat16 the loss and grad norm within rtol 1e-3;
* the port's crash-and-resume: the resumed losses equal the
  uninterrupted run's bit for bit (a CPU step is deterministic and the
  checkpoint stores float32 bits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as jencdec
import repro.models.lm as jlm
import repro_torch.models.encdec as tencdec
import repro_torch.models.lm as tlm
from repro import optim as joptim
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import smoke_variant as jsmoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokenDataset as JDataset
from repro.data import host_batch_iterator as jbatches
from repro.models import get_model as jget_model
from repro.runtime import loop as jloop
from repro_torch import convert, optim
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.core.tree import leaves, leaves_with_path, map_leaves
from repro_torch.data import DataConfig, SyntheticTokenDataset
from repro_torch.data import host_batch_iterator
from repro_torch.launch import train as tlaunch
from repro_torch.models import get_model
from repro_torch.runtime import TrainLoop, TrainLoopConfig
from repro_torch.runtime.loop import make_train_step

F32_LOSS, F32_GRAD, BF16_LOSS = 1e-5, 1e-4, 2e-3


def _np(t):
    return t.detach().to(torch.float32).numpy()


class _activations:
    """Both packages' model activations in ``dtype`` for the block."""

    def __init__(self, f32: bool):
        self.f32 = f32

    def __enter__(self):
        mods = (tlm, tencdec, jlm, jencdec)
        self.saved = [m.DEFAULT_DTYPE for m in mods]
        if self.f32:
            tlm.DEFAULT_DTYPE = tencdec.DEFAULT_DTYPE = torch.float32
            jlm.DEFAULT_DTYPE = jencdec.DEFAULT_DTYPE = jnp.float32
        return self

    def __exit__(self, *exc):
        for m, d in zip((tlm, tencdec, jlm, jencdec), self.saved):
            m.DEFAULT_DTYPE = d


def _models(arch):
    jcfg, tcfg = jsmoke(jget_config(arch)), smoke_variant(get_config(arch))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _data_cfg(cfg, seq, batch, cls=DataConfig):
    return cls(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
               frontend=cfg.frontend
               or ("audio" if cfg.family == "encdec" else None),
               frontend_seq=cfg.frontend_seq or seq, d_model=cfg.d_model)


def _on_cpu(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _quad_setup(use_master):
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, use_master=use_master)
    params = {"w": torch.ones(4, dtype=torch.bfloat16 if use_master
                              else torch.float32)}
    return cfg, params, optim.adamw_init(params, cfg)


def _grad(loss, params):
    p = params["w"].detach().requires_grad_(True)
    return {"w": torch.autograd.grad(loss({"w": p}), [p])[0]}


def test_adamw_minimizes_quadratic():
    cfg, params, state = _quad_setup(use_master=False)
    loss = lambda p: torch.sum(torch.square(p["w"] - 3.0))
    for _ in range(200):
        params, state, _ = optim.adamw_update(params, _grad(loss, params),
                                              state, cfg)
    assert float(loss(params)) < 1e-2


def test_master_weights_beat_bf16_resolution():
    """With fp32 master, bf16 params keep improving even when single
    updates are below bf16 resolution."""
    cfg, params, state = _quad_setup(use_master=True)
    loss = lambda p: torch.sum(torch.square(p["w"].float() - 3.0))
    for _ in range(300):
        params, state, _ = optim.adamw_update(params, _grad(loss, params),
                                              state, cfg)
    assert params["w"].dtype == torch.bfloat16
    assert float(loss(params)) < 1e-2
    assert state["master"]["w"].dtype == torch.float32


def test_grad_clip_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((9,), 10.0)}
    clipped, gn = optim.clip_by_global_norm(g, 1.0)
    total = sum(float(torch.sum(torch.square(x))) for x in leaves(clipped))
    assert abs(total - 1.0) < 1e-5 and float(gn) > 1.0
    jclipped, jgn = joptim.clip_by_global_norm(
        {k: jnp.asarray(_np(v)) for k, v in g.items()}, 1.0)
    assert float(gn) == pytest.approx(float(jgn), rel=1e-6)
    for a, b in zip(leaves(clipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


def test_cosine_schedule_shape_and_values():
    lrs = [float(optim.cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                       peak_lr=1.0, warmup_steps=10,
                                       total_steps=100)) for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0 + 1e-6         # warmup rises
    assert np.argmax(lrs) <= 11                  # peak right after warmup
    assert lrs[-1] < 0.2                          # decays toward final_frac
    want = [float(joptim.cosine_schedule(jnp.int32(s), peak_lr=1.0,
                                         warmup_steps=10, total_steps=100))
            for s in range(100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-7)
    assert float(optim.linear_warmup(3, peak_lr=2.0, warmup_steps=8)) == \
        pytest.approx(float(joptim.linear_warmup(3, peak_lr=2.0,
                                                 warmup_steps=8)))


@pytest.mark.parametrize("use_master", [False, True])
def test_adamw_update_matches_reference(use_master):
    """Three updates of a nested tree (dicts and a list; bf16 leaves
    with a master copy, f32 without) from the same grads: params,
    moments, master and step as the reference's; ``inplace=True`` writes the same values into the
    given tensors."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": [(2, 2), (3,)]}}
    p_np = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    cfg = optim.AdamWConfig(lr=1e-2, weight_decay=0.1,
                            use_master=use_master)
    jcfg = joptim.AdamWConfig(lr=1e-2, weight_decay=0.1,
                              use_master=use_master)
    cast = (lambda a: a.astype(jnp.bfloat16)) if use_master else (lambda a: a)
    jp = jax.tree.map(lambda a: cast(jnp.asarray(a)), p_np)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    tq = convert.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = joptim.adamw_init(jp, jcfg), optim.adamw_init(tp, cfg)
    tqs = optim.adamw_init(tq, cfg)
    for i in range(3):
        g_np = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * 3, p_np)
        lr = 1e-2 * (i + 1)
        jp, js, jm = joptim.adamw_update(jp, jax.tree.map(jnp.asarray, g_np),
                                         js, jcfg, lr=lr)
        tg = convert.params_from_reference(g_np, "cpu")
        tp, ts, tm = optim.adamw_update(tp, tg, ts, cfg, lr=lr)
        tq2, tqs2, _ = optim.adamw_update(tq, tg, tqs, cfg, lr=lr,
                                          inplace=True)
        assert tq2 is tq and tqs2 is tqs
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
        for name in ("m", "v") + (("master",) if use_master else ()):
            for a, b in zip(leaves(ts[name]), jax.tree.leaves(js[name])):
                np.testing.assert_allclose(_np(a), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
        for a, b, c in zip(leaves(tp), jax.tree.leaves(jp), leaves(tq)):
            assert a.dtype == c.dtype == (torch.bfloat16 if use_master
                                          else torch.float32)
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(_np(a), _np(c))
    assert ts["step"].dtype == torch.int32
    assert ("master" in ts) == use_master


@pytest.mark.parametrize("inplace", [False, True])
def test_adamw_chunks_change_no_bit(inplace, monkeypatch):
    """A leaf is updated ``CHUNK`` elements at a time: with a chunk of 7
    the params and moments are the unchunked update's bit for bit (the
    update is elementwise; the clip is off, so the norm's summation
    order, which chunks change, does not reach them) and the grad norm
    is within float32 rounding of it."""
    from repro_torch.optim import adamw as tadamw
    g = torch.Generator().manual_seed(0)
    shapes = {"a": (5, 13), "b": [(50,), (3, 2, 4)]}
    make = lambda: {"a": torch.randn(shapes["a"], generator=g),
                    "b": [torch.randn(s, generator=g) for s in shapes["b"]]}
    params, grads = make(), make()
    cfg = optim.AdamWConfig(lr=1e-2, use_master=True, grad_clip=1e9)
    out = []
    for chunk in (tadamw.CHUNK, 7):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        p = map_leaves(lambda t: t.clone(), params)
        st = optim.adamw_init(p, cfg)
        for _ in range(2):
            p, st, m = optim.adamw_update(p, grads, st, cfg, inplace=inplace)
        out.append((p, st, m))
    for name in ("m", "v", "master"):
        for a, b in zip(leaves(out[0][1][name]), leaves(out[1][1][name])):
            assert torch.equal(a, b)
    for a, b in zip(leaves(out[0][0]), leaves(out[1][0])):
        assert torch.equal(a, b)
    assert float(out[0][2]["grad_norm"]) == pytest.approx(
        float(out[1][2]["grad_norm"]), rel=1e-6)


def test_opt_state_carries_over_from_reference():
    jcfg = joptim.AdamWConfig(use_master=True)
    jp = {"w": jnp.ones((3, 2), jnp.bfloat16), "b": jnp.zeros(2)}
    js = joptim.adamw_init(jp, jcfg)
    js["step"] = js["step"] + 7
    ts = convert.opt_state_from_reference(jax.tree.map(np.asarray, js),
                                          "cpu")
    assert sorted(ts) == ["m", "master", "step", "v"]
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 7
    assert ts["master"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="not an AdamW state"):
        convert.opt_state_from_reference({"m": {}}, "cpu")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=64, global_batch=4),
    dict(vocab_size=100, seq_len=16, global_batch=8, n_shards=4, shard_id=3),
    dict(vocab_size=64, seq_len=256, global_batch=8, motif_prob=0.9),
    dict(vocab_size=151936, seq_len=128, global_batch=8),
    dict(vocab_size=100, seq_len=16, global_batch=2, frontend="vision",
         frontend_seq=8, d_model=32, seed=5)])
def test_batches_bit_identical_to_reference(kw):
    ds, jds = SyntheticTokenDataset(DataConfig(**kw)), JDataset(
        JDataConfig(**kw))
    np.testing.assert_array_equal(ds.motifs, jds.motifs)
    for step in (0, 1, 5, 17):
        got, want = ds.batch(step), jds.batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it, jit = host_batch_iterator(DataConfig(**kw), 3), jbatches(
        JDataConfig(**kw), 3)
    for _ in range(2):
        (s, b), (js_, jb) = next(it), next(jit)
        assert s == js_
        np.testing.assert_array_equal(b["tokens"], jb["tokens"])


def test_batches_deterministic_differ_and_split():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=4)
    ds1, ds2 = SyntheticTokenDataset(cfg), SyntheticTokenDataset(cfg)
    for step in (0, 5, 17):
        np.testing.assert_array_equal(ds1.batch(step)["tokens"],
                                      ds2.batch(step)["tokens"])
    assert not np.array_equal(ds1.batch(0)["tokens"], ds1.batch(1)["tokens"])
    c2 = DataConfig(vocab_size=1000, seq_len=64, global_batch=8,
                    n_shards=2, shard_id=1)
    assert not np.array_equal(ds1.batch(0)["tokens"],
                              SyntheticTokenDataset(c2).batch(0)["tokens"])
    c4 = DataConfig(vocab_size=100, seq_len=16, global_batch=8, n_shards=4)
    assert SyntheticTokenDataset(c4).batch(0)["tokens"].shape == (2, 16)


def test_iterator_resume_matches():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=2)
    it1 = host_batch_iterator(cfg)
    seq1 = [next(it1) for _ in range(6)]
    it2 = host_batch_iterator(cfg, start_step=3)
    for (s1, b1), (s2, b2) in zip(seq1[3:], it2):
        assert s1 == s2
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])


def test_motifs_make_data_learnable_and_prefix_shapes():
    toks = SyntheticTokenDataset(DataConfig(
        vocab_size=64, seq_len=256, global_batch=8,
        motif_prob=0.9)).batch(0)["tokens"]
    pairs = {}
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            pairs[(a, b)] = pairs.get((a, b), 0) + 1
    assert max(pairs.values()) / sum(pairs.values()) > 2.0 / 64 ** 2 * 10
    b = SyntheticTokenDataset(DataConfig(
        vocab_size=100, seq_len=16, global_batch=2, frontend="vision",
        frontend_seq=8, d_model=32)).batch(0)
    assert b["prefix"].shape == (2, 8, 32)


# ---------------------------------------------------------------------------
# train_loss and its gradients, all ten architectures
# ---------------------------------------------------------------------------

def test_arch_ids_are_the_references():
    assert list(ARCH_IDS) == list(JARCH_IDS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_grads_match_reference(arch):
    jcfg, tcfg, jparams, tparams = _models(arch)
    batch = SyntheticTokenDataset(_data_cfg(tcfg, 16, 2)).batch(0)
    tb = _on_cpu(batch)
    # bfloat16 activations: the loss
    jl = float(jget_model(jcfg).train_loss(jparams, batch, jcfg))
    tl = float(get_model(tcfg).train_loss(tparams, tb, tcfg))
    assert abs(tl - jl) <= BF16_LOSS * max(abs(jl), 1.0)
    # float32 activations: the loss and every gradient leaf
    with _activations(f32=True):
        jl, jg = jax.value_and_grad(
            lambda p: jget_model(jcfg).train_loss(p, batch, jcfg))(jparams)
        lv = leaves(tparams)
        for p in lv:
            p.requires_grad_(True)
        loss = get_model(tcfg).train_loss(tparams, tb, tcfg)
        grads = torch.autograd.grad(loss, lv)
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= F32_LOSS * max(abs(float(jl)), 1.0)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for (path, _), g, jgl in zip(leaves_with_path(tparams), grads, jleaves):
        want = np.asarray(jgl, np.float32)
        assert g.shape == want.shape, path
        np.testing.assert_allclose(
            _np(g), want, rtol=0,
            atol=F32_GRAD * max(float(np.abs(want).max()), 1e-30),
            err_msg=f"{arch} {path}")


def test_remat_gives_the_same_loss_and_grads():
    """``cfg.remat`` checkpoints each period (``torch.utils.checkpoint``):
    the same loss and gradients, bit for bit, as without it."""
    cfg = dataclasses.replace(smoke_variant(get_config("qwen2.5-3b")),
                              remat=True)
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    batch = _on_cpu(SyntheticTokenDataset(_data_cfg(cfg, 16, 2)).batch(0))
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        lv = leaves(params)
        for p in lv:
            p.requires_grad_(True)
        loss = get_model(c).train_loss(params, batch, c)
        out.append((loss.detach(), torch.autograd.grad(loss, lv)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_train_mode_returns_every_position_and_no_cache():
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0),
                                        cfg)
    toks = torch.arange(12).reshape(2, 6) % cfg.vocab_size
    logits, cache = tlm.forward(params, toks, cfg)          # default: train
    assert cache is None and logits.shape == (2, 6, cfg.vocab_size)
    last, _ = tlm.forward(params, toks, cfg, mode="prefill")
    torch.testing.assert_close(logits[:, -1:], last, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown mode"):
        tlm.forward(params, toks, cfg, mode="training")


# ---------------------------------------------------------------------------
# one train step, and the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compression", [None, "bf16"])
@pytest.mark.parametrize("f32", [True, False])
def test_train_step_matches_reference(f32, compression):
    """Two steps of ``make_train_step`` (autograd, bf16 gradient cast,
    cosine schedule, AdamW) against the reference's jitted
    ``make_train_step`` on the same params and batches."""
    lr = 3e-3
    with _activations(f32):
        jcfg, tcfg, jp, tp = _models("qwen2.5-3b")
        kw = dict(total_steps=30, peak_lr=lr, warmup_steps=5,
                  grad_compression=compression)
        jstep = jax.jit(jloop.make_train_step(
            lambda p, b: jget_model(jcfg).train_loss(p, b, jcfg),
            joptim.AdamWConfig(lr=lr, use_master=False),
            jloop.TrainLoopConfig(**kw)))
        tstep = make_train_step(
            lambda p, b: get_model(tcfg).train_loss(p, b, tcfg),
            optim.AdamWConfig(lr=lr, use_master=False),
            TrainLoopConfig(**kw))
        js = joptim.adamw_init(jp, joptim.AdamWConfig(use_master=False))
        ts = optim.adamw_init(tp, optim.AdamWConfig(use_master=False))
        ds = SyntheticTokenDataset(DataConfig(vocab_size=tcfg.vocab_size,
                                              seq_len=32, global_batch=4))
        for step in range(2):
            batch = ds.batch(step)
            jp, js, jm = jstep(jp, js, batch)
            tp, ts, tm = tstep(tp, ts, batch)
            rtol = 1e-5 if f32 else 1e-3
            for k in ("loss", "grad_norm"):
                assert float(tm[k]) == pytest.approx(float(jm[k]), rel=rtol)
            assert int(tm["step"]) == int(jm["step"]) == step + 1
            if f32:
                for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
                    np.testing.assert_allclose(_np(a), np.asarray(b),
                                               rtol=0, atol=1e-2 * lr)


def _tiny_loop(tmp_path, fail_at=None, total=30):
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    api = get_model(cfg)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    return TrainLoop(
        train_loss_fn=lambda p, b: api.train_loss(p, b, cfg),
        params=params, batch_iter=host_batch_iterator(dcfg),
        opt_cfg=optim.AdamWConfig(lr=3e-3, use_master=False),
        loop_cfg=TrainLoopConfig(total_steps=total, checkpoint_every=10,
                                 ckpt_dir=str(tmp_path), peak_lr=3e-3,
                                 warmup_steps=5, fail_at_step=fail_at))


def test_loop_loss_improves(tmp_path):
    loop = _tiny_loop(tmp_path, total=25)
    hist = loop.run()
    assert len(hist) == 25
    assert [h["step"] for h in hist] == list(range(25))
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first
    assert loop.ckpt.steps() == [10, 20]
    assert loop.monitor.n_hosts == 1 and loop.monitor.initialized


def test_crash_and_resume_equals_uninterrupted_run(tmp_path):
    full = _tiny_loop(tmp_path / "full", total=25).run()
    loop = _tiny_loop(tmp_path / "crash", fail_at=15, total=25)
    with pytest.raises(RuntimeError, match="simulated host failure"):
        loop.run()
    # fresh process: rebuild everything, restore, continue
    loop2 = _tiny_loop(tmp_path / "crash", total=25)
    start = loop2.try_restore()
    assert start == 11                     # checkpoint at step 10
    hist = loop2.run()
    assert hist[0]["step"] == 11 and hist[-1]["step"] == 24
    assert [h["loss"] for h in hist] == [h["loss"] for h in full[11:]]
    assert [h["grad_norm"] for h in hist] == \
        [h["grad_norm"] for h in full[11:]]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_run_train_prints_the_references_lines(tmp_path, capsys):
    out = tlaunch.run_train(steps=12, batch=2, seq=16, device="cpu",
                            ckpt_dir=str(tmp_path))
    lines = capsys.readouterr().out.splitlines()
    jcfg = jsmoke(jget_config("qwen2.5-3b"))
    jparams = jget_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    assert lines[0] == f"arch={jcfg.name} params={n/1e6:.2f}M"
    assert out["n_params"] == n
    verdict = "improved" if out["last"] < out["first"] else "NOT improved"
    assert lines[-1] == (f"steps=12 loss {out['first']:.4f} -> "
                         f"{out['last']:.4f} ({verdict})")
    assert sorted(out["loop"].ckpt.steps()) == [3, 6, 9]   # every steps // 4
    tlaunch.run_train(steps=12, batch=2, seq=16, device="cpu", resume=True,
                      ckpt_dir=str(tmp_path))
    assert "resumed from step 10" in capsys.readouterr().out


def test_cli_flags_and_the_smoke_quirk(monkeypatch):
    """The reference's flags word for word; ``--smoke`` is ``store_true``
    with ``default=True``, so every CLI run trains the smoke variant
    (ROADMAP C-ref4).  No ``--device`` flag: without a card the run
    raises."""
    seen = {}
    monkeypatch.setattr(tlaunch, "run_train", lambda **kw: seen.update(kw))
    tlaunch.main(["--steps", "5", "--batch", "2", "--seq", "8", "--resume",
                  "--fail-at", "3", "--lr", "0.01", "--arch", "xlstm-350m"])
    assert seen == {"arch": "xlstm-350m", "smoke": True, "steps": 5,
                    "batch": 2, "seq": 8, "ckpt_dir": seen["ckpt_dir"],
                    "resume": True, "fail_at": 3, "lr": 0.01}
    tlaunch.main([])
    assert seen["smoke"] is True and seen["steps"] == 200
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu"])
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--steps", "1"])
