"""The port's training checkpoint (``repro_torch.checkpoint.manager``) on
the CPU, mirroring ``tests/test_checkpoint.py``, and moved between the
two packages.

* Format: a checkpoint the port writes is the reference's byte for byte
  — every ``leaf_i.npy`` and ``manifest.json`` — for a tree of float32,
  int32, 0-d and bfloat16 leaves (a bfloat16 leaf is its two bytes per
  element under the descr ``'<V2'``, as ``np.save`` writes an
  ``ml_dtypes.bfloat16`` array).
* Either way: the reference restores a float32 / int32 training state
  the port wrote, and the port restores one the reference wrote, bit
  for bit; the port restores the reference's bfloat16 leaves bit for
  bit.  The reference cannot restore a bfloat16 leaf at all — its own or
  the port's (``np.load`` gives ``|V2``, which has no cast to
  bfloat16): ROADMAP caveat C-ref5, held here so a fix shows.
* A reference ``TrainLoop``'s checkpoint seeds the port's loop, which
  continues it: its next losses are within rtol 1e-3 of the
  reference's own continuation (bf16 activations).

Every writer thread is joined with its own timeout.
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import restore_latest as jrestore_latest
from repro_torch.checkpoint import CheckpointManager, restore_latest
from repro_torch.checkpoint.manager import treedef_str
from repro_torch.core.tree import leaves, leaves_with_path
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.rules import NamedSharding, P, ShardedTensor

T = 120


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "b": {"c": torch.arange(10, dtype=torch.int32),
                  "d": torch.tensor(3.5)}}


def _jtree(tree):
    """The same tree as JAX arrays (bfloat16 bits kept)."""
    def leaf(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(leaf, tree)


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(7, tree, extra={"data_cursor": 8}, async_=False)
    restored, extra = mgr.restore(7, tree)
    assert extra == {"data_cursor": 8}
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_async_save_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    for s in (1, 5, 9):
        mgr.save(s, tree, async_=True)
    mgr.wait(timeout=T)
    assert mgr.steps() == [1, 5, 9]
    restored, extra, step = restore_latest(mgr, tree)
    assert step == 9 and restored is not None and extra == {}


def test_gc_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _tree(), async_=False)
    assert mgr.steps() == [3, 4]


def test_no_tmp_dirs_after_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), async_=False)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_restore_places_on_the_targets_device_and_dtype(tmp_path):
    """Without shardings each leaf lands on its target leaf's device in
    its dtype; with shardings each is held as blocks under its spec on
    the sharding's mesh, in its stored dtype, and reads back whole."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, async_=False)
    target = {"a": torch.zeros((8, 4), dtype=torch.float64),
              "b": {"c": torch.zeros(10, dtype=torch.int64),
                    "d": torch.zeros(())}}
    restored, _ = mgr.restore(1, target)
    assert restored["a"].dtype == torch.float64
    np.testing.assert_array_equal(restored["a"].numpy(),
                                  tree["a"].double().numpy())
    mesh = make_host_mesh(2, 2, device="cpu")
    shardings = {"a": NamedSharding(mesh, P("data", "model")),
                 "b": {"c": NamedSharding(mesh, P("model")),
                       "d": NamedSharding(mesh, P())}}
    placed, _ = mgr.restore(1, tree, shardings=shardings)
    for path in ("a", "b/c", "b/d"):
        got = dict(leaves_with_path(placed))[path]
        want = dict(leaves_with_path(tree))[path]
        assert isinstance(got, ShardedTensor) and got.dtype == want.dtype
        assert torch.equal(got.full(), want)
    assert placed["a"].block_shape == (4, 2)
    with pytest.raises(ValueError, match="shardings for"):
        mgr.restore(1, tree, shardings={"a": shardings["a"]})
    with pytest.raises(ValueError, match="tree structure changed"):
        mgr.restore(1, {"a": tree["a"]})


def test_restore_empty_dir(tmp_path):
    tree, extra, step = restore_latest(CheckpointManager(str(tmp_path)),
                                       _tree())
    assert tree is None and extra is None and step == -1


def test_writer_errors_surface_in_wait(tmp_path):
    """A failed async write is raised by the next ``wait`` (the
    reference's writer thread drops it)."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_2.tmp").write_text("in the way")
    mgr.save(2, _tree(), async_=True)
    with pytest.raises(FileExistsError):
        mgr.wait(timeout=T)
    mgr.wait(timeout=T)                        # raised once
    assert mgr.steps() == []


# ---------------------------------------------------------------------------
# between the packages
# ---------------------------------------------------------------------------

def _mixed(seed=0):
    tree = _tree(seed)
    tree["h"] = torch.randn((3, 5), generator=torch.Generator().manual_seed(
        seed + 1)).to(torch.bfloat16)
    tree["s"] = [torch.zeros((), dtype=torch.int32), (torch.ones(2),)]
    return tree


def test_port_writes_the_references_bytes(tmp_path):
    tree = _mixed()
    CheckpointManager(str(tmp_path / "t")).save(
        4, tree, extra={"data_cursor": 5}, async_=False)
    JManager(str(tmp_path / "j")).save(4, _jtree(tree),
                                       extra={"data_cursor": 5},
                                       async_=False)
    names = sorted(os.listdir(tmp_path / "j" / "step_4"))
    assert names == sorted(os.listdir(tmp_path / "t" / "step_4"))
    assert len(names) == len(leaves(tree)) + 1
    for name in names:
        assert filecmp.cmp(tmp_path / "j" / "step_4" / name,
                           tmp_path / "t" / "step_4" / name,
                           shallow=False), name
    manifest = json.loads((tmp_path / "t" / "step_4" /
                           "manifest.json").read_text())
    assert manifest["treedef"] == treedef_str(tree) == str(
        jax.tree_util.tree_structure(_jtree(tree)))
    assert {"shape": [3, 5], "dtype": "bfloat16"} in manifest["leaves"]


def test_checkpoints_move_both_ways(tmp_path):
    tree = _tree()
    # port → reference
    CheckpointManager(str(tmp_path / "t")).save(2, tree, async_=False)
    jtree = _jtree(_tree(seed=9))
    restored, _, step = jrestore_latest(JManager(str(tmp_path / "t")),
                                        jtree)
    assert step == 2
    for a, b in zip(leaves(tree), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # reference → port, bfloat16 leaves included
    mixed = _mixed(seed=3)
    JManager(str(tmp_path / "j")).save(6, _jtree(mixed), async_=False)
    got, _, step = restore_latest(CheckpointManager(str(tmp_path / "j")),
                                  _mixed(seed=4))
    assert step == 6
    for a, b in zip(leaves(mixed), leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_reference_cannot_restore_bf16_leaves(tmp_path):
    """C-ref5: the reference's restore casts the loaded ``|V2`` array to
    bfloat16, which NumPy cannot do — for its own checkpoint and for the
    port's alike (the bytes are the same)."""
    tree = {"h": torch.ones(3, dtype=torch.bfloat16)}
    CheckpointManager(str(tmp_path / "t")).save(1, tree, async_=False)
    JManager(str(tmp_path / "j")).save(1, _jtree(tree), async_=False)
    for d in ("t", "j"):
        with pytest.raises((TypeError, ValueError)):
            JManager(str(tmp_path / d)).restore(1, _jtree(tree))


def test_reference_train_loop_seeds_the_ports(tmp_path):
    """A reference ``TrainLoop`` trains 11 steps and checkpoints at step
    10; the port's loop restores that checkpoint (params and AdamW
    state, the data cursor's step) and trains steps 11–14 — within rtol
    1e-3 of the reference's own continuation."""
    from repro.configs import get_config as jget_config
    from repro.configs import smoke_variant as jsmoke
    from repro.data import DataConfig as JDataConfig
    from repro.data import host_batch_iterator as jbatches
    from repro.models import get_model as jget_model
    from repro.optim import AdamWConfig as JAdamW
    from repro.runtime import TrainLoop as JTrainLoop
    from repro.runtime import TrainLoopConfig as JLoopConfig
    from repro_torch import optim
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data import DataConfig, host_batch_iterator
    from repro_torch.models import get_model
    from repro_torch.runtime import TrainLoop, TrainLoopConfig

    jcfg = jsmoke(jget_config("qwen2.5-3b"))
    kw = dict(total_steps=15, checkpoint_every=10, ckpt_dir=str(tmp_path),
              peak_lr=3e-3, warmup_steps=5)
    dkw = dict(vocab_size=jcfg.vocab_size, seq_len=32, global_batch=4)
    japi = jget_model(jcfg)
    jloop = JTrainLoop(
        train_loss_fn=lambda p, b: japi.train_loss(p, b, jcfg),
        params=japi.init_params(jax.random.PRNGKey(0), jcfg),
        batch_iter=jbatches(JDataConfig(**dkw)),
        opt_cfg=JAdamW(lr=3e-3, use_master=False),
        loop_cfg=JLoopConfig(**kw))
    jhist = jloop.run()
    assert [h["step"] for h in jhist] == list(range(15))
    # keep only the step-10 checkpoint (the reference's loop would also
    # have saved none later: 15 steps, every 10)
    assert CheckpointManager(str(tmp_path)).steps() == [10]

    cfg = smoke_variant(get_config("qwen2.5-3b"))
    api = get_model(cfg)
    loop = TrainLoop(
        train_loss_fn=lambda p, b: api.train_loss(p, b, cfg),
        params=api.init_params(torch.Generator().manual_seed(1), cfg),
        batch_iter=host_batch_iterator(DataConfig(**dkw)),
        opt_cfg=optim.AdamWConfig(lr=3e-3, use_master=False),
        loop_cfg=TrainLoopConfig(**kw))
    assert loop.try_restore() == 11
    assert int(loop.opt_state["step"]) == 11
    hist = loop.run()
    assert [h["step"] for h in hist] == [11, 12, 13, 14]
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in jhist[11:]], rtol=1e-3)
