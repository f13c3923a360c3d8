"""Deterministic sharded data pipeline — the port's copy of
``repro.data.pipeline`` (NumPy only): the same draws in the same order,
so a step's batch is bit for bit the reference's.

Synthetic-but-structured token streams (a mixture of Zipfian unigram
draws and repeated n-gram motifs so the LM loss actually decreases),
generated *per host shard* from a (seed, epoch, step, shard) counter —
no cross-host coordination needed and any step is reproducible after an
elastic restart (the cursor is part of the checkpoint).

The same module provides the modality-frontend stubs: precomputed
frame/patch embeddings per the assignment spec.  Batches are host NumPy;
the train step moves them to its device.  ``make_batch_specs`` (shape
specs for the reference's ``build_cell``) waits with
``launch/steps.py`` (ROADMAP "A10, model half").
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1              # host data shards
    shard_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5
    frontend: str | None = None
    frontend_seq: int = 0
    d_model: int = 0


class SyntheticTokenDataset:
    """Stateless step-indexed batch generator (host-side numpy)."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed motif bank shared by all shards (function of seed only)
        self.motifs = base.integers(0, v, size=(64, cfg.motif_len))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self.unigram = p / p.sum()

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, 7919 * step + cfg.shard_id))
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        toks = rng.choice(v, size=(b, s), p=self.unigram).astype(np.int32)
        # splice in repeated motifs → learnable structure
        n_splice = int(s * cfg.motif_prob / cfg.motif_len)
        for i in range(b):
            for _ in range(max(n_splice, 1)):
                m = self.motifs[rng.integers(0, len(self.motifs))]
                at = rng.integers(0, max(s - cfg.motif_len, 1))
                toks[i, at : at + cfg.motif_len] = m[: max(s - at, 0)][:cfg.motif_len][: s - at]
        out = {"tokens": toks}
        if cfg.frontend:
            out["prefix"] = rng.standard_normal(
                (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
        return out


def host_batch_iterator(cfg: DataConfig, start_step: int = 0):
    ds = SyntheticTokenDataset(cfg)
    step = start_step
    while True:
        yield step, ds.batch(step)
        step += 1
