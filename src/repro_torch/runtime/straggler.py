"""Straggler detection & mitigation — the port's copy of
``repro.runtime.straggler`` (NumPy only, line for line).

On a 1000+-node cluster the slowest host sets the step time (synchronous
SPMD).  The monitor keeps an EWMA of per-host step-report times; hosts
whose reported time exceeds ``threshold ×`` the fleet median for
``patience`` consecutive steps are flagged.  Mitigation is a policy
callback — the default recommendation ladder is:

  1. ``rebalance``  — shrink the flagged host's data shard (batch
     re-split, cheap, reversible),
  2. ``evict``      — hand the host to :class:`ElasticMeshManager` for a
     re-mesh without it (checkpoint → re-shard → resume).

The port runs it in two places: the serving supervisor's latency watch
(:class:`repro_torch.runtime.resilience.ServingSupervisor`) and the
training loop (:class:`repro_torch.runtime.loop.TrainLoop`), which feeds
it one step time per process.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.2
    threshold: float = 1.5         # × fleet median
    patience: int = 5              # consecutive flagged steps before action
    evict_threshold: float = 3.0   # × median → recommend eviction


class StragglerMonitor:
    def __init__(self, n_hosts: int, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.n_hosts = n_hosts
        self.ewma = np.zeros(n_hosts)
        self.flag_streak = np.zeros(n_hosts, dtype=np.int64)
        self.initialized = False

    def observe(self, host_step_times: np.ndarray) -> dict:
        """Feed one step's per-host wall times; returns actions."""
        t = np.asarray(host_step_times, dtype=np.float64)
        if not self.initialized:
            self.ewma[:] = t
            self.initialized = True
        else:
            a = self.cfg.ewma_alpha
            self.ewma = (1 - a) * self.ewma + a * t
        med = np.median(self.ewma)
        if med <= 0:
            # degenerate fleet (all-zero / mostly-zero timings, e.g. a
            # cold start or a clock that hasn't ticked): any positive
            # entry would ratio to +inf against a zero median and flag
            # spuriously — report no evidence instead, and reset streaks
            # so garbage samples never accumulate toward an action
            self.flag_streak[:] = 0
            return {"median": float(med),
                    "ratio": np.ones(self.n_hosts), "actions": {}}
        ratio = self.ewma / med
        flagged = ratio > self.cfg.threshold
        self.flag_streak = np.where(flagged, self.flag_streak + 1, 0)
        actions = {}
        for h in np.nonzero(self.flag_streak >= self.cfg.patience)[0]:
            if ratio[h] > self.cfg.evict_threshold:
                actions[int(h)] = "evict"
            else:
                actions[int(h)] = "rebalance"
        return {"median": float(med), "ratio": ratio, "actions": actions}
