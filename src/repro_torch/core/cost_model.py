"""Energy/area cost model (paper §V, Figs. 7–8) — the port's copy of
``repro.core.cost_model``.

Constants follow the paper where it states them (DRAM 160 pJ/B, 45 nm,
250 kB feature SRAMs + 200 kB weight SRAM, 2.85 mm² equal-area designs)
and standard 45 nm numbers elsewhere (Horowitz, "Computing's energy
problem", ISSCC'14; CACTI 6.0 for SRAM scaling).  Absolute joules are
model estimates of the paper's ASIC, not of any device this package
runs on; the *relative* CoDR/UCNN/SCNN comparisons are the reproduction
target.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dataflow import (AccessCounts, ConvShape, TilingConfig,
                                       codr_accesses)

__all__ = ["DRAM_PJ_PER_BYTE", "SRAM_8B_PJ", "SRAM_ROW_PJ", "RF_8B_PJ",
           "MULT_INT8_PJ", "ADD_INT16_PJ", "XBAR_PJ", "EnergyBreakdown",
           "energy", "layer_cost", "weight_sram_cost_ratio"]

# --- 45 nm energy constants (pJ) -------------------------------------------
DRAM_PJ_PER_BYTE = 160.0          # paper §V-A
SRAM_8B_PJ = 10.0                 # 8-bit random access, 250 kB bank (CACTI)
SRAM_ROW_PJ = 20.0                # 64-bit sequential wide-row read, 200 kB
RF_8B_PJ = 0.3                    # small register file access
MULT_INT8_PJ = 0.2                # Horowitz ISSCC'14
ADD_INT16_PJ = 0.05
XBAR_PJ = 0.08                    # per routed partial product


@dataclasses.dataclass
class EnergyBreakdown:
    name: str
    dram_uj: float
    sram_uj: float
    rf_uj: float
    alu_uj: float
    crossbar_uj: float

    @property
    def total_uj(self) -> float:
        return (self.dram_uj + self.sram_uj + self.rf_uj + self.alu_uj
                + self.crossbar_uj)

    def as_dict(self) -> dict:
        return {
            "name": self.name, "dram_uj": self.dram_uj, "sram_uj": self.sram_uj,
            "rf_uj": self.rf_uj, "alu_uj": self.alu_uj,
            "crossbar_uj": self.crossbar_uj, "total_uj": self.total_uj,
        }


def energy(acc: AccessCounts) -> EnergyBreakdown:
    """Per-layer energy from access counts."""
    dram_bytes = acc.dram_weight_bits / 8.0 + acc.dram_feature_bytes
    dram = dram_bytes * DRAM_PJ_PER_BYTE
    sram = (acc.input_sram + acc.output_sram) * SRAM_8B_PJ \
        + acc.weight_sram_rows * SRAM_ROW_PJ
    rf = (acc.input_rf + acc.weight_rf + acc.output_rf) * RF_8B_PJ
    alu = acc.mults * MULT_INT8_PJ + acc.accums * ADD_INT16_PJ
    xbar = acc.crossbar * XBAR_PJ
    return EnergyBreakdown(acc.name, dram * 1e-6, sram * 1e-6, rf * 1e-6,
                           alu * 1e-6, xbar * 1e-6)


def layer_cost(shape: ConvShape, tiling: TilingConfig,
               compressed_bits: float, n_unique: float,
               n_nonzero: float) -> dict:
    """One candidate point for the encoding tuner: SRAM access count and
    energy under the CoDR dataflow for a layer encoded to
    ``compressed_bits`` with the given tile geometry.  Returns a flat
    dict (``sram``/``energy_uj`` plus the underlying breakdowns)."""
    acc = codr_accesses(shape, tiling, compressed_bits, n_unique,
                        n_nonzero)
    e = energy(acc)
    return {"sram": acc.total_sram, "energy_uj": e.total_uj,
            "accesses": acc, "energy": e}


def weight_sram_cost_ratio(bits_per_weight: float,
                           row_bits: int = 64) -> float:
    """How much cheaper one *weight* access is than one 8-bit feature
    access (paper reports 20.61× for CoDR, 12.17× UCNN, 4.34× SCNN)."""
    per_weight_pj = SRAM_ROW_PJ * bits_per_weight / row_bits
    return SRAM_8B_PJ / per_weight_pj
