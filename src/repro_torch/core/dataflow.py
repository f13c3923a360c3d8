"""CoDR dataflow accounting: tiling and SRAM access counting (paper
§III-B, §IV, Table I) — the port's copy of the CoDR half of
``repro.core.dataflow`` (what ``CodrModel.sram_report`` needs).

Analytical loop-nest access counters: CoDR is fully output stationary
(each output feature written once) and semi input stationary (inputs
fetched ``ceil(M / (T_PU*T_M))`` times); compressed weights are
re-streamed per spatial output tile in wide sequential rows.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ConvShape", "TilingConfig", "CODR_TILING", "AccessCounts",
           "codr_accesses", "codr_tiling"]


@dataclasses.dataclass(frozen=True)
class ConvShape:
    m: int                  # output channels
    n: int                  # input channels
    rk: int                 # kernel rows
    ck: int                 # kernel cols
    ri: int                 # input rows
    ci: int                 # input cols
    stride: int = 1

    @property
    def ro(self) -> int:
        return (self.ri - self.rk) // self.stride + 1

    @property
    def co(self) -> int:
        return (self.ci - self.ck) // self.stride + 1

    @property
    def n_weights(self) -> int:
        return self.m * self.n * self.rk * self.ck

    @property
    def n_outputs(self) -> int:
        return self.m * self.ro * self.co

    @property
    def n_inputs(self) -> int:
        return self.n * self.ri * self.ci

    @property
    def macs(self) -> int:
        return self.n_outputs * self.n * self.rk * self.ck


@dataclasses.dataclass(frozen=True)
class TilingConfig:
    """Table I RTL tiling parameters."""

    name: str
    t_pu: int
    t_m: int
    t_n: int
    t_ro: int
    t_co: int
    t_ri: int
    t_ci: int
    mults_per_pu: int
    weight_row_bits: int = 64   # weight SRAM streams wide sequential rows


CODR_TILING = TilingConfig("CoDR", 8, 4, 4, 8, 8, 20, 20, 64)


def codr_tiling(t_m: int | None = None, t_n: int | None = None, *,
                base: TilingConfig = CODR_TILING) -> TilingConfig:
    """A CoDR tiling with per-layer channel-tile overrides (the PU
    count, spatial tiles and SRAM row width stay Table I's)."""
    kw = {}
    if t_m is not None:
        kw["t_m"] = int(t_m)
    if t_n is not None:
        kw["t_n"] = int(t_n)
    return dataclasses.replace(base, **kw) if kw else base


@dataclasses.dataclass
class AccessCounts:
    """Counts in accesses of the stated granularity: features are 8-bit
    word accesses; weight SRAM accesses are wide-row reads
    (``weight_row_bits`` each); RF accesses are 8-bit."""

    name: str
    input_sram: float
    output_sram: float
    weight_sram_rows: float
    weight_bits_streamed: float
    input_rf: float
    weight_rf: float
    output_rf: float
    mults: float
    accums: float
    crossbar: float
    dram_weight_bits: float
    dram_feature_bytes: float

    @property
    def feature_sram(self) -> float:
        return self.input_sram + self.output_sram

    @property
    def total_sram(self) -> float:
        return self.input_sram + self.output_sram + self.weight_sram_rows


def _spatial_tiles(shape: ConvShape, cfg: TilingConfig) -> int:
    return math.ceil(shape.ro / cfg.t_ro) * math.ceil(shape.co / cfg.t_co)


def codr_accesses(shape: ConvShape, cfg: TilingConfig,
                  compressed_bits: float, n_unique: float,
                  n_nonzero: float) -> AccessCounts:
    """CoDR loop ordering (Fig. 5a circled 1–4):

    for m_group in M / (T_PU*T_M):          # ④ outputs written once
      for spatial tile in RO/T_RO × CO/T_CO:  # ③
        for n in N:                           # ② accumulate over inputs
          stream compressed weights           # ① re-streamed per tile
    """
    m_groups = math.ceil(shape.m / (cfg.t_pu * cfg.t_m))
    spatial = _spatial_tiles(shape, cfg)

    output_sram = float(shape.n_outputs)                       # written once
    input_sram = float(shape.n_inputs) * m_groups              # semi-stationary
    weight_bits = compressed_bits * spatial                    # re-streamed
    weight_rows = weight_bits / cfg.weight_row_bits

    # MPE: each unique weight multiplies the halo window its repetitions
    # can address; APE accumulates one product window per repetition
    tile_elems = min((cfg.t_ro + shape.rk - 1) * (cfg.t_co + shape.ck - 1),
                     cfg.t_ri * cfg.t_ci)
    out_tile_elems = cfg.t_ro * cfg.t_co
    mults = n_unique * tile_elems * spatial
    accums = n_nonzero * out_tile_elems * spatial
    input_rf = mults                                           # matrix operand reads
    output_rf = 2.0 * accums                                   # read-modify-write
    weight_rf = weight_bits / 8.0                              # decoder feed
    crossbar = accums                                          # MPE→APE routing

    return AccessCounts(
        name=cfg.name, input_sram=input_sram, output_sram=output_sram,
        weight_sram_rows=weight_rows, weight_bits_streamed=weight_bits,
        input_rf=input_rf, weight_rf=weight_rf, output_rf=output_rf,
        mults=mults, accums=accums, crossbar=crossbar,
        dram_weight_bits=compressed_bits,
        dram_feature_bytes=float(shape.n_inputs + shape.n_outputs))
