"""CoDR dataflow accounting: tiling and SRAM access counting (paper
§III-B, §IV, Table I) — the port's copy of ``repro.core.dataflow``.

Analytical loop-nest access counters for the three dataflows the paper
compares: CoDR is fully output stationary (each output feature written
once) and semi input stationary (inputs fetched ``ceil(M / (T_PU*T_M))``
times), with compressed weights re-streamed per spatial output tile in
wide sequential rows; UCNN runs factorized dot products with partial
sums spilling per input-channel group; SCNN is input stationary with a
cartesian-product scatter.  Pure Python arithmetic, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["ConvShape", "TilingConfig", "CODR_TILING", "UCNN_TILING",
           "SCNN_TILING", "AccessCounts", "codr_accesses", "ucnn_accesses",
           "scnn_accesses", "codr_tiling", "pool_out"]


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


def pool_out(n: int, window: int, stride: int, padding: int,
             ceil_mode: bool) -> int:
    """A max pooling's output size over ``n`` pixels, as
    ``F.max_pool2d`` gives it (the port's pooling steps; not in the
    reference)."""
    span = n + 2 * padding - window
    o = (-(-span // stride) if ceil_mode else span // stride) + 1
    # a window may not start in the right-hand padding
    return o - 1 if ceil_mode and (o - 1) * stride >= n + padding else o


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
UCNN_TILING = TilingConfig("UCNN", 48, 1, 4, 1, 8, 1, 12, 8)
SCNN_TILING = TilingConfig("SCNN", 21, 2, 1, 1, 1, 1, 1, 16)


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


def ucnn_accesses(shape: ConvShape, cfg: TilingConfig,
                  compressed_bits: float, n_unique: float,
                  n_nonzero: float) -> AccessCounts:
    """UCNN dot-product dataflow: activation-group factorized dot products;
    partial sums spill to SRAM across input-channel tiles; inputs re-read
    per overlapping kernel window (T_RI×T_CI = 1×12 buffer only)."""
    n_groups = math.ceil(shape.n / cfg.t_n)
    # outputs: read+write per input-channel group (partial-sum accumulation)
    output_sram = 2.0 * shape.n_outputs * n_groups
    # inputs: the 1×T_CI row buffer captures kernel-column overlap (÷ck)
    # but not row overlap; each output row re-reads its RK rows, amortized
    # over the T_M·T_PU outputs sharing a fetch
    input_sram = (shape.ro * shape.co * shape.rk * shape.ck * shape.n
                  / max(shape.ck / shape.stride, 1.0)
                  * max(1.0, shape.m / (cfg.t_pu * cfg.t_m)))
    weight_bits = compressed_bits * math.ceil(shape.ro / cfg.t_co)
    weight_rows = weight_bits / cfg.weight_row_bits

    # factorized dot product: one multiply per unique weight per output,
    # adds for every nonzero term
    mults = n_unique * shape.ro * shape.co
    accums = n_nonzero * shape.ro * shape.co
    return AccessCounts(
        name=cfg.name, input_sram=input_sram, output_sram=output_sram,
        weight_sram_rows=weight_rows, weight_bits_streamed=weight_bits,
        input_rf=accums, weight_rf=weight_bits / 8.0, output_rf=2.0 * mults,
        mults=mults, accums=accums, crossbar=accums,
        dram_weight_bits=compressed_bits,
        dram_feature_bytes=float(shape.n_inputs + shape.n_outputs))


def scnn_accesses(shape: ConvShape, cfg: TilingConfig,
                  compressed_bits: float, n_unique: float,
                  n_nonzero: float) -> AccessCounts:
    """SCNN input-stationary cartesian-product dataflow: inputs read once;
    every nonzero weight × input product is scattered through the crossbar
    into output accumulator banks, spilling partial sums to SRAM per
    input-channel step (T_N = 1)."""
    input_sram = float(shape.n_inputs)                          # stationary
    # psum spills: the accumulator banks hold one output tile; the
    # scatter revisits outputs once per input-channel step
    n_steps = math.ceil(shape.n / cfg.t_n)
    output_sram = 1.0 * shape.n_outputs * n_steps               # psum spills
    weight_bits = compressed_bits
    weight_rows = weight_bits / cfg.weight_row_bits
    density = n_nonzero / max(shape.n_weights, 1)
    mults = shape.macs * density                                # all nonzero
    accums = mults
    return AccessCounts(
        name=cfg.name, input_sram=input_sram, output_sram=output_sram,
        weight_sram_rows=weight_rows, weight_bits_streamed=weight_bits,
        input_rf=mults, weight_rf=weight_bits / 8.0, output_rf=2.0 * mults,
        mults=mults, accums=accums, crossbar=accums,
        dram_weight_bits=compressed_bits,
        dram_feature_bytes=float(shape.n_inputs + shape.n_outputs))
