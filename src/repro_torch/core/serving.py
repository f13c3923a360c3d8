"""CoDR weight compression as a serving feature — the accounting half of
``repro.core.serving``.

``codr_compress_params`` runs the paper's offline pipeline over every
large leaf of a params tree: int8 quantization → unique-weight budget U
→ UCR → customized RLE parameter search.  It returns the params with the
quantization *applied* (the quantize-applied reference lane: what
serving from the compressed weights must reproduce) and a per-tensor
report of encoded bits (CoDR) vs UCNN / SCNN / the fixed-width pack.

The RLE accounting is NumPy on the host, as in the reference; the
applied quantization is torch on the leaf's device, with the arithmetic
of :func:`repro_torch.core.codr_linear.quantize_restrict`.  The batch
server (``AsyncWorkerLoop`` / ``CodrBatchServer``) waits for ROADMAP A4.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rle, ucr
from repro_torch.core.baselines import scnn_compress_bits, ucnn_compress_bits
from repro_torch.core.codr_linear import choose_bits, quantize_restrict
from repro_torch.core.tree import map_with_path

__all__ = ["MIN_COMPRESS_SIZE", "TensorReport", "compress_tensor",
           "account_tensor", "codr_compress_params", "codr_report",
           "codr_serving_stats"]

MIN_COMPRESS_SIZE = 1024           # skip tiny leaves (norms, biases)


@dataclasses.dataclass
class TensorReport:
    """Per-tensor compression accounting.  ``codr/ucnn/scnn_bits`` are
    the variable-width storage formats; ``pack_bits`` is the size of the
    fixed-width unique-index pack the decode-fused kernel executes from
    (the weight traffic of the serving path)."""

    path: str
    n_weights: int
    codr_bits: int
    ucnn_bits: int
    scnn_bits: int
    density: float
    n_unique_mean: float
    pack_bits: int = 0

    @property
    def codr_bits_per_weight(self) -> float:
        return self.codr_bits / self.n_weights

    @property
    def pack_bits_per_weight(self) -> float:
        return self.pack_bits / self.n_weights


def compress_tensor(w: np.ndarray, *, n_unique: int = 256, t_m: int = 256
                    ) -> tuple[np.ndarray, dict]:
    """Offline CoDR pipeline for one (d_in, d_out) matrix.  Returns the
    dequantized-after-restriction tensor + size accounting."""
    q, scale = ucr.quantize_int8(w)
    q = ucr.restrict_unique(q, n_unique)
    # UCR per output-column-tile vector (linear layer = 1×1-kernel conv)
    ucrs = []
    m, n = q.shape[1], q.shape[0]       # weights stored (d_in, d_out)
    qt = q.T                            # (M=d_out, N=d_in)
    for m0 in range(0, m, t_m):
        tile = qt[m0 : m0 + t_m]
        for nn in range(n):
            ucrs.append(ucr.ucr_transform(tile[:, nn]))
    codr_bits = rle.layer_bits_size_only(ucrs, min(t_m, m))
    report = {
        "codr_bits": codr_bits,
        "ucnn_bits": ucnn_compress_bits(ucrs),
        "scnn_bits": scnn_compress_bits(q),
        "density": float((q != 0).mean()),
        "n_unique_mean": float(np.mean([len(u.unique_vals) for u in ucrs])),
        "pack_bits": int(q.size) * choose_bits(
            max(int(len(np.unique(q))), 2)),
    }
    deq = ucr.dequantize_int8(q, scale)
    return deq.astype(np.float32), report


def account_tensor(mat: np.ndarray, *, n_unique: int,
                   sample_rows: int | None) -> dict:
    """Sampled RLE/baseline accounting for one ``(rows, d_out)`` matrix:
    encode the leading ``sample_rows`` rows, scale the bit counts back up
    by the sampled fraction."""
    rows = mat.shape[0]
    if sample_rows and rows > sample_rows:
        sub, scale_f = mat[:sample_rows], rows / sample_rows
    else:
        sub, scale_f = mat, 1.0
    _, rep = compress_tensor(sub, n_unique=n_unique)
    out = {k: int(rep[k] * scale_f)
           for k in ("codr_bits", "ucnn_bits", "scnn_bits", "pack_bits")}
    out["density"] = rep["density"]
    out["n_unique_mean"] = rep["n_unique_mean"]
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def codr_compress_params(params, *, n_unique: int = 16,
                         sample_rows: int | None = 4096):
    """Compress every large 2-D+ leaf; returns ``(new_params, reports)``.

    ``sample_rows`` bounds the RLE accounting work per tensor (the
    leading rows of the ``(rows, d_out)`` reshape, scaled back up); the
    quantization is always applied to the full tensor."""
    reports = []

    def leaf_fn(path, leaf):
        if leaf.dim() < 2 or leaf.numel() < MIN_COMPRESS_SIZE:
            return leaf
        mat = leaf.reshape(-1, leaf.shape[-1])
        acc = account_tensor(_host(mat), n_unique=n_unique,
                             sample_rows=sample_rows)
        full_deq, _ = _quantize_only(mat, n_unique)
        reports.append(TensorReport(path=path, n_weights=leaf.numel(),
                                    **acc))
        return full_deq.reshape(leaf.shape).to(leaf.dtype)

    return map_with_path(leaf_fn, params), reports


def _quantize_only(mat: torch.Tensor, n_unique: int):
    q, scale, _ = quantize_restrict(mat, n_unique)
    return q.to(torch.float32) * scale, q


def codr_report(reports: list[TensorReport], *,
                per_tensor: bool = False) -> str:
    """Aggregate compression report; ``per_tensor=True`` appends one row
    per tensor (path, mean unique count, measured CoDR and pack
    bits/weight)."""
    tot_w = sum(r.n_weights for r in reports)
    tot_codr = sum(r.codr_bits for r in reports)
    tot_ucnn = sum(r.ucnn_bits for r in reports)
    tot_scnn = sum(r.scnn_bits for r in reports)
    tot_pack = sum(r.pack_bits for r in reports)
    lines = [
        f"CoDR weight compression over {len(reports)} tensors "
        f"({tot_w/1e6:.1f}M weights):",
        f"  CoDR : {tot_codr/tot_w:.2f} bits/weight "
        f"({16*tot_w/max(tot_codr,1):.1f}x vs bf16)",
        f"  UCNN : {tot_ucnn/tot_w:.2f} bits/weight "
        f"(CoDR {tot_ucnn/max(tot_codr,1):.2f}x better)",
        f"  SCNN : {tot_scnn/tot_w:.2f} bits/weight "
        f"(CoDR {tot_scnn/max(tot_codr,1):.2f}x better)",
    ]
    if tot_pack:
        lines.append(
            f"  pack : {tot_pack/tot_w:.2f} bits/weight fixed-width "
            f"unique-index pack (serving HBM traffic, "
            f"{16*tot_w/max(tot_pack,1):.1f}x vs bf16)")
    if per_tensor:
        lines.append(f"  {'tensor':<40} {'weights':>9} {'uniq':>6} "
                     f"{'codr b/w':>9} {'pack b/w':>9}")
        for r in reports:
            pack = (f"{r.pack_bits_per_weight:9.2f}" if r.pack_bits
                    else f"{'-':>9}")
            lines.append(f"  {r.path:<40} {r.n_weights:>9} "
                         f"{r.n_unique_mean:6.1f} "
                         f"{r.codr_bits_per_weight:9.2f} {pack}")
    return "\n".join(lines)


def codr_serving_stats(cfg, *, n_unique: int = 16, seed: int = 0,
                       reports: list[TensorReport] | None = None) -> dict:
    """Per-decode-token weight traffic under each format (GB).

    With ``reports`` (from a real ``codr_compress_params`` /
    ``compile_params`` run) bits/weight is measured from the model's own
    tensors; without, it is extrapolated from one synthetic 512×512
    Gaussian matrix — ``stats["source"]`` says which, and printers label
    the synthetic path as an estimate."""
    n_active = cfg.active_param_count()
    if reports:
        tot_w = sum(r.n_weights for r in reports)
        bits_pw = sum(r.codr_bits for r in reports) / tot_w
        pack_pw = sum(r.pack_bits for r in reports) / tot_w
        source = "measured"
    else:
        rng = np.random.default_rng(seed)
        w = rng.normal(size=(512, 512)).astype(np.float32) * 0.02
        _, rep = compress_tensor(w, n_unique=n_unique)
        bits_pw = rep["codr_bits"] / w.size
        pack_pw = rep["pack_bits"] / w.size
        source = "synthetic-estimate"
    return {
        "bf16_gb": n_active * 2 / 1e9,
        "int8_gb": n_active * 1 / 1e9,
        "codr_gb": n_active * bits_pw / 8 / 1e9,
        "codr_bits_per_weight": bits_pw,
        "pack_bits_per_weight": pack_pw,
        "source": source,
    }
