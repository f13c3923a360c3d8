"""CoDR-compressed linear layers for the port's transformer lane — the
torch counterpart of ``repro.core.codr_linear``.

The serving representation is the **fixed-width unique-index pack**:
weights stored as ``b``-bit indices into a per-tensor sorted table of the
int8 levels present, packed 32/b to a word, ``b ∈ {1, 2, 4, 8, 16}``;
the device reads ``b/8`` bytes per weight.  :class:`PackedLinear` is the
projection leaf a params tree holds after
:func:`repro_torch.core.api.compile_params`, :class:`PackedEmbedding` the
row-gatherable vocabulary table.

Words are carried as **int32 bit patterns** of the reference's uint32
words (torch's ``uint32`` has too few ops): a right shift of a word with
its top bit set fills with ones, so every shift is followed by a mask.
``packed.numpy().view(np.uint32)`` gives the reference's bytes.

Encoding runs in torch on the leaf's own device with the reference's
arithmetic — float32 divide by the scale, round half to even, clip,
int8; the integer re-grid of ``restrict_unique``; the levels present
from a 256-bin count in place of ``np.unique``/``searchsorted`` — so a
full-width model encodes on the card in seconds and the packs are
byte-identical to ``repro.core.codr_linear``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["PackedWeight", "PackedLinear", "PackedEmbedding", "pack_unique",
           "pack_projection", "pack_embedding", "unpack_unique",
           "dense_weight", "codr_matmul_ref", "choose_bits",
           "quantize_restrict"]

_CHUNK = 1 << 24          # elements per encode pass (bounds the temporaries)
_DECODE_CHUNK = 1 << 26   # weights per batched decode pass


@dataclasses.dataclass
class PackedWeight:
    """Fixed-width unique-index packed weight for a (K, N) matrix.

    The tensors may carry extra *leading* stack dims (the ``"stack"``
    axis of the layer loop); ``shape`` is always the per-matrix
    ``(K, N_padded)`` geometry, and ``w[i]`` is matrix ``i`` of a stack.
    """

    packed: torch.Tensor   # (..., K, N * bits // 32) int32 word bit patterns
    table: torch.Tensor    # (..., 2**bits) unique values (zero-padded)
    scale: torch.Tensor    # per-tensor (leading-dims broadcast) float32 scale
    bits: int
    shape: tuple[int, int]

    @property
    def hbm_bytes(self) -> int:
        return (self.packed.numel() * 4
                + self.table.numel() * self.table.element_size()
                + self.scale.numel() * 4)

    @property
    def dense_bf16_bytes(self) -> int:
        lead = int(np.prod(tuple(self.packed.shape[:-2]), dtype=np.int64))
        return lead * int(np.prod(self.shape)) * 2

    @property
    def compression_vs_bf16(self) -> float:
        return self.dense_bf16_bytes / self.hbm_bytes

    def __getitem__(self, i: int) -> "PackedWeight":
        """Matrix ``i`` of a stacked pack (views, no copy)."""
        if self.packed.dim() < 3:
            raise ValueError(f"not a stacked pack: packed has shape "
                             f"{tuple(self.packed.shape)}")
        return PackedWeight(self.packed[i], self.table[i], self.scale[i],
                            self.bits, self.shape)


def choose_bits(n_unique: int) -> int:
    """Smallest index width covering ``n_unique`` values.  Widths are
    restricted to divisors of 32 (clean word packing)."""
    for b in (1, 2, 4, 8, 16):
        if n_unique <= (1 << b):
            return b
    raise ValueError(f"too many unique values: {n_unique}")


# ---------------------------------------------------------------------------
# encoding (torch, on the leaf's device)
# ---------------------------------------------------------------------------

def _as_tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def _restrict(q: torch.Tensor, n_unique: int) -> torch.Tensor:
    """``ucr.restrict_unique`` on an int32 tensor of int8 levels: the
    uniform re-grid to ``n_unique`` levels including zero, 0 kept 0."""
    if n_unique >= 256:
        return q
    step = -(-256 // (n_unique - 1))
    out = torch.div(q + 128, step, rounding_mode="floor") * step - 128 \
        + step // 2
    return torch.where(q == 0, 0, out.clamp(-127, 127))


def _present(q_flat: torch.Tensor, present: torch.Tensor) -> None:
    """OR the int8 levels occurring in ``q_flat`` into the 256-entry
    ``present`` mask (level ``v`` at index ``v + 128``)."""
    present |= torch.bincount(q_flat.to(torch.int64) + 128,
                              minlength=256) > 0


def quantize_restrict(w, n_unique: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``ucr.quantize_int8`` (symmetric, per-tensor) then
    ``ucr.restrict_unique`` over the whole of ``w``, in torch on its
    device.  Returns ``(q int8 of w's shape, 0-d float32 scale, present)``
    with ``present`` the 256-entry mask of the levels in ``q``."""
    w = _as_tensor(w)
    flat = w.reshape(-1)
    lo, hi = torch.aminmax(flat.to(torch.float32))
    amax = torch.maximum(-lo, hi)
    scale = torch.where(amax > 0, amax / 127.0, 1.0).to(torch.float32)
    q = torch.empty(flat.shape, dtype=torch.int8, device=w.device)
    present = torch.zeros(256, dtype=torch.bool, device=w.device)
    for s in range(0, flat.numel(), _CHUNK):
        part = torch.round(flat[s:s + _CHUNK].to(torch.float32) / scale)
        part = _restrict(part.clamp(-127, 127).to(torch.int32), n_unique)
        q[s:s + _CHUNK] = part.to(torch.int8)
        _present(part, present)
    return q.reshape(w.shape), scale, present


def _pack_indices(q: torch.Tensor, present: torch.Tensor, bits: int
                  ) -> torch.Tensor:
    """``(..., K, N)`` int8 levels → ``(..., K, ceil(N/pw))`` int32 words
    of their indices into the sorted table of present levels; the output
    features are padded to a whole word with index 0."""
    per_word = 32 // bits
    *lead, k, n = q.shape
    pad = (-n) % per_word
    lut = torch.cumsum(present.to(torch.int64), 0) - 1   # level → index
    shifts = torch.arange(per_word, dtype=torch.int64,
                          device=q.device) * bits
    rows = q.reshape(-1, n)
    out = torch.empty(rows.shape[0], (n + pad) // per_word,
                      dtype=torch.int32, device=q.device)
    step = max(1, _CHUNK // max(n, 1))
    for r in range(0, rows.shape[0], step):
        idx = lut[rows[r:r + step].to(torch.int64) + 128]
        if pad:                # padded columns decode to table[0], cropped
            idx = torch.nn.functional.pad(idx, (0, pad))
        words = (idx.reshape(idx.shape[0], -1, per_word) << shifts).sum(-1)
        out[r:r + step] = torch.where(words >= 1 << 31, words - (1 << 32),
                                      words).to(torch.int32)
    return out.reshape(*lead, k, (n + pad) // per_word)


def _table(present: torch.Tensor, bits: int, dtype) -> torch.Tensor:
    levels = torch.nonzero(present).reshape(-1) - 128
    table = torch.zeros(1 << bits, dtype=torch.float32,
                        device=present.device)
    table[: levels.numel()] = levels.to(torch.float32)
    return table.to(dtype)


def pack_unique(q, scale, dtype=torch.bfloat16) -> PackedWeight:
    """Pack an int8 (K, N) weight matrix into the unique-index format
    (tensors on ``q``'s device; a NumPy ``q`` packs on the CPU)."""
    q = _as_tensor(q)
    if q.dim() != 2:
        raise ValueError(f"pack_unique needs a (K, N) matrix, got shape "
                         f"{tuple(q.shape)}")
    k, n = q.shape
    present = torch.zeros(256, dtype=torch.bool, device=q.device)
    _present(q.reshape(-1), present)
    bits = choose_bits(int(present.sum()))
    per_word = 32 // bits
    if n % per_word:
        raise ValueError(f"N={n} not divisible by {per_word} ({bits}-bit "
                         f"pack)")
    return PackedWeight(
        packed=_pack_indices(q, present, bits),
        table=_table(present, bits, dtype),
        scale=torch.as_tensor(scale, dtype=torch.float32, device=q.device),
        bits=bits, shape=(k, n))


def unpack_unique(packed: torch.Tensor, table: torch.Tensor, *, bits: int,
                  n: int) -> torch.Tensor:
    """Decode packed indices → dense (K, n) weight matrix (table gather),
    in the table's dtype."""
    idx = _unpack_idx(packed, bits).reshape(packed.shape[0], n)
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(idx.shape)


def _unpack_idx(words: torch.Tensor, bits: int) -> torch.Tensor:
    """``(..., W)`` int32 words → ``(..., W, 32/bits)`` int32 indices."""
    per_word = 32 // bits
    shifts = torch.arange(per_word, dtype=torch.int32,
                          device=words.device) * bits
    return (words[..., None] >> shifts) & ((1 << bits) - 1)


def codr_matmul_ref(x: torch.Tensor, w: PackedWeight) -> torch.Tensor:
    """Reference decode-then-matmul (the kernel fuses these)."""
    dense = unpack_unique(w.packed, w.table, bits=w.bits, n=w.shape[1])
    y = x.to(torch.float32) @ dense.to(torch.float32)
    return (y * w.scale).to(x.dtype)


# ---------------------------------------------------------------------------
# packed projection leaves — the transformer serving representation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedLinear:
    """A projection weight in packed form, as a params leaf: the
    :class:`PackedWeight` (possibly stacked), the logical output-feature
    count (the pack pads the output dim to a whole word) and the name of
    the registered backend whose ``matmul`` executes it.
    ``repro_torch.models.common.linear`` routes these leaves through
    :mod:`repro_torch.core.backends`."""

    weight: PackedWeight
    out_features: int
    backend: str = "codr_matmul"

    @property
    def in_features(self) -> int:
        return self.weight.shape[0]

    @property
    def hbm_bytes(self) -> int:
        return self.weight.hbm_bytes

    @property
    def n_weights(self) -> int:
        lead = int(np.prod(tuple(self.weight.packed.shape[:-2]),
                           dtype=np.int64))
        return lead * self.weight.shape[0] * self.out_features

    def __getitem__(self, i: int) -> "PackedLinear":
        """Matrix ``i`` of a stacked projection — what the layer loop
        hands to the backend (``lax.scan`` slices the stack in JAX)."""
        return PackedLinear(self.weight[i], self.out_features, self.backend)

    def dense(self, dtype=torch.float32) -> torch.Tensor:
        """Decode to the dequantized dense weight — bit-for-bit
        ``dequantize_int8(restrict_unique(q, U), scale)`` of the original
        leaf in float32, the quantize-applied reference lane's weight,
        then cast to ``dtype``.

        Every matrix of a stacked leaf (an expert stack) decodes in one
        batched pass through a lookup table per matrix that maps one
        byte of packed words (``8/bits`` indices; a 16-bit index at 16
        bits) to its ``table[i] * scale`` products, float32 as the
        reference computes them, cast to ``dtype``.  Slabs of matrices
        bound the temporaries; the result is one ``(*lead, K,
        out_features)`` tensor of ``dtype``."""
        pw = self.weight
        k, n_pad = pw.shape
        n = self.out_features
        lead = tuple(pw.packed.shape[:-2])
        words = pw.packed.reshape((-1,) + tuple(pw.packed.shape[-2:]))
        tables = pw.table.reshape(-1, pw.table.shape[-1])
        scales = pw.scale.reshape(-1, 1).to(torch.float32)
        if pw.bits == 16:                   # one index a 16-bit unit
            units = words.view(torch.int16)
            lut = tables.to(torch.float32) * scales          # (J, 2^16)
            lut = lut.reshape(-1, 1 << 16, 1)
        else:                               # 8/bits indices a byte
            units = words.view(torch.uint8)
            per = 8 // pw.bits
            byte = torch.arange(256, device=words.device)
            shifts = torch.arange(per, device=words.device) * pw.bits
            idx = (byte[:, None] >> shifts) & ((1 << pw.bits) - 1)
            lut = tables.to(torch.float32)[:, idx] * scales[:, :, None]
        lut = lut.to(dtype)                          # (J, values, per)
        n_vals, per = lut.shape[1], lut.shape[2]
        lut = lut.reshape(-1, per)
        out = torch.empty((words.shape[0], k, n), dtype=dtype,
                          device=words.device)
        step = max(1, _DECODE_CHUNK // max(k * n_pad, 1))
        for s in range(0, words.shape[0], step):
            j = min(step, words.shape[0] - s)
            # each unit's row of the table of its own matrix
            base = (torch.arange(s, s + j, dtype=torch.int32,
                                 device=words.device) * n_vals)
            if pw.bits == 16:               # int16 units sign-extend
                u = (units[s:s + j].to(torch.int32) & 0xFFFF).add_(
                    base.reshape(-1, 1, 1))
            else:
                u = torch.add(units[s:s + j], base.reshape(-1, 1, 1))
            u = u.reshape(-1)
            if n == n_pad:                  # straight into the result
                torch.index_select(lut, 0, u,
                                   out=out[s:s + j].view(-1, per))
            else:
                vals = torch.index_select(lut, 0, u)
                out[s:s + j] = vals.reshape(j, k, n_pad)[..., :n]
        return out.reshape(lead + (k, n))


def dense_weight(w, dtype=None):
    """Decode a :class:`PackedLinear` to its dense dequantized form
    (float32, or ``dtype`` with the bits of the float32 form cast); pass
    plain tensors through (cast to ``dtype`` if given)."""
    if isinstance(w, PackedLinear):
        return w.dense(torch.float32 if dtype is None else dtype)
    return w if dtype is None else w.to(dtype)


def pack_projection(w, *, n_unique: int = 16,
                    backend: str = "codr_matmul") -> PackedLinear:
    """Offline-encode one float projection leaf ``(..., K, N)`` into packed
    form, on ``w``'s device.  Leading dims are a stack of ``(K, N)``
    matrices sharing one quantization over the whole leaf (as
    ``serving.codr_compress_params`` quantizes it), with the shared table
    and scale broadcast over the stack."""
    w = _as_tensor(w)
    if w.dim() < 2:
        raise ValueError(f"pack_projection needs a (..., K, N) matrix, "
                         f"got shape {tuple(w.shape)}")
    *lead, k, n = w.shape
    q, scale, present = quantize_restrict(w, n_unique)
    bits = choose_bits(max(int(present.sum()), 2))
    packed = _pack_indices(q, present, bits)
    del q
    table = _table(present, bits, torch.float32)
    lead = tuple(lead)
    if lead:
        table = table.expand(lead + table.shape).contiguous()
        scale = scale.expand(lead).contiguous()
    pw = PackedWeight(packed=packed, table=table, scale=scale, bits=bits,
                      shape=(k, packed.shape[-1] * (32 // bits)))
    return PackedLinear(pw, out_features=n, backend=backend)


# ---------------------------------------------------------------------------
# packed embedding leaves — row-gatherable vocabulary tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedEmbedding:
    """A ``(V, d)`` embedding table in packed form, gathered by token id:
    a lookup touches ``d * bits / 8`` bytes per token."""

    weight: PackedWeight
    d_model: int                 # logical row width (pack pads to a word)
    backend: str = "codr_matmul"

    @property
    def vocab_size(self) -> int:
        return self.weight.shape[0]

    @property
    def hbm_bytes(self) -> int:
        return self.weight.hbm_bytes

    @property
    def n_weights(self) -> int:
        return self.weight.shape[0] * self.d_model

    def lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        """Gather + decode rows for ``tokens`` (any int shape), float32;
        bit-for-bit equal to indexing the quantize-applied dense table."""
        pw = self.weight
        rows = torch.index_select(pw.packed, 0, tokens.reshape(-1))
        idx = _unpack_idx(rows, pw.bits).reshape(-1)
        vals = torch.index_select(pw.table, 0, idx).reshape(
            tuple(tokens.shape) + (pw.shape[1],))
        return vals.to(torch.float32)[..., : self.d_model] * pw.scale

    def dense(self) -> torch.Tensor:
        """The whole table, dequantized ``(V, d)`` float32 (what the
        unembed logit projection consumes)."""
        pw = self.weight
        dec = unpack_unique(pw.packed, pw.table, bits=pw.bits, n=pw.shape[1])
        return dec.to(torch.float32)[:, : self.d_model] * pw.scale


def pack_embedding(w, *, n_unique: int = 16,
                   backend: str = "codr_matmul") -> PackedEmbedding:
    """Offline-encode one ``(V, d)`` embedding leaf into row-gatherable
    packed form; quantization identical to :func:`pack_projection`."""
    w = _as_tensor(w)
    if w.dim() != 2:
        raise ValueError(f"pack_embedding needs a (V, d) table, "
                         f"got shape {tuple(w.shape)}")
    pl = pack_projection(w, n_unique=n_unique, backend=backend)
    return PackedEmbedding(pl.weight, d_model=w.shape[1], backend=backend)
