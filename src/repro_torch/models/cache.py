"""KV-cache slot pools for continuous batching — the port's copy of
``repro.models.cache``.

A *pool* is the tree returned by a model's ``init_cache(cfg, n_slots,
max_len)``: the batch axis doubles as the slot axis, so one pooled
``decode_step`` call advances every active request at once (with
per-row positions, see ``attention.decode_positions``).  The helpers
here move single-request caches in and out of that pool:

* ``diff_axes`` discovers, per leaf, which axis is the batch axis —
  structurally, by comparing a batch-1 and a batch-2 cache made on the
  ``meta`` device (stacked leaves put ``n_periods`` first; a prologue
  layer's leaves are unstacked).  A leaf is any per-token buffer: GQA's
  ``(k, v)`` of ``(…, Hkv, D)`` or MLA's ``(ckv, krot)`` of ``(…, c)``
  and ``(…, dr)``.
* ``write_slot`` block-writes a batch-1 cache (e.g. a prefill result at
  seq length P) into slot ``i`` of the pool.  Shorter-than-pool seq
  axes are written at offset 0: decode attention masks positions beyond
  the slot's own ``pos``, so the stale tail is inert and results stay
  bit-identical to a solo decode.
* ``read_slot`` extracts slot ``i`` back out as a batch-1 cache.

Paged mode replaces the contiguous per-slot sequence buffers with
:class:`PagedKV` leaves: a shared pool of fixed-size pages plus a
per-slot page table.  Storage is int8 with one scale per page
(requantized whenever a new row grows the page maximum) or bf16, in
which case the gathered cache is bit-identical to the contiguous one.
Physical page 0 is a reserved *scratch* page: retired and never-admitted
slots point every table entry at it, so the pooled decode step — which
advances all slots, active or not — lands its dead writes there instead
of in a page that may already belong to a new request.  Several
inactive slots write the scratch page in one step, in no defined order
on the card; that is harmless because no live slot reads page 0 below
its length.

As everywhere in the port, writes happen in place (the reference
returns new arrays); the functions return the pool they wrote.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import leaves_with_path, map_with_path

__all__ = ["diff_axes", "write_slot", "read_slot", "SCRATCH_PAGE",
           "PagedSpec", "PagedKV", "paged_kv_init", "write_slot_paged",
           "set_tables", "PagePool"]


def _zip_map(fn, tree, *others):
    """``fn(leaf, *matching leaves)`` over trees of one structure
    (leaves matched by path)."""
    other_leaves = [dict(leaves_with_path(t)) for t in others]
    return map_with_path(
        lambda path, leaf: fn(leaf, *(o[path] for o in other_leaves)), tree)


def diff_axes(tree_a, tree_b):
    """Per-leaf axis where ``tree_a`` and ``tree_b`` shapes differ.

    Both trees must share their structure; each leaf pair must differ
    along exactly one axis (leaves with identical shapes are rejected —
    the batch axis must be discoverable).  Returns a tree of ints with
    the same structure.  Feed it caches made on the ``meta`` device so
    no memory is allocated::

        ax = diff_axes(init(1, device="meta"), init(2, device="meta"))
    """
    def one(la, lb):
        if la.dim() != lb.dim():
            raise ValueError(f"rank mismatch {tuple(la.shape)} vs "
                             f"{tuple(lb.shape)}")
        diffs = [i for i, (a, b) in enumerate(zip(la.shape, lb.shape))
                 if a != b]
        if len(diffs) != 1:
            raise ValueError(
                f"need exactly one differing axis, got {tuple(la.shape)} "
                f"vs {tuple(lb.shape)}")
        return diffs[0]
    return _zip_map(one, tree_a, tree_b)


def _region(leaf: torch.Tensor, shape, ax: int, slot: int):
    """The view of ``leaf`` that a batch-1 leaf of ``shape`` occupies at
    slot ``slot`` (offset 0 on every other axis)."""
    idx = [slice(0, n) for n in shape]
    idx[ax] = slice(slot, slot + 1)
    return leaf[tuple(idx)]


def write_slot(pool, cache, slot: int, axes):
    """Write batch-1 ``cache`` into ``pool`` at slot index ``slot``, in
    place; returns ``pool``.

    ``axes`` is the ``diff_axes`` tree locating each leaf's slot axis.
    Leaves whose non-slot dims are shorter than the pool's (a seq-P
    prefill cache into a seq-max pool) land at offset 0, leaving the
    pool's tail untouched — masked out by decode attention."""
    def one(pl, cl, ax):
        _region(pl, cl.shape, ax, int(slot)).copy_(cl)
    _zip_map(one, pool, cache, axes)
    return pool


def read_slot(pool, slot: int, axes):
    """Slot ``slot`` of ``pool`` as a batch-1 cache (full pool sequence
    length — callers mask by position, they don't trim); a copy."""
    return _zip_map(lambda pl, ax: pl.narrow(ax, int(slot), 1).clone(),
                    pool, axes)


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------

SCRATCH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Geometry of a paged KV pool (host-side, static).

    ``n_pages`` counts *physical* pages including the reserved scratch
    page 0; the default provisions every slot's worst case so admission
    can never fail on pages alone.
    """

    page_size: int
    max_len: int
    n_slots: int
    kv_dtype: str = "int8"          # "int8" | "bf16"
    n_pages: int | None = None

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.kv_dtype not in ("int8", "bf16"):
            raise ValueError(f"kv_dtype must be 'int8' or 'bf16', "
                             f"got {self.kv_dtype!r}")

    @property
    def max_pages(self) -> int:
        """Logical pages per slot (the page-table row length)."""
        return -(-self.max_len // self.page_size)

    @property
    def total_pages(self) -> int:
        n = self.n_pages if self.n_pages is not None \
            else 1 + self.n_slots * self.max_pages
        if n < 1 + self.max_pages:
            raise ValueError(
                f"n_pages={n} cannot hold even one request "
                f"({self.max_pages} pages + scratch)")
        return n

    def pages_for(self, total_len: int) -> int:
        """Pages a request of ``total_len`` tokens must reserve."""
        return min(self.max_pages, -(-total_len // self.page_size))


@dataclasses.dataclass
class PagedKV:
    """One paged KV buffer: page data + per-page scales + page tables.

    ``data``  ``(*lead, n_pages, page_size, *feat)`` int8 (quantized) or
              the cache dtype.
    ``scale`` ``(*lead, n_pages)`` f32 — per-page dequant scale (int8).
    ``table`` ``(*lead, n_slots, max_pages)`` int32 physical-page ids.

    ``lead`` is the layer stack (``n_periods``) of a model's pool;
    indexing a stacked buffer (``pkv[i]``) gives layer ``i``'s buffer as
    views of the same storage, so its in-place writes land in the pool.
    """

    data: torch.Tensor
    scale: torch.Tensor
    table: torch.Tensor
    page_size: int
    seq_len: int                     # logical max_len — gather crops to it
    quantized: bool

    def __getitem__(self, i: int) -> "PagedKV":
        return dataclasses.replace(self, data=self.data[i],
                                   scale=self.scale[i], table=self.table[i])

    def tensors(self) -> tuple[torch.Tensor, ...]:
        return (self.data, self.scale, self.table)

    # -- decode-step write ---------------------------------------------------
    def update(self, new: torch.Tensor, pos) -> "PagedKV":
        """Write one new token row per slot at position ``pos``, in place.

        ``new`` is ``(B, 1, *feat)`` (``cache_update`` semantics),
        ``pos`` an int or a ``(B,)`` tensor; ``B`` must equal the
        table's slot count.  int8 pages requantize under a grow-only
        scale: ``new_scale = max(old_scale, amax(row)/127)``, so earlier
        rows of the page are re-rounded only when the running maximum
        grows (float32 throughout, round half to even).
        """
        b = new.shape[0]
        dev = self.data.device
        pos = torch.as_tensor(pos, dtype=torch.int64, device=dev)
        if pos.dim() == 0:
            pos = pos.expand(b)
        rows = torch.arange(b, device=dev)
        off = pos % self.page_size
        phys = self.table[rows, pos // self.page_size]           # (B,)
        row = new[:, 0]                                          # (B, *feat)
        if not self.quantized:
            self.data[phys, off] = row.to(self.data.dtype)
            return self
        feat_axes = tuple(range(1, row.dim()))
        bshape = (b,) + (1,) * len(feat_axes)
        rowf = row.to(torch.float32)
        amax = rowf.abs().amax(dim=feat_axes)                    # (B,)
        old_s = self.scale[phys]
        new_s = torch.maximum(old_s, amax / 127.0)
        safe = torch.where(new_s > 0, new_s, torch.ones_like(new_s))
        page = self.data[phys].to(torch.float32) \
            * old_s.reshape(bshape)[:, None]                     # (B, ps, *feat)
        page[rows, off] = rowf
        q = torch.clamp(torch.round(page / safe.reshape(bshape)[:, None]),
                        -127, 127).to(torch.int8)
        self.data[phys] = q
        self.scale[phys] = new_s
        return self

    # -- dense view for attention --------------------------------------------
    def gather(self) -> torch.Tensor:
        """Dequantized contiguous ``(n_slots, seq_len, *feat)`` view.

        bf16 mode skips the scale multiply entirely — the result holds
        the exact bytes a contiguous bf16 cache would, which is what
        makes ``kv_dtype="bf16"`` paged bit-identical to unpaged."""
        d = self.data[self.table]                # (S, mp, ps, *feat)
        feat = d.shape[3:]
        if self.quantized:
            s = self.scale[self.table]           # (S, mp)
            s = s.reshape(s.shape + (1,) * (1 + len(feat)))
            d = (d.to(torch.float32) * s).to(torch.bfloat16)
        d = d.reshape(d.shape[0], -1, *feat)
        return d[:, :self.seq_len]

    @property
    def n_slots(self) -> int:
        return self.table.shape[-2]


def paged_kv_init(spec: PagedSpec, feat: tuple, dtype=torch.bfloat16, *,
                  lead: tuple = (), device=None) -> PagedKV:
    """Fresh all-scratch paged buffer for one KV tensor of ``*feat``
    (``lead`` stacks it over the layers)."""
    lead = tuple(lead)
    dt = torch.int8 if spec.kv_dtype == "int8" else dtype
    return PagedKV(
        data=torch.zeros(lead + (spec.total_pages, spec.page_size)
                         + tuple(feat), dtype=dt, device=device),
        scale=torch.zeros(lead + (spec.total_pages,), dtype=torch.float32,
                          device=device),
        table=torch.zeros(lead + (spec.n_slots, spec.max_pages),
                          dtype=torch.int32, device=device),
        page_size=spec.page_size,
        seq_len=spec.max_len,
        quantized=spec.kv_dtype == "int8")


def _write_prefill_one(pkv: PagedKV, dense: torch.Tensor, slot: int,
                       pages: torch.Tensor) -> None:
    """Write a batch-1 seq-P prefill leaf into ``pages`` of ``pkv``.

    ``pages`` is the slot's full ``(max_pages,)`` table row (tail
    entries scratch).  int8 pages get a fresh per-page scale; the
    scales of reserved-but-unwritten pages (and of the scratch page)
    reset to 0 so the first decode write into them starts from a clean
    slate regardless of the previous tenant's bytes."""
    p_len = dense.shape[1]
    ps = pkv.page_size
    n_pg = -(-p_len // ps)
    feat = tuple(dense.shape[2:])
    rows = torch.zeros((n_pg * ps,) + feat, dtype=dense.dtype,
                       device=dense.device)
    rows[:p_len] = dense[0]
    rows = rows.reshape((n_pg, ps) + feat)
    tgt = pages[:n_pg]
    if pkv.quantized:
        rf = rows.to(torch.float32)
        amax = rf.abs().amax(dim=tuple(range(1, rf.dim())))
        s = amax / 127.0
        safe = s.reshape((n_pg,) + (1,) * (1 + len(feat)))
        safe = torch.where(safe > 0, safe, torch.ones_like(safe))
        q = torch.clamp(torch.round(rf / safe), -127, 127).to(torch.int8)
        pkv.data[tgt] = q
        pkv.scale[pages] = 0.0
        pkv.scale[tgt] = s
        pkv.scale[SCRATCH_PAGE] = 0.0
    else:
        pkv.data[tgt] = rows.to(pkv.data.dtype)
    pkv.table[slot] = pages


def write_slot_paged(pool, cache, slot: int, pages):
    """Paged counterpart of :func:`write_slot`, in place; returns
    ``pool``.

    ``pool`` holds :class:`PagedKV` leaves (possibly stacked over the
    layers); ``cache`` is the matching batch-1 dense prefill cache;
    ``pages`` is the slot's ``(max_pages,)`` physical-page row."""
    def one(pkv, dense):
        row = torch.as_tensor(pages, dtype=torch.int32,
                              device=pkv.table.device)
        if pkv.table.dim() == 3:     # stacked over the layers
            for li in range(pkv.table.shape[0]):
                _write_prefill_one(pkv[li], dense[li], int(slot), row)
        else:
            _write_prefill_one(pkv, dense, int(slot), row)
    _zip_map(one, pool, cache)
    return pool


def set_tables(pool, table):
    """Overwrite every leaf's page table with host-side ``table``, in
    place; returns ``pool``.

    The batcher owns the table on the host (admission allocates, EOS
    retirement frees by repointing rows at scratch); this pushes the
    authoritative copy into the device pool before each decode step."""
    def one(_, pkv):
        if isinstance(pkv, PagedKV):
            t = torch.as_tensor(table, dtype=torch.int32)
            pkv.table.copy_(t.expand(pkv.table.shape))
    map_with_path(one, pool)
    return pool


class PagePool:
    """Host-side free-list allocator over a :class:`PagedSpec`.

    Page 0 (scratch) is never handed out.  ``alloc`` is all-or-nothing
    so a request either reserves its whole worst case at admission or
    stays pending — no mid-stream out-of-pages."""

    def __init__(self, spec: PagedSpec):
        self.spec = spec
        self._free = list(range(spec.total_pages - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages) -> None:
        for p in pages:
            if p != SCRATCH_PAGE:
                self._free.append(int(p))
