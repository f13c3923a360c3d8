"""The packed checkpoint artifact — the port's copy of
``repro.checkpoint.packed``: compress once offline, map at boot.

``save_packed(compiled, path)`` serializes a
:class:`repro_torch.core.api.CompiledParams` — the packed words, tables
and scales of every ``PackedLinear`` / ``PackedEmbedding`` leaf, the
remaining dense leaves, the :class:`~repro_torch.core.api.EncodeConfig`
and the per-tensor accounting reports — into one directory, in the
reference's on-disk format, byte for byte:

* ``manifest.json`` — magic, format version, config, tree skeleton (a
  recursive dict/list/tuple/leaf encoding), per-array dtype/shape,
  paths, plan, reports.
* ``arr_N.npy`` — one file per array.  Packed words are stored as the
  ``uint32`` view of the port's int32 bit patterns (the reference's
  words), bfloat16 as its ``uint16`` bit patterns.

An artifact either package wrote boots in the other.  Writes are atomic:
everything lands in ``<path>.tmp``, the manifest is fsync'd, then one
``os.rename`` publishes the artifact.  ``load_packed`` is the exact
inverse — the same packed bytes, so the same logits bits — and maps the
array files (``mmap=True``) before copying them to ``device`` (the card
unless the caller names another).

Every unreadable artifact raises :class:`PackedCheckpointError` naming
what is wrong.  A compiled model's :class:`~repro_torch.tune.TunePlan`
goes into the manifest as ``plan.to_json()`` and comes back through
``TunePlan.from_json``; a plain ``{path: EncodeConfig}`` dict plan has
no serialized form, and ``save_packed`` raises ``TypeError`` for it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.engine import resolve_device

__all__ = ["CODR_FORMAT_VERSION", "PackedCheckpointError", "build_manifest",
           "save_packed", "load_packed"]

CODR_FORMAT_VERSION = 1
_MAGIC = "codr-packed"
_BF16 = "bfloat16"


class PackedCheckpointError(ValueError):
    """A packed checkpoint is unreadable: missing/truncated files,
    format-version mismatch, or on-disk bytes that contradict the
    manifest (wrong dtype/shape)."""


# ---------------------------------------------------------------------------
# tree <-> manifest encoding
# ---------------------------------------------------------------------------

def _stored(x, *, words: bool = False) -> tuple[np.ndarray, str]:
    """A leaf as ``(host array as stored, manifest dtype)``: packed words
    as ``uint32``, bfloat16 as its ``uint16`` bit patterns."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(x)
    if words:
        a = a.view(np.uint32)
    return a, str(a.dtype)


def _encode_tree(node, arrays: list, metas: list):
    """Encode a params tree into JSON nodes, appending its arrays (as
    stored) and their manifest entries — the reference's encoding, node
    for node."""
    from repro_torch.core.codr_linear import PackedEmbedding, PackedLinear

    def ref(x, words=False):
        a, dtype = _stored(x, words=words)
        arrays.append(a)
        metas.append({"dtype": dtype, "shape": list(a.shape)})
        return len(arrays) - 1

    def enc_pw(pw) -> dict:
        return {"packed": ref(pw.packed, words=True), "table": ref(pw.table),
                "scale": ref(pw.scale), "bits": int(pw.bits),
                "shape": [int(s) for s in pw.shape]}

    if isinstance(node, PackedLinear):
        return {"kind": "packed_linear", "weight": enc_pw(node.weight),
                "out_features": int(node.out_features),
                "backend": node.backend}
    if isinstance(node, PackedEmbedding):
        return {"kind": "packed_embedding", "weight": enc_pw(node.weight),
                "d_model": int(node.d_model), "backend": node.backend}
    if isinstance(node, dict):
        return {"kind": "dict",
                "items": {k: _encode_tree(v, arrays, metas)
                          for k, v in node.items()}}
    if isinstance(node, (list, tuple)):
        return {"kind": "list" if isinstance(node, list) else "tuple",
                "items": [_encode_tree(v, arrays, metas) for v in node]}
    return {"kind": "array", "ref": ref(node)}


def _tensor(a: np.ndarray, meta: dict, device: torch.device, *,
            words: bool = False) -> torch.Tensor:
    """A loaded array as a tensor on ``device``: bfloat16 from its bit
    patterns, packed words as int32 bit patterns."""
    if meta["dtype"] == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if words:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _decode_tree(node: dict, arrays: list, metas: list,
                 device: torch.device):
    from repro_torch.core.codr_linear import (PackedEmbedding, PackedLinear,
                                              PackedWeight)

    def get(i, words=False):
        return _tensor(arrays[i], metas[i], device, words=words)

    def dec_pw(d: dict) -> PackedWeight:
        return PackedWeight(packed=get(d["packed"], words=True),
                            table=get(d["table"]), scale=get(d["scale"]),
                            bits=int(d["bits"]), shape=tuple(d["shape"]))

    kind = node["kind"]
    if kind == "packed_linear":
        return PackedLinear(dec_pw(node["weight"]),
                            out_features=int(node["out_features"]),
                            backend=node["backend"])
    if kind == "packed_embedding":
        return PackedEmbedding(dec_pw(node["weight"]),
                               d_model=int(node["d_model"]),
                               backend=node["backend"])
    if kind == "dict":
        return {k: _decode_tree(v, arrays, metas, device)
                for k, v in node["items"].items()}
    if kind == "list":
        return [_decode_tree(v, arrays, metas, device)
                for v in node["items"]]
    if kind == "tuple":
        return tuple(_decode_tree(v, arrays, metas, device)
                     for v in node["items"])
    if kind == "array":
        return get(node["ref"])
    raise PackedCheckpointError(f"unknown tree node kind {kind!r}")


def _load_array(path: str, meta: dict, *, mmap: bool) -> np.ndarray:
    try:
        # copy-on-write mapping: writable for torch, never written back
        a = np.load(path, mmap_mode="c" if mmap else None)
    except Exception as e:
        raise PackedCheckpointError(
            f"packed checkpoint array {os.path.basename(path)} is "
            f"unreadable (truncated or corrupt): {e}") from e
    if meta["dtype"] == _BF16:
        if a.dtype != np.uint16:
            raise PackedCheckpointError(
                f"{os.path.basename(path)}: expected uint16 storage for "
                f"a bfloat16 array, found {a.dtype}")
    elif str(a.dtype) != meta["dtype"]:
        raise PackedCheckpointError(
            f"{os.path.basename(path)}: on-disk dtype {a.dtype} does not "
            f"match the manifest's {meta['dtype']} — the artifact is "
            f"corrupt or was written by an incompatible encoder")
    if list(a.shape) != meta["shape"]:
        raise PackedCheckpointError(
            f"{os.path.basename(path)}: on-disk shape {list(a.shape)} "
            f"does not match the manifest's {meta['shape']}")
    return a


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def build_manifest(compiled) -> tuple[dict, list]:
    """Pure encoding half of :func:`save_packed`: ``(manifest,
    host_arrays)`` without touching the filesystem, the arrays as they
    are stored (bfloat16 as ``uint16``, packed words as ``uint32``)."""
    plan = getattr(compiled, "plan", None)
    if plan is not None and not hasattr(plan, "to_json"):
        raise TypeError(
            f"save_packed: a {type(plan).__name__} plan cannot be "
            f"serialized; compile with a repro_torch.tune.TunePlan (e.g. "
            f"from tune_params) to keep the plan in the artifact")
    arrays: list[np.ndarray] = []
    metas: list[dict] = []
    tree = _encode_tree(compiled.params, arrays, metas)
    manifest = {
        "magic": _MAGIC,
        "format_version": CODR_FORMAT_VERSION,
        "config": compiled.config.metadata(),
        "backend": compiled.backend,
        "packed_paths": list(compiled.packed_paths),
        "quantized_paths": list(compiled.quantized_paths),
        "embed_paths": list(getattr(compiled, "embed_paths", [])),
        "reports": [dataclasses.asdict(r) for r in compiled.reports],
        "plan": plan.to_json() if plan is not None else None,
        "tree": tree,
        "arrays": metas,
    }
    return manifest, arrays


def save_packed(compiled, path: str) -> str:
    """Write ``compiled`` (a :class:`repro_torch.core.api.CompiledParams`)
    as a packed checkpoint directory at ``path``.  Atomic: a crash leaves
    either the previous artifact or none.  Returns ``path``."""
    manifest, arrays = build_manifest(compiled)
    tmp = str(path) + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for i, a in enumerate(arrays):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(str(path), ignore_errors=True)
    os.rename(tmp, str(path))
    return str(path)


def load_packed(path: str, *, mmap: bool = True, device=None):
    """Load a packed checkpoint into a
    :class:`repro_torch.core.api.CompiledParams` on ``device`` (the card
    unless the caller names another) — bit-identical to the object
    :func:`save_packed` was given.  ``mmap=True`` maps the array files
    instead of reading them into memory first."""
    from repro_torch.core.api import CompiledParams, EncodeConfig
    from repro_torch.core.serving import TensorReport

    dev = resolve_device(device)
    mpath = os.path.join(str(path), "manifest.json")
    if not os.path.isdir(str(path)) or not os.path.exists(mpath):
        raise PackedCheckpointError(
            f"{path!r} is not a packed checkpoint (no manifest.json) — "
            f"write one with codr.save_packed(compiled, path)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise PackedCheckpointError(
            f"{path!r}: manifest.json is not valid JSON (truncated "
            f"write?): {e}") from e
    if manifest.get("magic") != _MAGIC:
        raise PackedCheckpointError(
            f"{path!r}: bad magic {manifest.get('magic')!r} — not a "
            f"codr packed checkpoint")
    ver = manifest.get("format_version")
    if ver != CODR_FORMAT_VERSION:
        raise PackedCheckpointError(
            f"{path!r}: format version {ver} but this build reads "
            f"version {CODR_FORMAT_VERSION} — re-encode the checkpoint "
            f"with codr.save_packed")
    metas = manifest["arrays"]
    arrays = []
    for i, meta in enumerate(metas):
        apath = os.path.join(str(path), f"arr_{i}.npy")
        if not os.path.exists(apath):
            raise PackedCheckpointError(
                f"{path!r}: missing array file arr_{i}.npy (the "
                f"manifest lists {len(metas)} arrays)")
        arrays.append(_load_array(apath, meta, mmap=mmap))
    params = _decode_tree(manifest["tree"], arrays, metas, dev)
    plan = None
    if manifest.get("plan") is not None:
        from repro_torch.tune.plan import TunePlan
        plan = TunePlan.from_json(manifest["plan"])
    cfg_d = dict(manifest["config"])
    if cfg_d.get("rle_params") is not None:
        cfg_d["rle_params"] = tuple(cfg_d["rle_params"])
    return CompiledParams(
        params=params,
        reports=[TensorReport(**r) for r in manifest["reports"]],
        packed_paths=list(manifest["packed_paths"]),
        quantized_paths=list(manifest["quantized_paths"]),
        config=EncodeConfig(**cfg_d),
        backend=manifest["backend"],
        plan=plan,
        embed_paths=list(manifest.get("embed_paths", [])))
