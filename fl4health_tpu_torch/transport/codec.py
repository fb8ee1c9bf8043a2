"""Tree <-> wire codec for the cross-silo transport (counterpart of
``fl4health_tpu/transport/codec.py``). A frame is byte for byte the one the
JAX package writes for the same tree, so a JAX silo and a torch silo can
talk.

- header = JSON metadata (dotted leaf paths, shapes, dtypes); nothing on
  the wire is executed (no pickle);
- payload = the raw little-endian leaf bytes, in path order;
- framing (magic, version, flags, lengths, CRC-32) is the native C++ codec
  (``transport/native.py``) or its byte-identical Python twin;
- sparse packets cross as COO (values and int32 indices): the port's dense
  0/1 ``SparseMaskPacket`` converts at this host boundary;
- compressed updates cross as COMPRESSED frames (flag bit 1): per leaf an
  optional gap-uint16 index sidecar (global magnitude top-k, ties to the
  lowest index), int8 or packed int4 values with one f32 scale a leaf.

Paths and order are JAX's. ``jax.tree_util`` flattens a dict in sorted key
order at each level and names a sequence entry ``[i]``; the port's
``Params`` is a flat dict keyed ``"a/b/c"``, which this codec reads as the
nested dict it stands for. So ``{"params": {"Dense_0/kernel": ...}, "n":
..., "loss": ...}`` crosses as JAX's ``loss``, ``n``,
``params.Dense_0.kernel``. ``decode(data, like=template)`` rebuilds the
template's own layout (flat ``Params`` keys stay flat); a path set that does
not match the template raises naming the first mismatched path; without a
template the result is nested dicts, as in JAX.

Leaves may be tensors (on any device: each is pulled to the host once),
numpy arrays or Python scalars. ``bfloat16`` crosses as JAX writes it
(ml_dtypes' name, two bytes a value) through a 16-bit view. ``decode``
returns CPU tensors in the frame's dtype, as JAX returns numpy arrays: it
casts nothing.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Mapping

import numpy as np
import torch

from fl4health_tpu_torch.compression.config import QUANT_LEVELS, CompressionConfig
from fl4health_tpu_torch.exchange.packer import SparseMaskPacket
from fl4health_tpu_torch.observability.registry import get_registry
from fl4health_tpu_torch.transport.native import get_framing, pack_int4, unpack_int4

FLAG_COO = 1
FLAG_COMPRESSED = 2
BF16 = "bfloat16"


def _account(direction: str, nbytes: int, kind: str) -> None:
    """Wire bytes and frames into the process-wide registry, under JAX's
    counter names."""
    reg = get_registry()
    reg.counter(f"transport_bytes_{direction}_total",
                help=f"total wire bytes {direction} by the codec").inc(nbytes)
    reg.counter(f"transport_frames_{direction}_total",
                help=f"wire frames {direction} by the codec", labels={"kind": kind}).inc()


# -- paths: JAX's flatten order over the port's trees --------------------------

def _nested(node: Mapping) -> dict:
    """A dict with its ``"a/b"`` keys read as nesting."""
    out: dict = {}
    groups: dict = {}
    for key, val in node.items():
        if isinstance(key, str) and "/" in key:
            head, rest = key.split("/", 1)
            groups.setdefault(head, {})[rest] = val
        else:
            out[key] = val
    for head, sub in groups.items():
        out[head] = {**out[head], **sub} if isinstance(out.get(head), Mapping) else sub
    return out


def _is_dataclass_node(node: Any) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def _fields(node: Any) -> tuple[str, ...] | None:
    """The attribute names JAX keys a node's children by (``GetAttrKey``: a
    dataclass's fields, a namedtuple's), or None for other nodes."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return node._fields
    if _is_dataclass_node(node):
        return tuple(f.name for f in dataclasses.fields(node))
    return None


def _flatten(tree: Any) -> list[tuple[str, Any]]:
    """(dotted path, leaf) in ``jax.tree_util.tree_flatten_with_path``'s
    order: dict keys sorted at each level, ``[i]`` for a list or tuple
    entry, ``.name`` for a dataclass's or namedtuple's field
    (``str(GetAttrKey)``); None has no leaves."""
    out: list[tuple[str, Any]] = []

    def walk(node, parts):
        if node is None:
            return
        names = _fields(node)
        if names is not None:
            for name in names:
                walk(getattr(node, name), parts + [f".{name}"])
        elif isinstance(node, Mapping):
            nested = _nested(node)
            for key in sorted(nested):
                walk(nested[key], parts + [str(key)])
        elif isinstance(node, (list, tuple)):
            for i, val in enumerate(node):
                walk(val, parts + [f"[{i}]"])
        else:
            out.append((".".join(parts), node))

    walk(tree, [])
    return out


def _rebuild(template: Any, by_path: Mapping[str, Any]) -> Any:
    """``template``'s own layout (containers, key order, flat ``Params``
    keys) with each leaf taken from ``by_path`` at its dotted path."""
    def walk(node, parts):
        if node is None:
            return None
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, n), parts + [f".{n}"])
                                for n in node._fields))
        if isinstance(node, Mapping):
            return {k: walk(v, parts + str(k).split("/")) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, parts + [f"[{i}]"]) for i, v in enumerate(node))
        if _is_dataclass_node(node):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name), parts + [f".{f.name}"])
                for f in dataclasses.fields(node) if f.init})
        return by_path[".".join(parts)]

    return walk(template, [])


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """(an array holding the leaf's bytes, the dtype name on the wire). A
    tensor is pulled to the host once; bfloat16 travels as a 16-bit view
    under ml_dtypes' name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)  # tobytes() writes C order whatever the strides
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
    return arr, str(arr.dtype)


def _f32(leaf: Any) -> np.ndarray:
    """The leaf's values as a flat f32 array (JAX's ``np.asarray(a,
    np.float32)``)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).contiguous().numpy().ravel()
    return np.asarray(leaf, np.float32).ravel()


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A CPU tensor of ``arr``'s values in the wire dtype ``dtype``
    (``arr`` holds raw 16-bit words where ``dtype`` is bfloat16)."""
    if dtype == BF16:
        return torch.from_numpy(np.array(arr, np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, np.dtype(dtype)))


def _size(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _itemsize(dtype: str) -> int:
    return 2 if dtype == BF16 else np.dtype(dtype).itemsize


def _match_template_paths(payload_paths: list[str], like: Any, what: str) -> list[str]:
    """The template's leaf paths, checked against the payload's: a mismatch
    raises naming the first mismatched path (a template leaf the payload
    lacks, else a payload leaf the template lacks)."""
    template_paths = [p for p, _ in _flatten(like)]
    have = set(payload_paths)
    for p in template_paths:
        if p not in have:
            raise ValueError(
                f"{what}: payload is missing leaf {p!r} required by the decode template "
                f"({len(payload_paths)} payload leaves vs {len(template_paths)} template "
                "leaves)")
    want = set(template_paths)
    for p in payload_paths:
        if p not in want:
            raise ValueError(
                f"{what}: payload leaf {p!r} does not exist in the decode template "
                f"({len(payload_paths)} payload leaves vs {len(template_paths)} template "
                "leaves)")
    return template_paths


def _rebuild_nested(items: list[tuple[str, Any]]) -> dict:
    root: dict = {}
    for path, arr in items:
        node = root
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return root


def _finish(items: list[tuple[str, Any]], like: Any, what: str) -> Any:
    if like is None:
        return _rebuild_nested(items)
    _match_template_paths([p for p, _ in items], like, what)
    return _rebuild(like, dict(items))


# -- dense frames --------------------------------------------------------------

def encode(tree: Any, trace: dict[str, Any] | None = None) -> bytes:
    """Dense tree -> one wire frame. ``trace`` (a ``TraceContext.to_header()``
    dict) rides in the JSON header under ``"trace"``; ``decode`` reads only
    ``"leaves"``, so traced frames decode everywhere, and an untraced frame
    is exactly what it always was."""
    meta, chunks = [], []
    for path, leaf in _flatten(tree):
        arr, dtype = _host(leaf)
        meta.append({"path": path, "shape": list(arr.shape), "dtype": dtype})
        chunks.append(arr.tobytes())
    head: dict[str, Any] = {"leaves": meta}
    if trace is not None:
        head["trace"] = trace
    frame = get_framing().frame(json.dumps(head).encode("utf-8"), b"".join(chunks), flags=0)
    _account("encoded", len(frame), "dense")
    return frame


def frame_trace(data: bytes) -> dict[str, Any] | None:
    """The ``"trace"`` header dict of any codec frame (dense, COO or
    compressed), or None for untraced or unparseable input. Never raises:
    the silo's traced handler calls it on raw request bytes."""
    try:
        header, _, _ = get_framing().unframe(data)
        doc = json.loads(header.decode("utf-8"))
    except Exception:
        return None
    trace = doc.get("trace") if isinstance(doc, dict) else None
    return trace if isinstance(trace, dict) else None


def decode(data: bytes, like: Any = None) -> Any:
    """Wire frame -> tree of CPU tensors in the frame's dtypes. With
    ``like``, the template's layout (paths must match); otherwise nested
    dicts."""
    header, payload, flags = get_framing().unframe(data)
    meta = json.loads(header.decode("utf-8"))
    if flags & FLAG_COO:
        raise ValueError("COO frame: use decode_sparse()")
    if flags & FLAG_COMPRESSED:
        raise ValueError("compressed frame: use decode_compressed()")
    _account("decoded", len(data), "dense")
    items = []
    off = 0
    for entry in meta["leaves"]:
        dtype, n = entry["dtype"], _size(entry["shape"])
        wire = "<u2" if dtype == BF16 else np.dtype(dtype)
        arr = np.frombuffer(payload, wire, count=n, offset=off).reshape(entry["shape"])
        items.append((entry["path"], _tensor(arr, dtype)))
        off += n * _itemsize(dtype)
    return _finish(items, like, "dense wire frame")


# -- sparse (COO) frames ---------------------------------------------------------

def encode_sparse(packet: SparseMaskPacket) -> bytes:
    """``SparseMaskPacket`` (dense 0/1 element masks, the device encoding)
    -> COO wire frame shipping only the selected values and their flat
    int32 indices."""
    masks = {p: _f32(m) for p, m in _flatten(packet.element_mask)}
    meta, chunks = [], []
    for path, leaf in _flatten(packet.params):
        arr, dtype = _host(leaf)
        flat_idx = np.nonzero(masks[path] > 0)[0].astype(np.int32)
        values = np.ascontiguousarray(arr.ravel()[flat_idx])
        meta.append({"path": path, "shape": list(arr.shape), "dtype": dtype,
                     "nnz": int(flat_idx.size)})
        chunks.append(flat_idx.tobytes())
        chunks.append(values.tobytes())
    header = json.dumps({"coo": meta}).encode("utf-8")
    frame = get_framing().frame(header, b"".join(chunks), flags=FLAG_COO)
    _account("encoded", len(frame), "coo")
    return frame


def decode_sparse(data: bytes, like: SparseMaskPacket | None = None) -> SparseMaskPacket:
    """COO wire frame -> dense params and f32 element masks (zeros where
    absent)."""
    header, payload, flags = get_framing().unframe(data)
    if not flags & FLAG_COO:
        raise ValueError("dense frame: use decode()")
    _account("decoded", len(data), "coo")
    meta = json.loads(header.decode("utf-8"))
    items, mask_items = [], []
    off = 0
    for entry in meta["coo"]:
        dtype, nnz, n = entry["dtype"], entry["nnz"], _size(entry["shape"])
        wire = np.dtype("<u2") if dtype == BF16 else np.dtype(dtype)
        idx = np.frombuffer(payload, np.int32, count=nnz, offset=off)
        off += nnz * 4
        vals = np.frombuffer(payload, wire, count=nnz, offset=off)
        off += nnz * wire.itemsize
        dense = np.zeros((n,), wire)
        dense[idx] = vals
        mask = np.zeros((n,), np.float32)
        mask[idx] = 1.0
        items.append((entry["path"], _tensor(dense.reshape(entry["shape"]), dtype)))
        mask_items.append((entry["path"], torch.from_numpy(mask.reshape(entry["shape"]))))
    if like is None:
        return SparseMaskPacket(params=_rebuild_nested(items),
                                element_mask=_rebuild_nested(mask_items))
    return SparseMaskPacket(params=_finish(items, like.params, "COO wire frame"),
                            element_mask=_finish(mask_items, like.params, "COO wire frame"))


# -- compressed frames (top-k + int8/int4) ---------------------------------------

def account_wire(logical: int, wire: int, direction: str) -> None:
    """``fl_wire_*`` accounting of the compressed exchange: logical (dense)
    against actual wire bytes, and the compression-ratio gauge, labelled by
    direction as in JAX."""
    reg = get_registry()
    reg.counter("fl_wire_bytes_logical_total",
                help="dense byte footprint of trees crossing the compressed codec",
                labels={"direction": direction}).inc(logical)
    reg.counter("fl_wire_bytes_compressed_total", help="actual wire bytes of compressed frames",
                labels={"direction": direction}).inc(wire)
    if wire > 0:
        reg.gauge("fl_wire_compression_ratio",
                  help="logical/wire byte ratio of the last compressed exchange",
                  labels={"direction": direction}).set(logical / wire)


def _encode_gaps(idx: np.ndarray) -> np.ndarray:
    """Sorted flat indices -> uint16 gap tokens; a token of 0xFFFF is an
    escape meaning "add 65535 and keep reading"."""
    idx = np.asarray(idx, np.int64)
    gaps = np.empty_like(idx)
    if idx.size:
        gaps[0] = idx[0]
        gaps[1:] = np.diff(idx)
    esc = gaps // 0xFFFF
    rem = (gaps % 0xFFFF).astype(np.uint16)
    tokens = np.full(int(esc.sum()) + idx.size, 0xFFFF, np.uint16)
    tokens[np.cumsum(esc + 1) - 1] = rem
    return tokens


def _decode_gaps(tokens: np.ndarray) -> np.ndarray:
    t = np.asarray(tokens, np.int64)
    return np.cumsum(t)[t != 0xFFFF]


def _global_topk_indices(abs_concat: np.ndarray, k: int) -> np.ndarray:
    """Exact global top-k with ``lax.top_k``'s rule: largest magnitude,
    ties to the lowest flat index; non-finite coordinates first (NaN, then
    Inf, each by ascending index), so a poisoned coordinate is selected and
    stays visible on the far side."""
    n = abs_concat.size
    k = max(1, min(int(k), n))
    a = np.where(np.isfinite(abs_concat), abs_concat, np.inf)
    part = np.argpartition(-a, k - 1)[:k]
    kth = a[part].min()
    if np.isinf(kth):
        nan_idx = np.nonzero(np.isnan(abs_concat))[0]
        inf_idx = np.nonzero(np.isinf(abs_concat))[0]
        return np.sort(np.concatenate([nan_idx, inf_idx])[:k].astype(np.int64))
    greater = np.nonzero(a > kth)[0]
    ties = np.nonzero(a == kth)[0]
    return np.sort(np.concatenate([greater, ties[:k - greater.size]]).astype(np.int64))


def compressed_frame_kind(config: CompressionConfig) -> str:
    """Frame-kind label of the byte counters (``topk+int8``-style)."""
    parts = []
    if config.topk_fraction is not None:
        parts.append("topk")
    if config.quant_bits is not None:
        parts.append(f"int{config.quant_bits}")
    return "+".join(parts) if parts else "dense"


def encode_compressed(tree: Any, config: CompressionConfig) -> bytes:
    """Dense tree -> one COMPRESSED wire frame under ``config``: global
    magnitude top-k, per-leaf f32 scales, int8 bytes or packed int4
    nibbles, gap-uint16 index sidecars. Quantization is deterministic
    round-to-nearest with the scale ``max|v| / L`` re-derived from the
    serialized values, so the codec is idempotent; the stochastic draw
    belongs to the in-graph channel (``compression/``)."""
    from fl4health_tpu_torch.compression.codecs import topk_count

    entries = _flatten(tree)
    hosts = [_host(leaf) for _, leaf in entries]
    logical = sum(arr.nbytes for arr, _ in hosts)
    flats = [_f32(leaf) for _, leaf in entries]
    sizes = [f.size for f in flats]
    n_total = int(sum(sizes))

    leaf_idx: list[np.ndarray | None] = [None] * len(flats)
    if config.topk_fraction is not None and n_total:
        sel = _global_topk_indices(np.abs(np.concatenate(flats)),
                                   topk_count(n_total, config.topk_fraction))
        leaf_idx, off = [], 0
        for n in sizes:
            leaf_idx.append((sel[(sel >= off) & (sel < off + n)] - off).astype(np.int64))
            off += n

    meta, chunks = [], []
    for (path, _), (arr, dtype), flat, idx in zip(entries, hosts, flats, leaf_idx):
        values = flat if idx is None else flat[idx]
        entry: dict[str, Any] = {"path": path, "shape": list(arr.shape), "dtype": dtype}
        if idx is not None:
            tokens = _encode_gaps(idx)
            entry["nnz"] = int(idx.size)
            entry["idx_tokens"] = int(tokens.size)
            chunks.append(tokens.astype("<u2").tobytes())
        if config.quant_bits is not None:
            L = QUANT_LEVELS[config.quant_bits]
            vmax = float(np.max(np.abs(values))) if values.size else 0.0
            entry["bits"] = config.quant_bits
            if not np.isfinite(vmax):
                # a NaN scale makes every selected value decode as NaN: the
                # poison stays visible (int8 has no NaN)
                entry["scale"] = float("nan")
                q = np.zeros(values.shape, np.int8)
            else:
                scale = np.float32(vmax / L)
                entry["scale"] = float(scale)
                q = (np.rint(values / scale) if scale > 0
                     else np.zeros_like(values)).clip(-L, L).astype(np.int8)
            chunks.append(pack_int4(q) if config.quant_bits == 4 else q.tobytes())
        else:
            chunks.append(values.astype("<f4").tobytes())
        meta.append(entry)
    header = json.dumps({"comp": meta}).encode("utf-8")
    frame = get_framing().frame(header, b"".join(chunks), flags=FLAG_COMPRESSED)
    _account("encoded", len(frame), compressed_frame_kind(config))
    account_wire(logical, len(frame), "encoded")
    return frame


def decode_compressed(data: bytes, like: Any = None) -> Any:
    """COMPRESSED wire frame -> dense tree of CPU tensors (unselected
    coordinates zero, values dequantized by the leaf's scale, cast to the
    encoded dtype; integer leaves rounded, not truncated)."""
    header, payload, flags = get_framing().unframe(data)
    if not flags & FLAG_COMPRESSED:
        raise ValueError("not a compressed frame: use decode()/decode_sparse()")
    meta = json.loads(header.decode("utf-8"))
    logical = 0
    items = []
    off = 0
    for entry in meta["comp"]:
        dtype, n = entry["dtype"], _size(entry["shape"])
        logical += n * _itemsize(dtype)
        idx, nnz = None, n
        if "nnz" in entry:
            nnz, tok_n = int(entry["nnz"]), int(entry["idx_tokens"])
            tokens = np.frombuffer(payload, "<u2", count=tok_n, offset=off)
            off += 2 * tok_n
            idx = _decode_gaps(tokens)
            if idx.size != nnz or (idx.size and int(idx[-1]) >= n):
                raise ValueError(
                    f"compressed frame: corrupt index sidecar for leaf {entry['path']!r}")
        bits = entry.get("bits")
        if bits == 4:
            packed_len = math.ceil(nnz / 2)
            values = unpack_int4(payload[off:off + packed_len], nnz).astype(np.float32)
            off += packed_len
        elif bits == 8:
            values = np.frombuffer(payload, np.int8, count=nnz, offset=off).astype(np.float32)
            off += nnz
        else:
            values = np.frombuffer(payload, "<f4", count=nnz, offset=off).astype(np.float32)
            off += 4 * nnz
        if bits is not None:
            values = values * np.float32(entry["scale"])
        dense = np.zeros((n,), np.float32)
        if idx is None:
            dense[:] = values
        else:
            dense[idx] = values
        dense = dense.reshape(entry["shape"])
        if dtype == BF16:
            leaf = torch.from_numpy(dense).to(torch.bfloat16)
        else:
            if np.issubdtype(np.dtype(dtype), np.integer):
                dense = np.rint(dense)
            leaf = torch.from_numpy(dense.astype(np.dtype(dtype)))
        items.append((entry["path"], leaf))
    _account("decoded", len(data), "compressed")
    account_wire(logical, len(data), "decoded")
    return _finish(items, like, "compressed wire frame")
