"""State dicts and their msgpack bytes (counterpart of the parts of
``flax.serialization`` that ``fl4health_tpu/checkpointing`` uses), written
here so the port needs neither flax nor the ``msgpack`` package.

State dicts, as flax builds them: a dict keeps its insertion order (its
keys made ``str``), a list or tuple becomes ``{"0": ..., "1": ...}``, a
namedtuple and a ``tree_dataclass`` are keyed by their fields, and a leaf
is pulled to the host: a tensor becomes a numpy array, except bf16, which
numpy has no dtype for and which stays a CPU tensor of its raw 16-bit words.
``from_state_dict`` rebuilds a template's structure around the state's
leaves (numpy arrays; bf16 as ``torch.bfloat16`` tensors).

Bytes: the msgpack subset flax emits, chosen the way the ``msgpack``
package chooses it with ``strict_types=True`` (the smallest int, str, bin,
array, map and ext forms; a Python float as a double), so equal trees give
equal bytes in both packages. Arrays are ext type 1, the packed
``(shape, dtype name, C-order bytes)``; numpy scalars ext type 3, packed the
same way; Python complex numbers ext type 2. bf16 is written under the
dtype name ``"bfloat16"`` from the tensor's raw words, as flax writes
JAX's bf16. An array of more than ``MAX_CHUNK_SIZE`` bytes is split into
the ``__msgpack_chunked_array__`` form flax uses.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any

import numpy as np
import torch

from fl4health_tpu_torch.core.pytree import _TREE_CLASSES

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
# msgpack's per-object limit is 2**31 - 1 bytes; flax leaves a margin
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_tree_dataclass(x: Any) -> bool:
    return (dataclasses.is_dataclass(x) and not isinstance(x, type)
            and type(x) in _TREE_CLASSES)


def host_leaf(x: Any) -> Any:
    """A tensor as host numpy (bf16 as a CPU tensor: numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return x


# -- state dicts -------------------------------------------------------------

def to_state_dict(target: Any) -> Any:
    """``target`` as flax's ``to_state_dict`` lays it out (leaves on the
    host)."""
    if _is_namedtuple(target):
        return {k: to_state_dict(getattr(target, k)) for k in target._fields}
    if isinstance(target, dict):
        keys = {str(k) for k in target}
        if len(keys) != len(target):
            raise ValueError("Dict keys do not have a unique string representation: "
                             f"{keys} vs given: {target}")
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return {str(i): to_state_dict(x) for i, x in enumerate(target)}
    if _is_tree_dataclass(target):
        return {f.name: to_state_dict(getattr(target, f.name))
                for f in dataclasses.fields(target)}
    return host_leaf(target)


def from_state_dict(target: Any, state: Any, name: str = ".") -> Any:
    """``target``'s structure with the leaves of ``state`` (flax's
    ``from_state_dict``: the template gives the structure, the state the
    values)."""
    if _is_namedtuple(target):
        if set(state) != set(target._fields):
            raise ValueError(
                "The field names of the state dict and the named tuple do not match,"
                f" got {set(state)} and {set(target._fields)} at path {name}")
        return type(target)(**{k: from_state_dict(getattr(target, k), state[k], k)
                               for k in target._fields})
    if isinstance(target, dict):
        diff = set(map(str, target)).difference(state)
        if diff:
            raise ValueError(
                "The target dict keys and state dict keys do not match, target dict"
                f" contains keys {diff} which are not present in state dict at path {name}")
        return {k: from_state_dict(v, state[str(k)], str(k)) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(
                "The size of the list and the state dict do not match,"
                f" got {len(target)} and {len(state)} at path {name}")
        out = [from_state_dict(target[i], state[str(i)], str(i)) for i in range(len(state))]
        return tuple(out) if isinstance(target, tuple) else out
    if _is_tree_dataclass(target):
        fields = [f.name for f in dataclasses.fields(target)]
        missing = [f for f in fields if f not in state]
        if missing:
            raise ValueError(f"Missing field {missing[0]} in state dict while restoring "
                             f"an instance of {type(target).__name__}, at path {name}")
        extra = set(state) - set(fields)
        if extra:
            raise ValueError(f'Unknown field(s) "{",".join(sorted(extra))}" in state dict '
                             f"while restoring an instance of {type(target).__name__} "
                             f"at path {name}")
        return dataclasses.replace(target, **{
            f: from_state_dict(getattr(target, f), state[f], f) for f in fields})
    return state


# -- arrays --------------------------------------------------------------------

def _array_parts(x: Any) -> tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    x.contiguous().view(torch.int16).numpy().tobytes("C"))
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return tuple(int(d) for d in x.shape), x.dtype.name, x.tobytes("C")


def _ndarray_bytes(x: Any) -> bytes:
    return packb(_array_parts(x), strict=False)


def _ndarray_from_bytes(data) -> Any:
    shape, name, buf = _Unpacker(data, raw=True).unpack()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _nbytes(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x: Any) -> dict:
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _is_array(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunk_in_place(d: Any) -> Any:
    """Oversized array leaves to their chunked form; like flax, only
    through dicts."""
    if isinstance(d, dict):
        for k, v in d.items():
            if _is_array(v):
                if _nbytes(v) > MAX_CHUNK_SIZE:
                    d[k] = _chunk(v)
            elif isinstance(v, dict):
                _chunk_in_place(v)
    elif _is_array(d) and _nbytes(d) > MAX_CHUNK_SIZE:
        return _chunk(d)
    return d


def _unchunk(d: dict) -> Any:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_in_place(d: Any) -> Any:
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_in_place(v)
    return d


# -- msgpack encoder -----------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -0x20 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0x80 <= n <= 0xFF:
        out.append(struct.pack("BB", 0xCC, n))
    elif -0x80 <= n < 0:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif 0xFF < n <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, n))
    elif -0x8000 <= n < -0x80:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, n))
    elif -0x80000000 <= n < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, n))
    elif -0x8000000000000000 <= n < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, fix_base: int, fix_max: int, codes: tuple, out: list) -> None:
    """A str/bin/array/map header: the fix form up to ``fix_max`` (None:
    no fix form), then the 8-, 16- or 32-bit length form (``codes``; None
    where the type has no 8-bit form)."""
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack("B", fix_base | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError("object too large for msgpack")


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _pack(obj: Any, out: list, strict: bool = True) -> None:
    """``msgpack``'s packing with ``strict_types`` (exact types only: a
    tuple is not an array there) or without (an array's shape tuple)."""
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif t is dict:
        _pack_len(len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif t is list or (not strict and isinstance(obj, (list, tuple))):
        _pack_len(len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out, strict)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, complex):
        _pack_ext(EXT_NATIVE_COMPLEX, packb((obj.real, obj.imag), strict=False), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any, strict: bool = True) -> bytes:
    """msgpack bytes of ``obj`` (``msgpack.packb(obj, strict_types=True)``
    with flax's ext hook)."""
    out: list = []
    _pack(obj, out, strict)
    return b"".join(out)


# -- msgpack decoder -----------------------------------------------------------

class _Unpacker:
    """Decoder for the subset above (and the other fixed-width number
    forms); ``raw=True`` leaves str payloads as bytes, as flax reads an
    array's dtype name."""

    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data).cast("B") if not isinstance(data, memoryview) else data
        self.i = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.i + n > len(self.data):
            raise ValueError("msgpack data is truncated")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def _num(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._num("b")
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == EXT_NPSCALAR:
            arr = _ndarray_from_bytes(data)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_NATIVE_COMPLEX:
            re, im = _Unpacker(data).unpack()
            return complex(re, im)
        raise ValueError(f"unknown msgpack ext type {code}")

    def unpack(self):
        b = self._num("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self._num(nums[b])
        lens = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xD9: "B", 0xDA: ">H", 0xDB: ">I",
                0xC7: "B", 0xC8: ">H", 0xC9: ">I", 0xDC: ">H", 0xDD: ">I",
                0xDE: ">H", 0xDF: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b not in lens:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self._num(lens[b])
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self._take(n))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(n)
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(n)
        if b in (0xDC, 0xDD):
            return self._array(n)
        return self._map(n)

    def _array(self, n: int) -> list:
        return [self.unpack() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


def unpackb(data) -> Any:
    u = _Unpacker(data)
    out = u.unpack()
    if u.i != len(u.data):
        raise ValueError("extra data after the msgpack object")
    return out


# -- the flax entry points ------------------------------------------------------

def _sorted_copy(tree: Any) -> Any:
    """The copy ``jax.tree_util.tree_map(lambda x: x, tree)`` makes: dicts
    rebuilt with their keys sorted, lists and tuples kept."""
    if isinstance(tree, dict):
        return {k: _sorted_copy(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted_copy(x) for x in tree)
    return tree


def msgpack_serialize(pytree: Any, in_place: bool = False) -> bytes:
    """msgpack bytes of a tree of dicts, lists, tuples, Python scalars and
    array leaves; oversized arrays chunked. Without ``in_place`` the tree is
    copied first, its dict keys sorted, as flax's copy sorts them."""
    if not in_place:
        pytree = _sorted_copy(pytree)
    pytree = _to_host(pytree)
    pytree = _chunk_in_place(pytree)
    return packb(pytree)


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        for k, v in tree.items():
            tree[k] = _to_host(v)
        return tree
    if type(tree) in (list, tuple):
        return type(tree)(_to_host(x) for x in tree)
    return host_leaf(tree)


def msgpack_restore(encoded: bytes) -> Any:
    """The tree of :func:`msgpack_serialize`'s bytes (dicts, lists, scalars
    and array leaves), chunked arrays joined."""
    return _unchunk_in_place(unpackb(encoded))


def to_bytes(target: Any) -> bytes:
    """flax's ``to_bytes``: the state dict of ``target``, serialized in its
    own key order."""
    return msgpack_serialize(to_state_dict(target), in_place=True)


def from_bytes(target: Any, encoded: bytes) -> Any:
    """flax's ``from_bytes``: ``target``'s structure with the stored leaves."""
    return from_state_dict(target, msgpack_restore(encoded))


def leaves_like(template: Any, restored: Any, device: str | torch.device) -> Any:
    """A restored tree's array leaves as tensors in the template's dtypes on
    ``device`` (the template's tensors give the dtypes; its other leaves
    pass through as restored)."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(leaves_like(t, r, device) for t, r in zip(template, restored)))
    if isinstance(template, dict):
        return {k: leaves_like(v, restored[k], device) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(leaves_like(t, r, device) for t, r in zip(template, restored))
    if _is_tree_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: leaves_like(getattr(template, f.name), getattr(restored, f.name), device)
            for f in dataclasses.fields(template)})
    if isinstance(template, torch.Tensor):
        t = restored if isinstance(restored, torch.Tensor) else torch.from_numpy(
            np.array(restored))
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"restored leaf has shape {tuple(t.shape)}, the template "
                             f"{tuple(template.shape)}")
        return t.to(device=device, dtype=template.dtype)
    return restored


__all__ = ["MAX_CHUNK_SIZE", "from_bytes", "from_state_dict", "leaves_like",
           "msgpack_restore", "msgpack_serialize", "packb", "to_bytes",
           "to_state_dict", "unpackb"]
