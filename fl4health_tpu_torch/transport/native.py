"""Loader for the native framing codec (``_codec.cpp``) with a pure-Python
twin (counterpart of ``fl4health_tpu/transport/native.py``; the same wire
bytes).

The shared object is compiled at first use with the system C++ toolchain
(``g++ -O2 -shared -fPIC``) into ``transport/_build/``, beside nothing the
repository tracks, and rebuilt when the source is newer. Where no compiler
is found, or with ``FL4HEALTH_NO_NATIVE=1``, the ``PyFraming`` twin runs:
the same frames, zlib's C crc32. ``get_native()`` returns the loaded
library, or None where the twin runs, so a caller that needs the native
framing (the card's smoke) can refuse the twin instead of falling back
quietly.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_MAGIC = 0x464C3448
_VERSION = 1
_FIXED = struct.Struct("<IHHIQ")  # magic, version, flags, header_len, payload_len

SOURCE = Path(__file__).with_name("_codec.cpp")
BUILD = Path(__file__).resolve().parent / "_build"

_lock = threading.Lock()
_native = None
_native_tried = False


def _compile_native() -> ctypes.CDLL | None:
    so = BUILD / "_codec.so"
    if not so.exists() or so.stat().st_mtime < SOURCE.stat().st_mtime:
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"_codec.{os.getpid()}.so")
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        except (OSError, subprocess.SubprocessError) as e:
            logger.info("native codec build failed (%s); using Python framing", e)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        logger.info("native codec load failed (%s); using Python framing", e)
        return None
    lib.fl4h_crc32.restype = ctypes.c_uint32
    lib.fl4h_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32]
    lib.fl4h_frame_size.restype = ctypes.c_int64
    lib.fl4h_frame_size.argtypes = [ctypes.c_uint32, ctypes.c_uint64]
    lib.fl4h_frame.restype = ctypes.c_int64
    lib.fl4h_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint16, ctypes.c_char_p, ctypes.c_uint64,
    ]
    lib.fl4h_unframe.restype = ctypes.c_int64
    lib.fl4h_unframe.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint16),
    ]
    for name in ("fl4h_pack_nibbles", "fl4h_unpack_nibbles"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]
    return lib


def get_native() -> ctypes.CDLL | None:
    """The loaded shared object, built at the first call; None where the
    twin runs."""
    global _native, _native_tried
    if os.environ.get("FL4HEALTH_NO_NATIVE"):
        return None
    with _lock:
        if not _native_tried:
            _native = _compile_native()
            _native_tried = True
        return _native


class FrameError(ValueError):
    pass


_ERRORS = {-1: "short frame", -2: "bad magic", -3: "bad version", -4: "bad crc"}


class NativeFraming:
    """ctypes bridge over the built ``_codec.so``."""

    def __init__(self, lib: ctypes.CDLL):
        self.lib = lib

    def frame(self, header: bytes, payload: bytes, flags: int = 0) -> bytes:
        size = self.lib.fl4h_frame_size(len(header), len(payload))
        out = ctypes.create_string_buffer(size)
        n = self.lib.fl4h_frame(header, len(header), payload, len(payload), flags, out, size)
        if n < 0:
            raise FrameError("frame buffer sizing failed")
        return out.raw[:n]

    def unframe(self, buf: bytes) -> tuple[bytes, bytes, int]:
        ho, hl = ctypes.c_uint32(), ctypes.c_uint32()
        po, pl = ctypes.c_uint64(), ctypes.c_uint64()
        fl = ctypes.c_uint16()
        rc = self.lib.fl4h_unframe(buf, len(buf), ctypes.byref(ho), ctypes.byref(hl),
                                   ctypes.byref(po), ctypes.byref(pl), ctypes.byref(fl))
        if rc != 0:
            raise FrameError(_ERRORS.get(rc, f"unframe error {rc}"))
        return (buf[ho.value:ho.value + hl.value], buf[po.value:po.value + pl.value],
                fl.value)

    def crc32(self, data: bytes) -> int:
        return self.lib.fl4h_crc32(data, len(data), 0)


class PyFraming:
    """Pure-Python twin (the same bytes on the wire)."""

    def frame(self, header: bytes, payload: bytes, flags: int = 0) -> bytes:
        body = _FIXED.pack(_MAGIC, _VERSION, flags, len(header), len(payload))
        body += header + payload
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    def unframe(self, buf: bytes) -> tuple[bytes, bytes, int]:
        if len(buf) < _FIXED.size + 4:
            raise FrameError("short frame")
        magic, version, flags, hlen, plen = _FIXED.unpack_from(buf)
        if magic != _MAGIC:
            raise FrameError("bad magic")
        if version != _VERSION:
            raise FrameError("bad version")
        total = _FIXED.size + hlen + plen + 4
        if len(buf) < total:
            raise FrameError("short frame")
        (expect,) = struct.unpack_from("<I", buf, total - 4)
        if expect != (zlib.crc32(buf[:total - 4]) & 0xFFFFFFFF):
            raise FrameError("bad crc")
        return (buf[_FIXED.size:_FIXED.size + hlen],
                buf[_FIXED.size + hlen:_FIXED.size + hlen + plen], flags)

    def crc32(self, data: bytes) -> int:
        return zlib.crc32(data) & 0xFFFFFFFF


def get_framing():
    lib = get_native()
    return NativeFraming(lib) if lib is not None else PyFraming()


# -- int4 nibble packing (the compressed frames, codec.py encode_compressed) --

def _pack_int4_py(vals) -> bytes:
    u = np.asarray(vals, np.int8).view(np.uint8) & 0xF
    if u.size % 2:
        u = np.concatenate([u, np.zeros((1,), np.uint8)])
    return (u[0::2] | (u[1::2] << 4)).astype(np.uint8).tobytes()


def _unpack_int4_py(packed: bytes, n: int) -> np.ndarray:
    b = np.frombuffer(packed, np.uint8)
    out = np.empty(2 * b.size, np.int16)
    out[0::2] = b & 0xF
    out[1::2] = b >> 4
    return ((out[:n] ^ 0x8) - 0x8).astype(np.int8)


def pack_int4(vals) -> bytes:
    """Signed int4 values (an int8 array, each in [-8, 7]) two a byte, low
    nibble first: native where built, the numpy twin otherwise (the same
    bytes)."""
    v = np.ascontiguousarray(vals, np.int8)
    lib = get_native()
    if lib is None:
        return _pack_int4_py(v)
    out = ctypes.create_string_buffer((v.size + 1) // 2)
    n = lib.fl4h_pack_nibbles(v.tobytes(), v.size, out, len(out))
    if n < 0:
        raise FrameError("int4 pack buffer sizing failed")
    return out.raw[:n]


def unpack_int4(packed: bytes, n: int) -> np.ndarray:
    """Inverse of :func:`pack_int4`: ``n`` sign-extended int8 values."""
    if len(packed) < (n + 1) // 2:
        raise FrameError(f"int4 payload too short: {len(packed)} bytes for {n} values")
    lib = get_native()
    if lib is None:
        return _unpack_int4_py(packed, n)
    out = ctypes.create_string_buffer(max(n, 1))
    if lib.fl4h_unpack_nibbles(packed, n, out, len(out)) < 0:
        raise FrameError("int4 unpack buffer sizing failed")
    return np.frombuffer(out.raw[:n], np.int8).copy()
