"""Native runtime components (C++ via ctypes).

A copy of ``quiver_tpu/native/__init__.py`` over a copy of its ``wal.cc``
(byte-identical frames, so either package reads the other's log).
``NativeWalWriter`` is a drop-in for ``persistence.manager.WalWriter``
backed by ``libquiver_wal.so``: CRC32C-framed records, a background
group-commit thread (one write + one fdatasync per drain shared across
writers), and exact torn-tail detection on read.

One change: the library is built here at first use, with ``g++ -O2
-shared -fPIC -pthread``, into the git-ignored
``quiver_tpu_torch/_build/wal/<hash>/`` (keyed by the source and flags),
where the reference expects a prebuilt ``libquiver_wal.so``
(``make -C quiver_tpu/native``) and falls back to the Python writer
without one. A failed build raises: the port has no fallback writer.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().with_name("wal.cc")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build" / "wal"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")
LIB_NAME = "libquiver_wal.so"


def build() -> Path:
    """Compile ``wal.cc`` into ``BUILD_ROOT/<hash>/libquiver_wal.so`` unless
    that library exists; returns its path. Builds into a private directory
    and renames, so concurrent processes never load a half-written file."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_ROOT / digest / LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: it builds the native WAL library")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=lib.parent))
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp / LIB_NAME), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp / LIB_NAME, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a WAL library."""
    lib.qwal_open.restype = ctypes.c_void_p
    lib.qwal_open.argtypes = [ctypes.c_char_p]
    lib.qwal_append.restype = ctypes.c_uint64
    lib.qwal_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    lib.qwal_sync.restype = ctypes.c_int
    lib.qwal_sync.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.qwal_truncate.restype = None
    lib.qwal_truncate.argtypes = [ctypes.c_void_p]
    lib.qwal_close.restype = None
    lib.qwal_close.argtypes = [ctypes.c_void_p]
    lib.qwal_read_frames.restype = ctypes.c_uint64
    lib.qwal_read_frames.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64]
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The WAL library, built if needed and bound."""
    return bind(ctypes.CDLL(str(build())))


def available() -> bool:
    """True once the library is built and loaded (a failed build raises)."""
    return load() is not None


class NativeWalWriter:
    """Framed group-commit WAL (same append API as persistence.WalWriter)."""

    def __init__(self, path: str):
        lib = load()
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h = lib.qwal_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open WAL at {path}")
        self._lib = lib

    @staticmethod
    def _entry_bytes(entry_type, vec_id, vector, metadata) -> bytes:
        entry = {"timestamp": time.time(), "type": entry_type,
                 "vector_id": vec_id}
        if vector is not None:
            entry["vector"] = np.asarray(vector, np.float32).tolist()
        if metadata is not None:
            entry["metadata"] = metadata
        return json.dumps(entry, separators=(",", ":")).encode()

    def append(self, entry_type: str, vec_id: str, vector=None,
               metadata: Optional[dict] = None) -> None:
        self.append_many([(entry_type, vec_id, vector, metadata)])

    def append_many(self, entries) -> None:
        seq = 0
        for e in entries:
            payload = self._entry_bytes(*e)
            seq = self._lib.qwal_append(self._h, payload, len(payload))
            if not seq:
                raise OSError(f"WAL {self.path} failed (disk error); "
                              "record not journaled")
        if seq and self._lib.qwal_sync(self._h, seq) != 0:
            # records were NOT made durable — surface it instead of
            # acknowledging a write the log cannot replay
            raise OSError(f"WAL {self.path} sync failed (disk error)")

    def truncate(self) -> None:
        """In-place log truncation (waits out any in-flight group commit).
        The persistence layer prefers segment rotation; kept for API
        completeness."""
        if self._h:
            self._lib.qwal_truncate(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.qwal_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


def read_native_wal(path: str) -> list[dict]:
    """Read intact frames (CRC-verified; torn tails cut exactly)."""
    if not os.path.exists(path):
        return []
    lib = load()
    need = lib.qwal_read_frames(path.encode(), None, 0)
    if not need:
        return []
    buf = ctypes.create_string_buffer(int(need))
    got = lib.qwal_read_frames(path.encode(), buf, need)
    out = []
    for line in bytes(buf[: int(got)]).split(b"\n"):
        if line:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:  # pragma: no cover
                break
    return out
