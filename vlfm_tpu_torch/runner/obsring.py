"""ctypes binding of the shared-memory observation ring (``native/obsring.cpp``).

Counterpart of ``vlfm_tpu/runner/obsring.py``, with its own build step: at
first use the one C++ source is compiled into
``vlfm_tpu_torch/build/obsring-<hash>/libobsring.so`` (keyed by a hash of
the source and the flags),

    g++ -O2 -std=c++17 -fPIC -Wall -Wextra -shared -o libobsring.so native/obsring.cpp

and loaded with ctypes. A failed build raises with the compiler's output;
there is no fallback. ``CXX`` names another compiler.

Sim workers produce, the driver drains whole batches:

    ring = ObservationRing.create("vlfm_obs", slot_bytes=obs_nbytes, n_slots=64)
    # in a worker process:
    ObservationRing.open("vlfm_obs").push(record_bytes)
    # in the driver loop:
    records = ring.poll_batch(max_records=32)   # [(ticket, bytes)]
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "obsring.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")


def build() -> Path:
    """Compile the ring's library unless one for this source exists."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()[:16]
    out_dir = BUILD_DIR / f"obsring-{digest}"
    lib = out_dir / "libobsring.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libobsring.so.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"obsring build failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points' signatures."""
    lib = ctypes.CDLL(str(build()))
    p, u64, i64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
    lib.obsring_create.restype = p
    lib.obsring_create.argtypes = [ctypes.c_char_p, u64, u64]
    lib.obsring_open.restype = p
    lib.obsring_open.argtypes = [ctypes.c_char_p]
    lib.obsring_slot_bytes.restype = u64
    lib.obsring_slot_bytes.argtypes = [p]
    lib.obsring_n_slots.restype = u64
    lib.obsring_n_slots.argtypes = [p]
    lib.obsring_push.restype = i64
    lib.obsring_push.argtypes = [p, ctypes.c_char_p, u64]
    lib.obsring_poll.restype = i64
    lib.obsring_poll.argtypes = [p, ctypes.POINTER(u64), p, ctypes.POINTER(u64), ctypes.POINTER(u64), u64]
    lib.obsring_close.restype = None
    lib.obsring_close.argtypes = [p]
    return lib


class ObservationRing:
    """One POSIX shared-memory ring of fixed-size slots: many producers, one
    consumer that reads tickets in order. The creator owns the name and
    unlinks it on ``close``."""

    def __init__(self, handle, lib, owner: bool):
        self._h = handle
        self._lib = lib
        self._owner = owner
        self._cursor = ctypes.c_uint64(0)
        self.slot_bytes = int(lib.obsring_slot_bytes(handle))
        self.n_slots = int(lib.obsring_n_slots(handle))

    @staticmethod
    def available() -> bool:
        """True once the library is built and loaded; a failed build raises."""
        return load_library() is not None

    @classmethod
    def create(cls, name: str, slot_bytes: int, n_slots: int) -> "ObservationRing":
        lib = load_library()
        h = lib.obsring_create(f"/{name.lstrip('/')}".encode(), slot_bytes, n_slots)
        if not h:
            raise RuntimeError(f"obsring_create({name}) failed")
        return cls(h, lib, owner=True)

    @classmethod
    def open(cls, name: str) -> "ObservationRing":
        lib = load_library()
        h = lib.obsring_open(f"/{name.lstrip('/')}".encode())
        if not h:
            raise RuntimeError(f"obsring_open({name}) failed")
        return cls(h, lib, owner=False)

    def push(self, payload: bytes) -> int:
        t = self._lib.obsring_push(self._h, payload, len(payload))
        if t < 0:
            raise ValueError(f"payload of {len(payload)} bytes exceeds slot size {self.slot_bytes}")
        return t

    def poll_batch(self, max_records: int = 64) -> List[Tuple[int, bytes]]:
        """Up to ``max_records`` published records from the cursor on, in
        ticket order: [(ticket, payload)]."""
        out = np.empty((max_records, self.slot_bytes), np.uint8)
        lens = (ctypes.c_uint64 * max_records)()
        tickets = (ctypes.c_uint64 * max_records)()
        n = self._lib.obsring_poll(self._h, ctypes.byref(self._cursor), out.ctypes.data_as(ctypes.c_void_p),
                                   lens, tickets, max_records)
        return [(int(tickets[i]), out[i, : lens[i]].tobytes()) for i in range(int(n))]

    def close(self) -> None:
        if self._h:
            self._lib.obsring_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
