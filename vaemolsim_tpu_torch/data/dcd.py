"""DCD trajectory reading and writing (port of
``vaemolsim_tpu/data/dcd.py``): a native C++ reader with a NumPy
fallback, host-side I/O.

* The repository's ``native/dcd_reader.cc``, a small C++ reader behind
  a C ABI, is compiled at first use by the host's C++ compiler (``g++``;
  no pybind11) into the git-ignored ``_build_cache/`` beside the CUDA
  kernels' libraries, and loaded with ctypes.  It handles both
  endiannesses and unit-cell records.
* A NumPy reader with the same semantics is the fallback where no
  compiler or source is at hand, and the oracle in tests.

``DCDReader.read(start, count)`` returns float32 coordinates ``(count,
n_atoms, 3)`` (and the CHARMM unit-cell rows when present) as NumPy
arrays, for ``torch.as_tensor`` on any device; ``reader.backend`` says
which reader ran (``"native"`` or ``"numpy"``).  ``iter_batches``
streams frames of a large trajectory.  :func:`write_dcd` writes a
little-endian CHARMM DCD that both readers, and the JAX package's, read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["DCDReader", "write_dcd"]

_LIB = None
_LIB_TRIED = False
_SRC = Path(__file__).resolve().parents[2] / "native" / "dcd_reader.cc"
_CACHE = Path(__file__).resolve().parents[1] / "_build_cache"


def _native_lib():
    """Compile (once per source digest) and load the native reader; None
    where the source or a compiler is missing or the build fails."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if not _SRC.exists():
        return None
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _CACHE / f"dcd_reader-{digest}.so"
    try:
        if not so.exists():
            _CACHE.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o",
                            str(tmp), str(_SRC)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.dcd_open.restype = ctypes.c_void_p
    lib.dcd_open.argtypes = [ctypes.c_char_p,
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int32)]
    lib.dcd_read_frames.restype = ctypes.c_int64
    lib.dcd_read_frames.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_double)]
    lib.dcd_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


class _NumpyDCD:
    """Pure-NumPy DCD parsing (fallback + test oracle)."""

    def __init__(self, path: str):
        # memmap, not fromfile: the fallback must stream multi-GB
        # trajectories batch-by-batch on hosts without the native
        # reader, not load them whole into RAM.
        self._raw = np.memmap(path, dtype=np.uint8, mode="r")
        head = self._raw[:4].tobytes()
        # Explicit-order probe (a native-order view would misdetect on
        # big-endian hosts).
        if int.from_bytes(head, "little") == 84:
            self._bo = "<"
        elif int.from_bytes(head, "big") == 84:
            self._bo = ">"
        else:
            raise ValueError(f"{path}: not a DCD file")
        hdr = self._raw[4:88]
        if hdr[:4].tobytes() != b"CORD":
            raise ValueError(f"{path}: bad DCD magic")
        ints = np.frombuffer(hdr[4:].tobytes(), dtype=self._bo + "i4")
        self.n_frames = int(ints[0])
        self.has_box = bool(ints[10])
        pos = 4 + 84 + 4
        # Title record.
        tlen = int(np.frombuffer(self._raw[pos:pos + 4].tobytes(),
                                 self._bo + "u4")[0])
        pos += 4 + tlen + 4
        self.n_atoms = int(np.frombuffer(
            self._raw[pos + 4:pos + 8].tobytes(), self._bo + "i4")[0])
        pos += 12
        self._first = pos
        self._frame_bytes = ((48 + 8 if self.has_box else 0)
                             + 3 * (8 + 4 * self.n_atoms))
        # Trust the bytes over the header: a truncated file (or a
        # header NSET written before the run finished) must not promise
        # frames that are not there.
        on_disk = (len(self._raw) - self._first) // self._frame_bytes
        self.n_frames = min(self.n_frames, int(on_disk))

    def read(self, start: int, count: int):
        if start < 0 or count < 0 or start + count > self.n_frames:
            raise IOError(
                f"requested frames [{start}, {start + count}) outside "
                f"[0, {self.n_frames}) in {getattr(self._raw, 'filename', 'DCD')}")
        n = self.n_atoms
        coords = np.empty((count, n, 3), np.float32)
        box = np.empty((count, 6), np.float64) if self.has_box else None
        pos = self._first + start * self._frame_bytes
        for f in range(count):
            if self.has_box:
                box[f] = np.frombuffer(
                    self._raw[pos + 4:pos + 52].tobytes(), self._bo + "f8")
                pos += 56
            for axis in range(3):
                coords[f, :, axis] = np.frombuffer(
                    self._raw[pos + 4:pos + 4 + 4 * n].tobytes(),
                    self._bo + "f4")
                pos += 8 + 4 * n
        return coords, box


class DCDReader:
    """Random-access DCD reader (native when possible).

    >>> r = DCDReader("traj.dcd")
    >>> coords, box = r.read(0, 100)   # (100, n_atoms, 3) float32
    """

    def __init__(self, path: str, force_numpy: bool = False):
        self.path = path
        self._handle = None
        self._np = None
        lib = None if force_numpy else _native_lib()
        if lib is not None:
            na = ctypes.c_int64()
            nf = ctypes.c_int64()
            hb = ctypes.c_int32()
            handle = lib.dcd_open(path.encode(), ctypes.byref(na),
                                  ctypes.byref(nf), ctypes.byref(hb))
            if handle:
                self._lib = lib
                self._handle = ctypes.c_void_p(handle)
                self.n_atoms = int(na.value)
                self.n_frames = int(nf.value)
                self.has_box = bool(hb.value)
                self.backend = "native"
                return
        self._np = _NumpyDCD(path)
        self.n_atoms = self._np.n_atoms
        self.n_frames = self._np.n_frames
        self.has_box = self._np.has_box
        self.backend = "numpy"

    def read(self, start: int = 0, count: Optional[int] = None
             ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        count = self.n_frames - start if count is None else count
        if self._np is not None:
            return self._np.read(start, count)
        coords = np.empty((count, self.n_atoms, 3), np.float32)
        box = (np.empty((count, 6), np.float64) if self.has_box else None)
        got = self._lib.dcd_read_frames(
            self._handle, start, count,
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            box.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            if box is not None else None)
        if got != count:
            raise IOError(f"read {got}/{count} frames from {self.path}")
        return coords, box

    def iter_batches(self, batch_size: int) -> Iterator[np.ndarray]:
        for start in range(0, self.n_frames, batch_size):
            n = min(batch_size, self.n_frames - start)
            yield self.read(start, n)[0]

    def close(self):
        if self._handle is not None:
            self._lib.dcd_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def write_dcd(path: str, coords: np.ndarray,
              box: Optional[np.ndarray] = None) -> None:
    """Minimal DCD writer (little-endian) — enough to round-trip this
    module's readers and export generated configurations."""
    coords = np.asarray(coords, np.float32)
    n_frames, n_atoms, _ = coords.shape

    def rec(payload: bytes) -> bytes:
        ln = np.uint32(len(payload)).tobytes()
        return ln + payload + ln

    icntrl = np.zeros(20, np.int32)
    icntrl[0] = n_frames
    icntrl[10] = 1 if box is not None else 0
    # CHARMM version stamp: external consumers (VMD/mdtraj/MDAnalysis)
    # only look for the unit-cell record when icntrl[19] != 0 — with 0
    # they parse the file as X-PLOR and misread box records as coords.
    icntrl[19] = 24
    header = b"CORD" + icntrl.tobytes()
    title = np.int32(1).tobytes() + b" " * 80
    with open(path, "wb") as f:
        f.write(rec(header))
        f.write(rec(title))
        f.write(rec(np.int32(n_atoms).tobytes()))
        for i in range(n_frames):
            if box is not None:
                f.write(rec(np.asarray(box[i], np.float64).tobytes()))
            for axis in range(3):
                f.write(rec(np.ascontiguousarray(
                    coords[i, :, axis]).tobytes()))
