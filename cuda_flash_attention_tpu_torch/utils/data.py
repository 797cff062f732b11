"""Training data: token shards and the native prefetching loader.

Counterpart of cuda_flash_attention_tpu/utils/data.py.  A token shard is a
raw little-endian int32 file with no header (the .bin convention of
utils/io.py).  `TokenLoader` yields [batch, seq_len + 1] int32 windows;
`loss_fn` takes the whole window and shifts it itself.

Two engines draw the same windows from the same xorshift64* stream:
  * native: the C ABI of the repository's cpp/dataloader.cpp
    (cfa_loader_open/next/num_tokens/close) through ctypes: the shard is
    mmap'd and a producer thread fills a ring of ready batches, so host
    input stays off the train step's path.  The library is built at first
    use with the host's g++ (`g++ -O2 -std=c++17 -shared -fPIC -pthread`)
    into build/loader/ at the repository root, named by a hash of the
    source and flags (an edited source is rebuilt); nothing is written
    under cpp/;
  * Python: the same windows from numpy, the correctness reference and the
    path that needs no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "cpp" / "dataloader.cpp"
BUILD_DIR = _REPO / "build" / "loader"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")

_MASK64 = (1 << 64) - 1


def write_token_file(path, tokens) -> None:
    """A raw little-endian int32 shard, no header."""
    np.asarray(tokens, dtype="<i4").tofile(path)


def _xorshift64s(state: int) -> tuple[int, int]:
    """One step of xorshift64*, as cpp/dataloader.cpp takes it."""
    s = state
    s ^= s >> 12
    s = (s ^ (s << 25)) & _MASK64
    s ^= s >> 27
    return s, (s * 0x2545F4914F6CDD1D) & _MASK64


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libcfa_loader-{digest.hexdigest()[:16]}.so"


def build_native() -> Path:
    """The loader's shared library, compiled with g++ if it is not built
    yet.  Raises when the source, g++ or the compile is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native loader: no g++ on PATH to build "
                           f"{SOURCE.relative_to(_REPO)}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native loader: g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a half-written library is never loaded
    return out


def _load_native_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    lib.cfa_loader_open.restype = ctypes.c_void_p
    lib.cfa_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
    lib.cfa_loader_next.restype = ctypes.c_int
    lib.cfa_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.cfa_loader_num_tokens.restype = ctypes.c_int64
    lib.cfa_loader_num_tokens.argtypes = [ctypes.c_void_p]
    lib.cfa_loader_close.restype = None
    lib.cfa_loader_close.argtypes = [ctypes.c_void_p]
    return lib


class TokenLoader:
    """Iterator of [batch, seq_len + 1] int32 windows over a token shard.

    ``shuffle=True`` draws window starts from the xorshift64* stream;
    ``shuffle=False`` walks the shard in order and wraps.  One consumer.
    ``native=True`` takes the C++ engine and raises if it cannot be built;
    ``native=False`` the Python one; ``native=None`` the C++ engine when it
    builds, else the Python one.  Both give the same batches for a seed."""

    def __init__(self, path, batch: int, seq_len: int, *, seed: int = 1,
                 shuffle: bool = True, prefetch: int = 4,
                 native: bool | None = None):
        self.batch = int(batch)
        self.width = int(seq_len) + 1
        self._h = None
        self._lib = None
        if native is not False:
            try:
                self._lib = _load_native_lib()
            except (RuntimeError, OSError):
                if native:
                    raise
        seed = int(seed) & _MASK64 or 0x9E3779B97F4A7C15
        if self._lib is not None:
            self._h = self._lib.cfa_loader_open(
                os.fsencode(path), self.batch, self.width, seed,
                1 if shuffle else 0, int(prefetch))
            if not self._h:
                raise OSError(f"cannot open token shard {str(path)!r} "
                              f"(needs > seq_len+1 tokens)")
            self.n_tokens = int(self._lib.cfa_loader_num_tokens(self._h))
            self._buf = np.empty((self.batch, self.width), np.int32)
        else:
            self._tokens = np.fromfile(path, dtype="<i4")
            self.n_tokens = int(self._tokens.size)
            if self.n_tokens <= self.width:
                raise OSError(f"cannot open token shard {str(path)!r} "
                              f"(needs > seq_len+1 tokens)")
            self._state = seed
            self._cursor = 0
            self._shuffle = bool(shuffle)

    @property
    def native(self) -> bool:
        return self._h is not None

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._h is not None:
            rc = self._lib.cfa_loader_next(
                self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if rc:
                raise RuntimeError("native loader failed")
            return self._buf.copy()
        out = np.empty((self.batch, self.width), np.int32)
        for b in range(self.batch):
            if self._shuffle:
                self._state, r = _xorshift64s(self._state)
                start = r % (self.n_tokens - self.width)
            else:
                start = self._cursor
                self._cursor += self.width
                if self._cursor + self.width > self.n_tokens:
                    self._cursor = 0
            out[b] = self._tokens[start:start + self.width]
        return out

    def close(self):
        if self._h is not None:
            self._lib.cfa_loader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
