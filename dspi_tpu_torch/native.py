"""ctypes binding of the host data plane in native/dspi_host.cpp.

The JAX package's ``native.py``, cut to what the port's entry points use:
packet (de)framing (``unpack_s16``, ``unpack_s24``, ``pack_s24``,
``deframe_batch``, ``to_time_major``) and ``crc32``.  The firmware oracle
classes of the same library are test aids and are not bound here.

The library is built on first use with g++ from the repo's
``native/dspi_host.cpp`` into ``dspi_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded; ``native/`` itself is only
read.  Where the library cannot be built, every entry point raises: the
framed serving path has no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "native" / "dspi_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O2", "-fPIC", "-fvisibility=hidden", "-fwrapv", "-pthread",
             "-shared")

_lib = None


def lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdspi_host-{digest[:16]}.so"


def _load():
    """The bound library, built first if it is missing; raises
    RuntimeError with the compiler's output when it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        raise RuntimeError(f"native source {SOURCE} is missing")
    out = lib_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        try:
            done = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp),
                                   str(SOURCE)], capture_output=True,
                                  text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++: {e}") from e
        if done.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n"
                               f"{done.stdout}{done.stderr}")
        os.replace(tmp, out)            # atomic: a concurrent build is safe
    lib = ctypes.CDLL(str(out))

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.dspi_crc32.restype = ctypes.c_uint32
    lib.dspi_crc32.argtypes = [u8p, ctypes.c_uint64]
    lib.dspi_unpack_s16.argtypes = [u8p, i64, i32p, i32p]
    lib.dspi_unpack_s24.argtypes = [u8p, i64, i32p, i32p]
    lib.dspi_pack_s24.argtypes = [i32p, i32p, i64, u8p]
    lib.dspi_to_time_major.argtypes = [i32p, i64, i64, i32p]
    for fn in (lib.dspi_deframe_s16_batch, lib.dspi_deframe_s24_batch):
        fn.argtypes = [u8p, i64, i64, i64, i32p, ctypes.c_int32]
    _lib = lib
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _bytes(data) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))


def unpack_s16(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved s16 LRLR bytes -> (left, right) int32 arrays."""
    lib = _load()
    buf = _bytes(data)
    frames = len(buf) // 4
    out_l = np.empty(frames, np.int32)
    out_r = np.empty(frames, np.int32)
    lib.dspi_unpack_s16(_u8p(buf), frames, _i32p(out_l), _i32p(out_r))
    return out_l, out_r


def unpack_s24(data: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Packed s24 LRLR bytes (6 B/frame) -> (left, right) int32 arrays."""
    lib = _load()
    buf = _bytes(data)
    frames = len(buf) // 6
    out_l = np.empty(frames, np.int32)
    out_r = np.empty(frames, np.int32)
    lib.dspi_unpack_s24(_u8p(buf), frames, _i32p(out_l), _i32p(out_r))
    return out_l, out_r


def pack_s24(left: np.ndarray, right: np.ndarray) -> bytes:
    lib = _load()
    left = np.ascontiguousarray(left, np.int32).ravel()
    right = np.ascontiguousarray(right, np.int32).ravel()
    if len(left) != len(right):
        raise ValueError(f"{len(left)} left samples, {len(right)} right")
    out = np.empty(len(left) * 6, np.uint8)
    lib.dspi_pack_s24(_i32p(left), _i32p(right), len(left), _u8p(out))
    return out.tobytes()


def deframe_batch(payloads: np.ndarray, npkt: int, block: int,
                  bit_depth: int = 16, n_threads: int = 0) -> np.ndarray:
    """Batched USB-byte deframe straight into the engine's input layout.

    ``payloads``: uint8 [B, npkt*block*bpf] — each row one stream's raw
    USB payload byte stream (bpf = 4 for interleaved s16 LRLR, 6 for
    packed s24 LRLR; unpack semantics usb_audio.c:591-594 / 997-1006).
    Returns int32 [npkt, 2, block, B] — deframe, channel split,
    packetization and the lane transpose in one multithreaded native pass.

    ``n_threads`` 0 = DSPI_NATIVE_THREADS env or all cores."""
    lib = _load()
    bpf = 6 if bit_depth == 24 else 4
    payloads = np.ascontiguousarray(payloads, np.uint8)
    b, nbytes = payloads.shape
    if nbytes != npkt * block * bpf:
        raise ValueError(f"payload rows carry {nbytes} bytes; "
                         f"npkt*block*bpf = {npkt * block * bpf}")
    if not n_threads:
        n_threads = int(os.environ.get("DSPI_NATIVE_THREADS", 0)) \
            or (os.cpu_count() or 1)
    out = np.empty((npkt, 2, block, b), np.int32)
    fn = (lib.dspi_deframe_s24_batch if bit_depth == 24
          else lib.dspi_deframe_s16_batch)
    fn(_u8p(payloads), b, npkt, block, _i32p(out), n_threads)
    return out


def to_time_major(planar: np.ndarray) -> np.ndarray:
    """[B, T] int32 -> [T, B] int32 via the native transpose."""
    lib = _load()
    planar = np.ascontiguousarray(planar, np.int32)
    b, t = planar.shape
    out = np.empty((t, b), np.int32)
    lib.dspi_to_time_major(_i32p(planar), b, t, _i32p(out))
    return out


def crc32(data: bytes) -> int:
    buf = _bytes(data)
    return int(_load().dspi_crc32(_u8p(buf), len(buf)))
