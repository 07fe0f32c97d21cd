"""ctypes binding of the C++ golden model (fhe_ram_tpu_torch/native/
fheram_native.cpp): exact wide-integer convolution, NTT and Garner
reconstruction, which the tests hold the port's arithmetic against, and
the RAM's byte (de)interleaving.

Counterpart of fhe_ram_tpu/utils/native.py.  The source is a verbatim copy
of the repository's native/fheram_native.cpp (tests/test_torch_native.py
holds it byte-equal), so the port needs nothing of the JAX side.  It is
built at first use with g++ into the git-ignored fhe_ram_tpu_torch/build/,
under a hash of its bytes.  A build that fails raises, with g++'s output:
nothing here answers "unavailable" for a broken build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "fheram_native.cpp"
_BUILD = _PKG / "build"
_lib = None


def available() -> bool:
    """Whether this machine has g++ to build the library with; a build
    that fails all the same raises at first use."""
    return shutil.which("g++") is not None


def build(src: Path = SOURCE) -> Path:
    """g++ src into build/libfheram_native_<hash>.so (once; written under
    another name and renamed, so that processes building at once never see
    half a library).  Raises RuntimeError with g++'s output on failure."""
    src = Path(src)
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libfheram_native_{tag}.so"
    if so.exists():
        return so
    _BUILD.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the golden model cannot be built") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {src}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        sigs = {
            "negacyclic_conv_i64": [i64p, i64p, i64p, ctypes.c_int, ctypes.c_int64],
            "negacyclic_ntt_ref": [i64p, i64p, ctypes.c_int, ctypes.c_uint64,
                                   ctypes.c_uint64],
            "garner3_digits": [i64p, i64p, i64p, ctypes.c_int, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                               ctypes.c_int, i64p],
            "deinterleave_i8": [u8p, i32p, ctypes.c_int64, ctypes.c_int],
            "interleave_u8": [i32p, u8p, ctypes.c_int64, ctypes.c_int]}
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, None
        _lib = lib
    return _lib


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def negacyclic_conv(a, b, modulus: int = 0):
    """Exact negacyclic convolution of two int64[n] (accumulated in
    __int128): raw int64 when modulus is 0 (|result| < 2^63 is the
    caller's), else centered mod `modulus`."""
    a, b = _i64(a), _i64(b)
    if a.shape != b.shape or a.ndim != 1:
        raise ValueError(f"operands {a.shape}, {b.shape}: two vectors of one length")
    out = np.zeros_like(a)
    _load().negacyclic_conv_i64(a, b, out, len(a), modulus)
    return out


def negacyclic_ntt(a, p: int, psi: int):
    """Naive O(n^2) negacyclic NTT: out[k] = sum_i a_i psi^((2k+1) i) mod p,
    centered, natural order."""
    a = _i64(a)
    out = np.zeros_like(a)
    _load().negacyclic_ntt_ref(a, out, len(a), p, psi)
    return out


def garner3_digits(r1, r2, r3, primes, base_bits: int, ndig: int):
    """Residues mod three primes -> the centered integer's balanced
    base-2^base_bits digits, int64[n, ndig] (least significant first)."""
    r1, r2, r3 = _i64(r1), _i64(r2), _i64(r3)
    if not r1.shape == r2.shape == r3.shape or r1.ndim != 1:
        raise ValueError("three residue vectors of one length")
    out = np.zeros((len(r1), ndig), dtype=np.int64)
    _load().garner3_digits(r1, r2, r3, len(r1), primes[0], primes[1], primes[2],
                           base_bits, ndig, out)
    return out


def deinterleave_i8(data, max_addr: int, word_size: int):
    """RAM bytes data[addr * W + w] -> int32[W, max_addr], each byte as an
    int8."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if data.size != max_addr * word_size:
        raise ValueError(f"{data.size} bytes for {max_addr} words of {word_size}")
    out = np.zeros((word_size, max_addr), dtype=np.int32)
    _load().deinterleave_i8(data, out, max_addr, word_size)
    return out


def interleave_u8(arr, max_addr: int, word_size: int):
    """Inverse of deinterleave_i8: int32[W, max_addr] -> uint8[max_addr * W]
    (each value's low byte)."""
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    if arr.shape != (word_size, max_addr):
        raise ValueError(f"{arr.shape} for {word_size} x {max_addr}")
    out = np.zeros(max_addr * word_size, dtype=np.uint8)
    _load().interleave_u8(arr, out, max_addr, word_size)
    return out
