"""ctypes bindings of the port's host library (csrc/host/vdf_witness.cpp):
the VDF witness chains on 4 x 64-bit Montgomery words.

The library is compiled with g++ at first use into `build/` at the repo
root under a hash of its source, like the CUDA kernels (field/kernels.py),
and needs no GPU. A missing compiler or a failed build raises: there is
no quiet step back to the Python chain (ask the models for
`witness="python"` instead). The JAX package's counterpart is
hodor_tpu/utils/native.py over native/vdf_witness.cpp.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from typing import List, Tuple

import numpy as np

from ..field.field import Field

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG_DIR, "csrc", "host", "vdf_witness.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_MASK64 = (1 << 64) - 1


def build_host_library() -> str:
    """Compile csrc/host/vdf_witness.cpp into build/libhodor_host_<hash>.so
    unless that file exists. Returns the library path."""
    with open(HOST_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"libhodor_host_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native witness chains need a C++ compiler "
                               "(witness=\"python\" asks the models for the Python chain)")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            linked = os.path.join(tmp, "lib.so")
            res = subprocess.run([gxx, *GXX_FLAGS, "-o", linked, HOST_SRC],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}) on {HOST_SRC}\n{res.stdout}")
            os.replace(linked, lib_path)
    return lib_path


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_host_library())
    u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    head = [u64p, ctypes.c_uint64, u64p, u64p, u64p, u64p, ctypes.c_long]
    lib.hodor_vdf_witness.argtypes = head + [u64p] * 2
    lib.hodor_vdf_witness.restype = None
    lib.hodor_cubic_vdf_witness.argtypes = head + [u64p] * 4
    lib.hodor_cubic_vdf_witness.restype = None
    return lib


def _words4(value: int) -> np.ndarray:
    return np.array([(value >> (64 * i)) & _MASK64 for i in range(4)], dtype=np.uint64)


def _chain_args(field: Field, c0: int, c1: int, num_ops: int):
    """The leading arguments of both chains: p, -p^-1 mod 2^64, 2^512 mod p,
    the non-residue -1, the start element, the number of steps."""
    p = field.p
    if p % 2 == 0 or field.num_bits > 256:
        raise ValueError(f"{field}: the native witness chains take odd moduli of at most 256 "
                         f"bits (witness=\"python\" has no such limit)")
    if num_ops < 0:
        raise ValueError(f"num_ops must be non-negative, got {num_ops}")
    inv = (-pow(p, -1, 1 << 64)) & _MASK64
    return (_words4(p), inv, _words4(pow(1 << 256, 2, p)), _words4(p - 1), _words4(c0 % p),
            _words4(c1 % p), num_ops)


def vdf_witness_native(field: Field, c0: int, c1: int, num_ops: int) -> Tuple[np.ndarray, ...]:
    """The quadratic VDF chain from (c0, c1): the registers (c0_w, c1_w) as
    (num_ops + 1, 4) uint64 arrays of canonical little-endian words."""
    outs = tuple(np.empty((num_ops + 1, 4), dtype=np.uint64) for _ in range(2))
    _lib().hodor_vdf_witness(*_chain_args(field, c0, c1, num_ops), *outs)
    return outs


def cubic_vdf_witness_native(field: Field, c0: int, c1: int,
                             num_ops: int) -> Tuple[np.ndarray, ...]:
    """The cubic VDF chain from (c0, c1): the registers (c0_w, c1_w, sq0_w,
    sq1_w) as (num_ops + 1, 4) uint64 arrays of canonical little-endian
    words."""
    outs = tuple(np.empty((num_ops + 1, 4), dtype=np.uint64) for _ in range(4))
    _lib().hodor_cubic_vdf_witness(*_chain_args(field, c0, c1, num_ops), *outs)
    return outs


def u64_rows_to_ints(rows: np.ndarray) -> List[int]:
    """(N, 4) uint64 little-endian words -> Python ints (for the few
    boundary values; bulk data goes to device limbs as it is)."""
    return [int(r[0]) | (int(r[1]) << 64) | (int(r[2]) << 128) | (int(r[3]) << 192)
            for r in np.asarray(rows, dtype=np.uint64).reshape(-1, 4)]
