"""ctypes bindings of the port's host library: the VDF witness chains on
4 x 64-bit Montgomery words (csrc/host/vdf_witness.cpp), and keyed
Blake2s with Merkle helpers on the host (csrc/host/blake2s.cpp).

The library is compiled with g++ at first use into `build/` at the repo
root under a hash of its sources, like the CUDA kernels
(field/kernels.py), and needs no GPU. A missing compiler or a failed
build raises: there is no quiet step back to the Python chain (ask the
models for `witness="python"` instead) or to hashlib. The JAX package's
counterpart is hodor_tpu/utils/native.py over native/vdf_witness.cpp and
native/blake2s.cpp.
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
BLAKE2S_SRC = os.path.join(_PKG_DIR, "csrc", "host", "blake2s.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_MASK64 = (1 << 64) - 1


def build_host_library() -> str:
    """Compile csrc/host/vdf_witness.cpp and csrc/host/blake2s.cpp into
    build/libhodor_host_<hash>.so unless that file exists. Returns the
    library path."""
    srcs = (HOST_SRC, BLAKE2S_SRC)
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as f:
            h.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"libhodor_host_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native witness chains need a C++ compiler "
                               "(witness=\"python\" asks the models for the Python chain)")
        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            linked = os.path.join(tmp, "lib.so")
            res = subprocess.run([gxx, *GXX_FLAGS, "-o", linked, *srcs],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed ({res.returncode}) on {' '.join(srcs)}\n"
                                   f"{res.stdout}")
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
    c_char_p, c_long = ctypes.c_char_p, ctypes.c_long
    lib.hodor_blake2s.argtypes = [c_char_p, ctypes.c_int, c_char_p]
    lib.hodor_blake2s.restype = None
    lib.hodor_verify_path.argtypes = [c_char_p, c_char_p, ctypes.c_int, c_long, c_char_p]
    lib.hodor_verify_path.restype = ctypes.c_int
    lib.hodor_hash_leaves.argtypes = [c_char_p, c_long, c_char_p]
    lib.hodor_hash_leaves.restype = None
    lib.hodor_build_tree.argtypes = [c_char_p, c_long, c_char_p, c_char_p]
    lib.hodor_build_tree.restype = None
    return lib


def available() -> bool:
    """Whether the host library builds and loads here (g++ present, the
    build succeeds). Every other function of this module still raises
    where it does not: nothing steps back to Python code."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


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


# ------------------------------------------------------ keyed Blake2s (host)


def _check_len(name: str, data: bytes, size: int) -> None:
    if len(data) != size:
        raise ValueError(f"{name} must be {size} bytes, got {len(data)}")


def blake2s_keyed(data: bytes) -> bytes:
    """Keyed Blake2s-256 of `data` with the protocol's key and
    personalization (merkle/blake2s.py blake2s_keyed, in C++)."""
    if len(data) >= 1 << 31:
        raise ValueError("a message of 2 GiB or more does not fit the library's length")
    out = ctypes.create_string_buffer(32)
    _lib().hodor_blake2s(data, len(data), out)
    return out.raw


def verify_path(root: bytes, leaf32: bytes, path: List[bytes], tree_index: int) -> bool:
    """Merkle path check (reference Blake2sIopTree::verify,
    src/iop/blake2s_trivial_iop.rs:259-279): the 32-byte leaf, the sibling
    digests bottom-up, the leaf's index."""
    _check_len("leaf32", leaf32, 32)
    _check_len("root", root, 32)
    joined = b"".join(path)
    _check_len("the path", joined, 32 * len(path))
    return bool(_lib().hodor_verify_path(leaf32, joined, len(path), tree_index, root))


def hash_leaves(leaves32: bytes, n: int) -> bytes:
    """n 32-byte leaves -> their n digests, concatenated."""
    _check_len("leaves32", leaves32, 32 * n)
    out = ctypes.create_string_buffer(32 * n)
    _lib().hodor_hash_leaves(leaves32, n, out)
    return out.raw


def build_tree(leaves32: bytes, n: int) -> Tuple[bytes, bytes]:
    """A whole tree over n 32-byte leaves (n a power of two): (leaf hashes,
    nodes) in the reference's heap layout, nodes[1] the root (bytes
    32:64)."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"a tree needs a power-of-two leaf count >= 2, got {n}")
    _check_len("leaves32", leaves32, 32 * n)
    leaf_hashes = ctypes.create_string_buffer(32 * n)
    nodes = ctypes.create_string_buffer(32 * n)
    _lib().hodor_build_tree(leaves32, n, leaf_hashes, nodes)
    return leaf_hashes.raw, nodes.raw
