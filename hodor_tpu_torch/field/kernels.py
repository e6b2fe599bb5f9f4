"""The hand-written CUDA kernels of the port, their wrappers and their
plain PyTorch versions.

Seven kernels, one per TPU kernel of the JAX package
(hodor_tpu/field/pallas_kernels.py):

  mont_mul    <- pallas_mont_mul_v2 (and pallas_mont_mul)  csrc/mont_mul.cu
  addsub      <- pallas_addsub                              csrc/addsub.cu
  blake2s     <- pallas_blake2s                             csrc/blake2s.cu
  ntt_level   <- pallas_ntt_level                           csrc/ntt_level.cu
  fri_fold    <- pallas_fri_fold                            csrc/fri_fold.cu
  wide_reduce <- pallas_wide_reduce                         csrc/wide_reduce.cu
  dft_reduce  <- pallas_dft_reduce                          csrc/dft_reduce.cu

`s8dot` is dft_reduce's int8 contraction exported alone (the counterpart
of the bare int8 product probed by scripts/tpu_qualify.py check_s8dot);
its launches count as dft_reduce's. `dft_reduce` has two bodies in
dft_reduce.cu, s8 products on the int8 tensor cores over a resident x
tile and a streamed W ("mma") and `__dp4a` on the integer pipe ("dp4a");
the wrapper picks one from the field and the radix (`dft_reduce_body`),
and `dft_reduce_body_counts` counts each. `mont_pow` is a second entry of
mont_mul.cu: x^e for a static exponent in one launch (the one-program
exponent loop of hodor_tpu/field/limbs.py inv_fermat); its launches count
as mont_mul's. `ntt_level` has two bodies in ntt_level.cu, the byte-plane
contraction on the int8 tensor cores ("mma", csrc/byte_plane_mma.cuh) and
the limb arithmetic on the integer pipe ("limb"); the wrapper picks one
from the field and the radix (`ntt_level_body`), and
`ntt_level_body_counts` counts each beside their sum in `launch_counts`.
`mont_mul` has three bodies picked from the collapsed layout ("flat",
"grid", "general"; `mont_mul_body`), counted in `mont_mul_body_counts`.
`fri_fold` takes an optional leading lane axis, one proof of a batch a
lane with its own challenge, all lanes in one launch.

Every wrapper dispatches on the device of its tensors and nothing else:
a CPU tensor takes the plain version beside it (int64 torch ops, the
same function; mont_pow's on Python ints), a CUDA tensor launches the
kernel or raises. The kernels are compiled by nvcc from `csrc/` (one
nvcc per source, all started together) into one shared library under
`build/` at the repo root on first use, keyed by a hash of the sources,
and bound with ctypes. `launch_counts` counts each wrapper's launches.

Field arrays are (..., n16) int32 holding 16-bit Montgomery limbs;
Blake2s words are int32 holding u32 bit patterns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from .field import Field

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

KERNELS = ("mont_mul", "addsub", "blake2s", "ntt_level", "fri_fold", "wide_reduce",
           "dft_reduce")
launch_counts = {name: 0 for name in KERNELS}
NTT_LEVEL_BODIES = ("mma", "limb")
ntt_level_body_counts = {body: 0 for body in NTT_LEVEL_BODIES}
DFT_REDUCE_BODIES = ("mma", "dp4a")
dft_reduce_body_counts = {body: 0 for body in DFT_REDUCE_BODIES}
MONT_MUL_BODIES = ("flat", "grid", "general")
mont_mul_body_counts = {body: 0 for body in MONT_MUL_BODIES}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    for body in NTT_LEVEL_BODIES:
        ntt_level_body_counts[body] = 0
    for body in DFT_REDUCE_BODIES:
        dft_reduce_body_counts[body] = 0
    for body in MONT_MUL_BODIES:
        mont_mul_body_counts[body] = 0


# ------------------------------------------------------------------ build

_lib = None


def _sources():
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _run_all(commands):
    """Start every command at once, wait for all, return their outputs;
    raises with the compiler's output if one fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outputs


def build_kernels(verbose: bool = False) -> str:
    """Compile csrc/*.cu into build/libhodor_kernels_<hash>.so unless that
    file exists, and load it. Returns the library path. Each source is
    compiled by its own nvcc, all at once, then linked. With verbose, the
    compiler's resource report (-Xptxas -v) is printed."""
    global _lib
    srcs = _sources()
    h = hashlib.sha256()
    for path in srcs:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR, f"libhodor_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        extra = ["-Xptxas", "-v"] if verbose else []
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            units = [(p, os.path.join(tmp, os.path.basename(p) + ".o"))
                     for p in srcs if p.endswith(".cu")]
            reports = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-c", src, "-o", obj]
                                for src, obj in units])
            if verbose:
                print("".join(reports))
            linked = os.path.join(tmp, "lib.so")
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", linked, *[obj for _, obj in units]]])
            os.replace(linked, lib_path)
    if _lib is None or _lib._name != lib_path:
        _lib = _bind(ctypes.CDLL(lib_path))
    return lib_path


def _bind(lib):
    vp, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
    lib.hodor_mont_mul.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, u32, vp]
    lib.hodor_mont_pow.argtypes = [i32, vp, vp, i64, vp, i32, vp, vp, u32, vp]
    lib.hodor_addsub.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp, vp, vp]
    lib.hodor_blake2s.argtypes = [vp, vp, i64, i32, vp, u32, vp]
    lib.hodor_ntt_level.argtypes = [i32, vp, vp, vp, i64, i32, i64, i32, vp, vp, u32, vp, i32, vp]
    lib.hodor_ntt_level_mma.argtypes = lib.hodor_ntt_level.argtypes
    lib.hodor_fri_fold.argtypes = [i32, vp, i64, vp, i64, i64, vp, i64, i64, vp, i64, vp, i64, vp,
                                   i64, i64, vp, u32, vp]
    lib.hodor_wide_reduce.argtypes = [i32, vp, vp, i64, i32, i64, i32, vp, vp, u32, vp, i32, vp]
    lib.hodor_dft_reduce.argtypes = [i32, vp, vp, vp, vp, i64, i32, i64, i32, vp, vp, u32, vp,
                                     i32, vp]
    lib.hodor_dft_reduce_mma.argtypes = lib.hodor_dft_reduce.argtypes
    lib.hodor_s8dot.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    for fn in (lib.hodor_mont_mul, lib.hodor_mont_pow, lib.hodor_addsub, lib.hodor_blake2s,
               lib.hodor_ntt_level, lib.hodor_ntt_level_mma, lib.hodor_fri_fold,
               lib.hodor_wide_reduce, lib.hodor_dft_reduce, lib.hodor_dft_reduce_mma,
               lib.hodor_s8dot):
        fn.restype = ctypes.c_int
    return lib


def _kernels():
    if _lib is None:
        build_kernels()
    return _lib


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {code}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _i64_array(values):
    return (ctypes.c_longlong * len(values))(*values)


def _u32_array(values):
    return (ctypes.c_uint32 * len(values))(*values)


# ------------------------------------------------------------- constants

def _int_limbs(value: int, n16: int) -> np.ndarray:
    """int64 limbs of a Python int (the plain versions' constants)."""
    return np.array([(value >> (16 * i)) & 0xFFFF for i in range(n16)], dtype=np.int64)


def _words(value: int, nw: int):
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(nw)]


def _pinv0(field: Field) -> int:
    """-p^-1 mod 2^32, the word-serial Montgomery constant of the kernels."""
    return (-pow(field.p, -1, 1 << 32)) % (1 << 32)


@lru_cache(maxsize=None)
def _field_args(field: Field):
    """What every launch of a field's kernels passes and no launch changes:
    (p as ctypes words, -p^-1 mod 2^32, the Montgomery one as ctypes words)."""
    nw = field.n16 // 2
    return (_u32_array(_words(field.p, nw)), _pinv0(field), _u32_array(_words(field.R_mod_p, nw)))


@lru_cache(maxsize=None)
def _field_limbs(field: Field, device: torch.device):
    """(p, -p^-1 mod R) as int64 limb tensors, for the plain versions."""
    n16 = field.n16
    return (torch.as_tensor(_int_limbs(field.p, n16), device=device),
            torch.as_tensor(_int_limbs(field.p_inv_neg, n16), device=device))


@lru_cache(maxsize=None)
def reduction_chain(field: Field, radix: int) -> Tuple[int, ...]:
    """Multiples m*p to subtract conditionally, in order, bringing the
    Montgomery reduction u < radix*p^2/R + p of a radix-term sum below p
    (derived from exact integer bounds, as ntt/matmul.py _reduction_chain
    in the JAX package)."""
    p = field.p
    bound = radix * p * p // field.R + p + 1
    mults = []
    while bound > p:
        m = 1
        while 2 * m * p < bound:
            m *= 2
        mults.append(m * p)
        bound = max(bound - m * p, m * p)
    return tuple(mults)


# ------------------------------------------------- plain limb arithmetic

def _mul_cols(a, b):
    """Schoolbook column sums of (..., n) int64 limbs -> (..., 2n)."""
    n = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    cols = torch.zeros(shape[:-1] + (2 * n,), dtype=torch.int64, device=a.device)
    for i in range(n):
        cols[..., i:i + n] += a[..., i:i + 1] * b
    return cols


def _carry(cols, n_out: int):
    """Non-negative int64 columns -> n_out carried 16-bit limbs (the carry
    out of the top limb is dropped)."""
    outs = []
    carry = torch.zeros(cols.shape[:-1], dtype=torch.int64, device=cols.device)
    for k in range(n_out):
        t = cols[..., k] + carry if k < cols.shape[-1] else carry
        outs.append(t & 0xFFFF)
        carry = t >> 16
    return torch.stack(outs, dim=-1)


def _sub_with_borrow(a, b):
    """Limbwise a - b -> (difference limbs, borrow out 0/1)."""
    n = a.shape[-1]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    outs = []
    borrow = torch.zeros(shape[:-1], dtype=torch.int64, device=a.device)
    for k in range(n):
        t = a[..., k] + 0x10000 - b[..., k] - borrow
        outs.append(t & 0xFFFF)
        borrow = 1 - (t >> 16)
    return torch.stack(outs, dim=-1), borrow


def _cond_sub(u, m_limbs):
    diff, borrow = _sub_with_borrow(u, m_limbs)
    return torch.where((borrow == 0)[..., None], diff, u)


def _mont_reduce_plain(field: Field, t):
    """t: (..., >= 2n) carried limbs of t < p*R*2^k -> (t + m p)/R limbs
    (n + 1 of them, not yet reduced below p)."""
    n = field.n16
    p_l, pinv_l = _field_limbs(field, t.device)
    m = _carry(_mul_cols(t[..., :n], pinv_l), n)
    width = t.shape[-1]
    mp = _mul_cols(m, p_l)
    if width > 2 * n:
        mp = torch.cat([mp, torch.zeros(mp.shape[:-1] + (width - 2 * n,),
                                        dtype=torch.int64, device=t.device)], dim=-1)
    return _carry(t + mp, width + 1)[..., n:]


def mont_mul_plain(field: Field, a, b):
    n = field.n16
    p_l, _ = _field_limbs(field, a.device)
    t = _carry(_mul_cols(a.to(torch.int64), b.to(torch.int64)), 2 * n)
    u = _mont_reduce_plain(field, t)[..., :n]  # u < 2p fits n limbs
    return _cond_sub(u, p_l).to(torch.int32)


def addsub_plain(field: Field, a, b, mode: str):
    n = field.n16
    p_l, _ = _field_limbs(field, a.device)
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    if mode == "add":
        s = _carry(a + b, n + 1)
        carry_out = s[..., n]
        s = s[..., :n]
        diff, borrow = _sub_with_borrow(s, p_l)
        ge = (borrow == 0) | (carry_out > 0)
        return torch.where(ge[..., None], diff, s).to(torch.int32)
    if mode == "sub":
        d, borrow = _sub_with_borrow(a, b)
        fixed = _carry(d + p_l, n)
        return torch.where((borrow == 1)[..., None], fixed, d).to(torch.int32)
    raise ValueError(f"mode must be 'add' or 'sub', not {mode!r}")


# ------------------------------------------------ elementwise dispatch

def _check_limbs(field: Field, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"limb tensors must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.dim() < 1 or t.shape[-1] != field.n16:
            raise ValueError(f"last dim must be n16={field.n16}, got shape {tuple(t.shape)}")


def _collapse(shape, strides_per_operand):
    """Collapse the element dims of a broadcast into as few dims as the
    operands' strides allow. Returns [(size, [stride per operand])]."""
    merged = []
    for i, size in enumerate(shape):
        if size == 1:
            continue
        strides = [st[i] for st in strides_per_operand]
        if merged:
            psize, pstrides = merged[-1]
            if all(ps == s * size for ps, s in zip(pstrides, strides)):
                merged[-1] = (psize * size, strides)
                continue
        merged.append((size, strides))
    return merged


def _launch_geometry(a, b, out_shape):
    """(a, b, dims[3], a_strides[3], b_strides[3]) in int32 units for an
    elementwise kernel over the element dims of out_shape; broadcast dims
    get stride 0. An operand layout that does not collapse to three dims
    is copied to a contiguous broadcast first. The kernels read an element
    through 16-byte loads: a base pointer or a stride that is not a
    multiple of 16 bytes is refused."""
    elem_shape = tuple(out_shape[:-1])

    def merged_dims(x, y):
        views = [t.expand(out_shape) for t in (x, y)]
        if any(t.stride(-1) != 1 for t in views):
            raise ValueError("limb dim must have stride 1")
        return _collapse(elem_shape, [t.stride()[:-1] for t in views])

    if elem_shape and all(
            t.shape == out_shape and t.is_contiguous() or (t.dim() == 1 and t.stride(0) == 1)
            for t in (a, b)):
        # both operands of the output's shape and contiguous, or one the
        # (n16,) scalar: one flat dim, no collapse to work out
        n = 1
        for size in elem_shape:
            n *= size
        merged = [(n, [0 if t.dim() == 1 else out_shape[-1] for t in (a, b)])]
    else:
        merged = merged_dims(a, b)
        if len(merged) > 3:
            a, b = (t.expand(out_shape).contiguous() for t in (a, b))
            merged = merged_dims(a, b)
    merged = [(1, [0, 0])] * (3 - len(merged)) + merged
    dims = [m[0] for m in merged]
    a_st, b_st = ([m[1][k] for m in merged] for k in (0, 1))
    for t, st in ((a, a_st), (b, b_st)):
        if t.data_ptr() % 16 or any(v % 4 for v in st):
            raise ValueError("limb elements must lie at 16-byte aligned addresses")
    return a, b, dims, a_st, b_st


def _out_tensor(out, shape, like):
    if out is None:
        return torch.empty(shape, dtype=torch.int32, device=like.device)
    if tuple(out.shape) != tuple(shape) or not out.is_contiguous() or out.dtype != torch.int32:
        raise ValueError("out must be a contiguous int32 tensor of the broadcast shape")
    return out


def mont_mul_body(a, b) -> str:
    """The body of mont_mul.cu that a product of a and b launches, from
    the collapsed layout as its launcher picks it: "flat" (one element
    dim), "grid" (outer two dims on the grid, inner at least a warp wide)
    or "general" (element_at division)."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return _mont_mul_body(_launch_geometry(a, b, shape)[2])


def _mont_mul_body(dims) -> str:
    if dims[0] == 1 and dims[1] == 1:
        return "flat"
    if dims[0] <= 65535 and dims[1] <= 65535 and dims[2] >= 32:
        return "grid"
    return "general"


def mont_mul(field: Field, a, b, out=None):
    """Elementwise Montgomery product a*b*R^-1 mod p of (..., n16) limbs
    (broadcasting). CPU: plain version. CUDA: the mont_mul kernel."""
    _check_limbs(field, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.device.type == "cpu":
        res = mont_mul_plain(field, a, b)
        if out is None:
            return res
        out.copy_(res)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _out_tensor(out, shape, a)
    if out.numel() == 0:
        return out
    a, b, dims, a_st, b_st = _launch_geometry(a, b, shape)
    p_words, pinv0, _ = _field_args(field)
    code = _kernels().hodor_mont_mul(
        field.n16, out.data_ptr(), a.data_ptr(), _i64_array(a_st), b.data_ptr(),
        _i64_array(b_st), _i64_array(dims), p_words, pinv0, _stream(),
    )
    _check(code, "mont_mul")
    launch_counts["mont_mul"] += 1
    mont_mul_body_counts[_mont_mul_body(dims)] += 1
    return out


def mont_pow_plain(field: Field, x, e: int):
    """x^e in Montgomery form on Python ints, element by element: for
    x = a R mod p the result is a^e R = x^e R^(1 - e) mod p (the Montgomery
    one for e = 0). A square-and-multiply over the plain product costs
    about 1.5 log2(e) sequential tensor products; this is one modular
    power an element."""
    p, n16 = field.p, field.n16
    limbs = x.detach().cpu().numpy().astype("<u2").reshape(-1, n16)
    scale = pow(field.R, 1 - e, p)
    out = b"".join((pow(int.from_bytes(row.tobytes(), "little"), e, p) * scale % p)
                   .to_bytes(2 * n16, "little") for row in limbs)
    words = np.frombuffer(out, dtype="<u2").astype(np.int32).reshape(x.shape)
    return torch.from_numpy(words).to(x.device)


def mont_pow(field: Field, x, e: int):
    """Elementwise x^e (Montgomery form in and out) of contiguous (..., n16)
    limbs for a static exponent 0 <= e < 2^(16 n16), in one launch whatever
    e is. CPU: plain version. CUDA: the mont_pow entry of the mont_mul
    kernel; its launches count as mont_mul's."""
    _check_limbs(field, x)
    if e < 0 or e.bit_length() > 16 * field.n16:
        raise ValueError(f"exponent must be in [0, 2^{16 * field.n16}), got {e}")
    if x.device.type == "cpu":
        return mont_pow_plain(field, x, e)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("mont_pow takes contiguous limbs at a 16-byte aligned address")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    p_words, pinv0, one_words = _field_args(field)
    code = _kernels().hodor_mont_pow(
        field.n16, out.data_ptr(), x.data_ptr(), x.numel() // field.n16,
        _u32_array(_words(e, field.n16 // 2)), e.bit_length(), one_words, p_words, pinv0,
        _stream(),
    )
    _check(code, "mont_pow")
    launch_counts["mont_mul"] += 1
    return out


def addsub(field: Field, a, b, mode: str, out=None):
    """Elementwise modular a+b ('add') or a-b ('sub') of (..., n16) limbs
    (broadcasting). CPU: plain version. CUDA: the addsub kernel."""
    if mode not in ("add", "sub"):
        raise ValueError(f"mode must be 'add' or 'sub', not {mode!r}")
    _check_limbs(field, a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if a.device.type == "cpu":
        res = addsub_plain(field, a, b, mode)
        if out is None:
            return res
        out.copy_(res)
        return out
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = _out_tensor(out, shape, a)
    if out.numel() == 0:
        return out
    a, b, dims, a_st, b_st = _launch_geometry(a, b, shape)
    code = _kernels().hodor_addsub(
        field.n16, 0 if mode == "add" else 1, out.data_ptr(), a.data_ptr(), _i64_array(a_st),
        b.data_ptr(), _i64_array(b_st), _i64_array(dims), _field_args(field)[0], _stream(),
    )
    _check(code, "addsub")
    launch_counts["addsub"] += 1
    return out


# ----------------------------------------------------------------- blake2s

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

_M32 = 0xFFFFFFFF


def u32_to_i32(t64):
    """int64 tensor of values in [0, 2^32) -> int32 with the same bits."""
    return torch.where(t64 >= (1 << 31), t64 - (1 << 32), t64).to(torch.int32)


def blake2s_compress_plain(h, m, t: int, final: bool):
    """One Blake2s compression (RFC 7693's F) of (..., 16) message words
    from (..., 8) states, both int32 or int64 tensors carrying u32 bit
    patterns, broadcast against each other; t the byte counter, final
    whether this is the last block. -> (..., 8) int32."""
    dev = m.device
    lead = torch.broadcast_shapes(h.shape[:-1], m.shape[:-1])
    h = (h.to(torch.int64) & _M32).expand(lead + (8,))
    m = (m.to(torch.int64) & _M32).expand(lead + (16,))
    msg = [m[..., k] for k in range(16)]

    def rotr(x, r):
        return ((x >> r) | (x << (32 - r))) & _M32

    v = [h[..., i] for i in range(8)] + [torch.full(lead, c, dtype=torch.int64, device=dev)
                                         for c in IV]
    v[12] = v[12] ^ (t & _M32)
    v[13] = v[13] ^ ((t >> 32) & _M32)
    if final:
        v[14] = v[14] ^ _M32

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M32
        v[d] = rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M32
        v[b] = rotr(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + y) & _M32
        v[d] = rotr(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & _M32
        v[b] = rotr(v[b] ^ v[c], 7)

    for r in range(10):
        s = SIGMA[r]
        g(0, 4, 8, 12, msg[s[0]], msg[s[1]])
        g(1, 5, 9, 13, msg[s[2]], msg[s[3]])
        g(2, 6, 10, 14, msg[s[4]], msg[s[5]])
        g(3, 7, 11, 15, msg[s[6]], msg[s[7]])
        g(0, 5, 10, 15, msg[s[8]], msg[s[9]])
        g(1, 6, 11, 12, msg[s[10]], msg[s[11]])
        g(2, 7, 8, 13, msg[s[12]], msg[s[13]])
        g(3, 4, 9, 14, msg[s[14]], msg[s[15]])
    return u32_to_i32(torch.stack([h[..., i] ^ v[i] ^ v[i + 8] for i in range(8)], dim=-1))


def blake2s_plain(m_words, message_bytes: int, midstate: Sequence[int]):
    """Keyed Blake2s of one final block per message, from the post-key
    midstate; m_words (..., message_bytes // 4) int32 -> (..., 8) int32."""
    m = torch.zeros(m_words.shape[:-1] + (16,), dtype=torch.int64, device=m_words.device)
    m[..., :m_words.shape[-1]] = m_words
    h = torch.tensor(list(midstate), dtype=torch.int64, device=m_words.device)
    return blake2s_compress_plain(h, m, 64 + message_bytes, True)


def blake2s(m_words, message_bytes: int, midstate: Sequence[int]):
    """Keyed Blake2s of (..., message_bytes // 4) int32 words, one final
    block per message (message_bytes 32 for a leaf, 64 for a node).
    CPU: plain version. CUDA: the blake2s kernel."""
    if message_bytes not in (32, 64):
        raise ValueError("message_bytes must be 32 or 64")
    if m_words.dtype != torch.int32 or m_words.shape[-1] != message_bytes // 4:
        raise ValueError(
            f"expected (..., {message_bytes // 4}) int32 words, got "
            f"{tuple(m_words.shape)} {m_words.dtype}")
    if m_words.device.type == "cpu":
        return blake2s_plain(m_words, message_bytes, midstate)
    if m_words.device.type != "cuda":
        raise ValueError(f"unsupported device {m_words.device}")
    if not m_words.is_contiguous():
        raise ValueError("message words must be contiguous")
    lead = m_words.shape[:-1]
    n = int(np.prod(lead, dtype=np.int64)) if lead else 1
    out = torch.empty(lead + (8,), dtype=torch.int32, device=m_words.device)
    if n == 0:
        return out
    code = _kernels().hodor_blake2s(
        out.data_ptr(), m_words.data_ptr(), n, message_bytes // 4,
        _u32_array([int(x) & _M32 for x in midstate]), (64 + message_bytes) & _M32, _stream(),
    )
    _check(code, "blake2s")
    launch_counts["blake2s"] += 1
    return out


# --------------------------------------------------------------- NTT level

def _reduce_wide_plain(field: Field, t, radix: int):
    """t: (..., 2 n16 + 1) carried limbs of an integer below radix * p^2
    -> its Montgomery reduction t * R^-1 mod p, canonical (..., n16) int32."""
    n = field.n16
    u = _mont_reduce_plain(field, t)  # n + 2 limbs
    for mult in reduction_chain(field, radix):
        u = _cond_sub(u, torch.as_tensor(_int_limbs(mult, n + 2), device=t.device))
    return u[..., :n].to(torch.int32)


def ntt_level_plain(field: Field, x, w, tw=None):
    """x (B, S, C, n16), w (S, S, n16) Montgomery DFT matrix, tw None |
    (n16,) | (S, C, n16) -> (B, S, C, n16): the schoolbook wide sums
    t = sum_j w[k, j] x[b, j, c], Montgomery-reduced, brought below p by
    the reduction chain, times tw."""
    n = field.n16
    bsz, size, cols, _ = x.shape
    dev = x.device
    x64 = x.to(torch.int64)
    w64 = w.to(torch.int64)
    diag = (torch.arange(n, device=dev)[:, None] + torch.arange(n, device=dev)[None, :]).reshape(-1)
    acc = torch.zeros((bsz, size, cols, 2 * n), dtype=torch.int64, device=dev)
    for j in range(size):
        prod = w64[None, :, j, None, :, None] * x64[:, None, j, :, None, :]  # (B,S,C,n,n)
        acc.index_add_(3, diag, prod.reshape(bsz, size, cols, n * n))
    u = _reduce_wide_plain(field, _carry(acc, 2 * n + 1), size)
    if tw is not None:
        u = mont_mul_plain(field, u, tw)
    return u


def byte_planes(limbs):
    """(..., n16) 16-bit limbs -> (..., 2 n16) uint8: the element's bytes,
    little-endian (plane 2 i the low byte of limb i, plane 2 i + 1 the high)."""
    return torch.stack([limbs & 0xFF, limbs >> 8], dim=-1).reshape(
        limbs.shape[:-1] + (2 * limbs.shape[-1],)).to(torch.uint8)


def dft_byte_planes(w):
    """The (S, S, n16) limb DFT matrix as the (P, S, S) uint8 byte-plane
    matrix the tensor-core body of ntt_level reads: plane q, row k, depth j
    holds byte q of W[k, j]; P = 2 n16."""
    return byte_planes(w).permute(2, 0, 1).contiguous()


def ntt_level_planes_plain(field: Field, x, w_planes, tw=None):
    """The arithmetic of ntt_level's tensor-core body in torch ops: x
    (B, S, C, n16) split into P = 2 n16 byte planes, base-256 column c of
    the exact sums as the byte dots sum_{qi + qj = c} Wb[qi] . xb[qj]
    (float64 products of bytes, exact: a column stays below 2^28), the
    2 P - 1 columns walked in order with a running carry that gives one
    byte of t a column, then the Montgomery reduction, the chain and the
    twiddle as in ntt_level_plain."""
    n = field.n16
    planes = 2 * n
    size = x.shape[1]
    xf = byte_planes(x).permute(3, 0, 1, 2).to(torch.float64)  # (P, B, S, C)
    wf = w_planes.to(torch.float64)  # (P, S, S)
    run = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    t_bytes = []
    for c in range(2 * planes - 1):
        col = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
        for qi in range(max(0, c - planes + 1), min(c, planes - 1) + 1):
            col += torch.matmul(wf[qi], xf[c - qi])
        run = run + col.to(torch.int64)
        t_bytes.append(run & 0xFF)
        run = run >> 8
    t_bytes.append(run)  # the top byte: t < S p^2 < 256^(2 P)
    t8 = torch.stack(t_bytes, dim=-1)  # (B, S, C, 2 P)
    t16 = t8[..., 0::2] | (t8[..., 1::2] << 8)
    t16 = torch.cat([t16, torch.zeros_like(t16[..., :1])], dim=-1)
    u = _reduce_wide_plain(field, t16, size)
    if tw is not None:
        u = mont_mul_plain(field, u, tw)
    return u


def _check_level_tw(field: Field, device, size: int, cols: int, tw) -> None:
    """A level's twiddle: None, an (n16,) scalar or an (S, C, n16) table,
    on the level's device, contiguous where a kernel reads it."""
    if tw is None:
        return
    _check_limbs(field, tw)
    if tw.device != device:
        raise ValueError(f"twiddle on {tw.device}, operands on {device}")
    if tuple(tw.shape) not in ((field.n16,), (size, cols, field.n16)):
        raise ValueError(f"tw must be (n16,) or ({size}, {cols}, n16), got {tuple(tw.shape)}")
    if device.type == "cuda" and not tw.is_contiguous():
        raise ValueError("the twiddle must be contiguous")


def _level_args(field: Field, radix: int, tw):
    """The trailing arguments the level kernels share: twiddle mode and
    pointer, p, -p^-1 mod 2^32, the reduction chain and its length.
    Raises where a level's exact sums could outgrow the kernels' 2 n16
    limbs: the radix must keep radix * p^2 < 2^(32 n16) (ntt/matmul.py
    max_radix)."""
    if radix * field.p * field.p >= 1 << (32 * field.n16):
        raise ValueError(f"radix {radix} is above {field}'s bound radix * p^2 < "
                         f"2^{32 * field.n16}")
    nw = field.n16 // 2
    chain = reduction_chain(field, radix)
    chain_words = [wd for m in chain for wd in _words(m, nw)]
    tw_mode = 0 if tw is None else (1 if tw.dim() == 1 else 2)
    p_words, pinv0, _ = _field_args(field)
    return (tw_mode, tw.data_ptr() if tw is not None else None, p_words, pinv0,
            _u32_array(chain_words) if chain_words else None, len(chain))


MMA_RADICES = (32, 64, 128)


def ntt_level_body(field: Field, size: int) -> str:
    """Which body of the ntt_level kernel a level takes, from the field and
    the radix alone: "mma" (byte planes on the int8 tensor cores) for a
    16-limb field at S = 32, 64 or 128, whose depth fills the products'
    32 bytes; "limb" (the integer pipe) for every other S <= 128, which is
    the 4-limb fields and the small terminal radices. Raises where neither
    applies."""
    if field.n16 == 16 and size in MMA_RADICES:
        return "mma"
    if field.n16 in (4, 16) and 1 <= size <= 128:
        return "limb"
    raise ValueError(f"ntt_level takes n16 of 4 or 16 and S <= 128, got n16={field.n16}, S={size}")


def ntt_level(field: Field, x, w, tw=None, w_planes=None, body=None):
    """One radix-S DFT level over axis 1 of x (B, S, C, n16) with the
    (S, S, n16) Montgomery DFT matrix w, then an optional Montgomery
    twiddle: a scalar (n16,) or an (S, C, n16) table wrapping over B.
    CPU: plain version. CUDA: the ntt_level kernel, in the body that
    `ntt_level_body` names for the field and S. The "mma" body reads W as
    its (2 n16, S, S) uint8 byte-plane matrix `w_planes`
    (`dft_byte_planes(w)`, derived here when the caller keeps no table).
    `body` asks for one body by name, for comparing the two on one input:
    "limb" serves every shape, "mma" only its own."""
    _check_limbs(field, x, w)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, C, n16), got {tuple(x.shape)}")
    bsz, size, cols, _ = x.shape
    if tuple(w.shape) != (size, size, field.n16):
        raise ValueError(f"w must be ({size}, {size}, {field.n16}), got {tuple(w.shape)}")
    _check_level_tw(field, x.device, size, cols, tw)
    if x.device.type == "cpu":
        return ntt_level_plain(field, x, w, tw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("ntt_level operands must be contiguous and 16-byte aligned")
    natural = ntt_level_body(field, size)
    if body is None:
        body = natural
    elif body not in NTT_LEVEL_BODIES or (body == "mma" and natural != "mma"):
        raise ValueError(f"body {body!r} does not take n16={field.n16}, S={size}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if body == "mma":
        if w_planes is None:
            w_planes = dft_byte_planes(w)
        if (w_planes.dtype != torch.uint8 or tuple(w_planes.shape) != (2 * field.n16, size, size)
                or w_planes.device != x.device or not w_planes.is_contiguous()
                or w_planes.data_ptr() % 16):
            raise ValueError(f"w_planes must be a contiguous ({2 * field.n16}, {size}, {size}) "
                             "uint8 tensor on the level's device")
        code = _kernels().hodor_ntt_level_mma(
            field.n16, out.data_ptr(), x.data_ptr(), w_planes.data_ptr(), bsz, size, cols,
            *_level_args(field, size, tw), _stream(),
        )
    else:
        code = _kernels().hodor_ntt_level(
            field.n16, out.data_ptr(), x.data_ptr(), w.data_ptr(), bsz, size, cols,
            *_level_args(field, size, tw), _stream(),
        )
    _check(code, f"ntt_level ({body})")
    launch_counts["ntt_level"] += 1
    ntt_level_body_counts[body] += 1
    return out


# ---------------------------------------------------------------- FRI fold

def fri_fold_plain(field: Field, lo, hi, w, c_scaled, inv2):
    """mont(mont(lo - hi, w), c_scaled) + mont(lo + hi, inv2) on the plain
    add, sub and mul: with c_scaled = c/2 and inv2 = 1/2 this is the fold
    ((lo + hi) + c * w * (lo - hi)) / 2. With a lane axis, lo and hi are
    (B, half, n16), w (half, n16) is shared and c_scaled (B, n16) holds one
    challenge per lane."""
    if c_scaled.dim() == 2:
        c_scaled = c_scaled[:, None, :]
    odd = mont_mul_plain(field, mont_mul_plain(field, addsub_plain(field, lo, hi, "sub"), w),
                         c_scaled)
    even = mont_mul_plain(field, addsub_plain(field, lo, hi, "add"), inv2)
    return addsub_plain(field, odd, even, "add")


def _row_stride(t, name: str) -> int:
    """Row stride (int32 units) of a (..., rows, n16) operand the kernels
    read through 16-byte loads."""
    if t.stride(-1) != 1 or t.stride(-2) % 4 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be unit-stride limbs at 16-byte aligned addresses")
    return t.stride(-2)


def _lane_stride(t, lanes, name: str) -> int:
    """Lane stride (int32 units) of a (B, ..., n16) operand; 0 without lanes."""
    if lanes is None:
        return 0
    if t.stride(0) % 4:
        raise ValueError(f"{name}: lanes must lie at 16-byte aligned addresses")
    return t.stride(0)


def fri_fold(field: Field, lo, hi, w, c_scaled, inv2, out=None):
    """One FRI fold round, fused: mont(mont(lo - hi, w), c_scaled) +
    mont(lo + hi, inv2), for one proof or for a batch of them in one
    launch. lo, hi: (half, n16), or (B, half, n16) with one lane per proof;
    row- and lane-strided views allowed (the two halves of the round's
    values are read in place). w: (half, n16), shared by all lanes.
    c_scaled (the round's challenge times 1/2): (n16,), or (B, n16) with a
    lane axis; inv2 (1/2): (n16,). Montgomery limbs on one device. CPU:
    plain version. CUDA: the fri_fold kernel."""
    _check_limbs(field, lo, hi, w, c_scaled, inv2)
    lanes = lo.shape[0] if lo.dim() == 3 else None
    if lo.dim() not in (2, 3) or lo.shape != hi.shape or lo.shape[-2:] != w.shape:
        raise ValueError(f"lo, hi must share one (half, n16) or (B, half, n16) shape and w be "
                         f"(half, n16), got {tuple(lo.shape)}, {tuple(hi.shape)}, "
                         f"{tuple(w.shape)}")
    c_shape = (field.n16,) if lanes is None else (lanes, field.n16)
    if tuple(c_scaled.shape) != c_shape or c_scaled.stride(-1) != 1:
        raise ValueError(f"c_scaled must be unit-stride {c_shape} limbs, got "
                         f"{tuple(c_scaled.shape)}")
    if inv2.dim() != 1 or inv2.stride(0) != 1:
        raise ValueError("inv2 must be a contiguous (n16,) scalar")
    if lo.device.type == "cpu":
        res = fri_fold_plain(field, lo, hi, w, c_scaled, inv2)
        if out is None:
            return res
        out.copy_(res)
        return out
    if lo.device.type != "cuda":
        raise ValueError(f"unsupported device {lo.device}")
    out = _out_tensor(out, lo.shape, lo)
    half = lo.shape[-2]
    if half == 0 or out.numel() == 0:
        return out
    n = field.n16
    if c_scaled.data_ptr() % 16:
        raise ValueError("c_scaled must lie at a 16-byte aligned address")
    code = _kernels().hodor_fri_fold(
        n, out.data_ptr(), half * n, lo.data_ptr(), _row_stride(lo, "lo"),
        _lane_stride(lo, lanes, "lo"), hi.data_ptr(), _row_stride(hi, "hi"),
        _lane_stride(hi, lanes, "hi"), w.data_ptr(), _row_stride(w, "w"), c_scaled.data_ptr(),
        _lane_stride(c_scaled, lanes, "c_scaled"),
        inv2.data_ptr(), half, 1 if lanes is None else lanes, *_field_args(field)[:2], _stream(),
    )
    _check(code, "fri_fold")
    launch_counts["fri_fold"] += 1
    return out


# ------------------------------------------- the two-step and fused levels

def wide_reduce_plain(field: Field, cols, radix: int, tw=None):
    """cols (4 n16 - 1, S, B, C) non-negative int32 base-256 columns of
    t = sum_c cols[c] 256^c < radix * p^2 per element -> (B, S, C, n16):
    t * R^-1 mod p, times the twiddle. In int64, as the JAX package's
    _mont_reduce_wide (hodor_tpu/ntt/matmul.py): the columns fold into
    relaxed 16-bit limbs (even columns, plus the odd columns' low bytes
    shifted up and their high bits carried over), one carry chain, one
    Montgomery reduction, the bound-derived subtract chain."""
    n = field.n16
    if bool((cols < 0).any()):
        raise ValueError("columns must be non-negative (each below 2^31)")
    c64 = cols.permute(2, 1, 3, 0).to(torch.int64)  # (B, S, C, 4n - 1)
    c64 = torch.cat([c64, torch.zeros_like(c64[..., :1])], dim=-1)
    even, odd = c64[..., 0::2], c64[..., 1::2]
    odd_hi = torch.cat([torch.zeros_like(odd[..., :1]), odd[..., :-1] >> 8], dim=-1)
    relaxed = even + ((odd & 0xFF) << 8) + odd_hi
    u = _reduce_wide_plain(field, _carry(relaxed, 2 * n + 1), radix)
    if tw is not None:
        u = mont_mul_plain(field, u, tw)
    return u


def _check_columns(field: Field, cols) -> None:
    if cols.dtype != torch.int32 or cols.dim() != 4 or cols.shape[0] != 4 * field.n16 - 1:
        raise ValueError(f"cols must be ({4 * field.n16 - 1}, S, B, C) int32, got "
                         f"{tuple(cols.shape)} {cols.dtype}")


def wide_reduce(field: Field, cols, radix: int, tw=None, out=None):
    """The reduce half of the two-step NTT level. cols: (4 n16 - 1, S, B,
    C) int32 base-256 columns, each in [0, 2^31), of the per-element
    integer t = sum_c cols[c] 256^c < radix * p^2. The layout is
    plane-major: plane c is the row-major (S, B * C) matrix that one int8
    product `W2 (planes * S, depth) @ X (depth, B * C)` writes, so no
    transpose stands between the product and this reduce. Returns
    (B, S, C, n16): t * R^-1 mod p, times the optional Montgomery twiddle
    ((n16,) scalar, or an (S, C, n16) table that wraps over B), in the
    level's own layout. CPU: plain version. CUDA: the wide_reduce kernel."""
    _check_columns(field, cols)
    _, size, bsz, ccols = cols.shape
    _check_level_tw(field, cols.device, size, ccols, tw)
    shape = (bsz, size, ccols, field.n16)
    if cols.device.type == "cpu":
        res = wide_reduce_plain(field, cols, radix, tw)
        if out is None:
            return res
        out.copy_(res)
        return out
    if cols.device.type != "cuda":
        raise ValueError(f"unsupported device {cols.device}")
    if not cols.is_contiguous():
        raise ValueError("cols must be contiguous")
    out = _out_tensor(out, shape, cols)
    if out.numel() == 0:
        return out
    code = _kernels().hodor_wide_reduce(
        field.n16, out.data_ptr(), cols.data_ptr(), bsz, size, ccols,
        *_level_args(field, radix, tw), _stream(),
    )
    _check(code, "wide_reduce")
    launch_counts["wide_reduce"] += 1
    return out


def s8dot_plain(a, b):
    """(M, K) int8 . (K, N) int8 -> (M, N) int32, exact: the products sum
    in float64 (exact below 2^53; a depth-K sum stays below K * 2^14)."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def s8dot(a, b):
    """Exact int8 product (M, K) . (K, N) -> (M, N) int32: the contraction
    stage of dft_reduce alone. CPU: plain version. CUDA: the s8dot entry of
    the dft_reduce kernel (its tensor-core tile code, both operands
    streamed)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) and (K, N) int8, got {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} vs {b.device}")
    if a.device.type == "cpu":
        return s8dot_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("s8dot operands must be contiguous")
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.int32, device=a.device)
    if out.numel() == 0 or a.shape[1] == 0:
        return out.zero_()
    code = _kernels().hodor_s8dot(out.data_ptr(), a.data_ptr(), b.data_ptr(), a.shape[0],
                                  a.shape[1], b.shape[1], _stream())
    _check(code, "s8dot")
    launch_counts["dft_reduce"] += 1
    return out


def _check_dft_operands(field: Field, w_s8, w_sum, x_s8, radix: int):
    planes, depth = 4 * field.n16 - 1, radix * 2 * field.n16
    if w_s8.dtype != torch.int8 or tuple(w_s8.shape) != (planes, radix, depth):
        raise ValueError(f"w_s8 must be ({planes}, {radix}, {depth}) int8, got "
                         f"{tuple(w_s8.shape)} {w_s8.dtype}")
    if w_sum.dtype != torch.int32 or tuple(w_sum.shape) != (planes, radix):
        raise ValueError(f"w_sum must be ({planes}, {radix}) int32, got "
                         f"{tuple(w_sum.shape)} {w_sum.dtype}")
    if x_s8.dtype != torch.int8 or x_s8.dim() != 3 or x_s8.shape[2] != depth:
        raise ValueError(f"x_s8 must be (B, C, {depth}) int8, got {tuple(x_s8.shape)} "
                         f"{x_s8.dtype}")
    if not (w_s8.device == w_sum.device == x_s8.device):
        raise ValueError("dft_reduce operands on different devices")


def dft_columns_plain(w_s8, w_sum, x_s8):
    """The exact base-256 columns of the byte-plane DFT from its -128
    offset operands: (planes, S, B, C) int32,
      cols[c, k, b, m] = sum_d (w_s8[c, k, d] + 128) (x_s8[b, m, d] + 128)
                       = dot + 128 sx[b, m] + 128 w_sum[c, k] - 128^2 depth
    with sx the sum of the unshifted x bytes."""
    planes, size, depth = w_s8.shape
    bsz, ccols, _ = x_s8.shape
    dot = s8dot_plain(w_s8.reshape(planes * size, depth), x_s8.reshape(bsz * ccols, depth).t())
    sx = x_s8.sum(dim=-1, dtype=torch.int32) + 128 * depth  # (B, C)
    cols = dot.reshape(planes, size, bsz, ccols)
    return cols + 128 * sx[None, None] + (128 * w_sum - 128 * 128 * depth)[:, :, None, None]


def dft_reduce_plain(field: Field, w_s8, w_sum, x_s8, radix: int, tw=None):
    return wide_reduce_plain(field, dft_columns_plain(w_s8, w_sum, x_s8), radix, tw)


def dft_reduce_carry_plain(field: Field, w_s8, w_sum, x_s8, radix: int, tw=None):
    """The arithmetic of both dft_reduce bodies in torch ops, where it
    differs in order from `dft_reduce_plain`: the exact columns are walked
    in order with a running carry that gives one byte of t a column (the
    carry left after the last column is the top byte), and the bytes go
    as 16-bit limbs into the same reduction, chain and twiddle. No fold
    into relaxed limbs."""
    cols = dft_columns_plain(w_s8, w_sum, x_s8).permute(2, 1, 3, 0).to(torch.int64)
    run = torch.zeros(cols.shape[:-1], dtype=torch.int64, device=cols.device)
    t_bytes = []
    for c in range(cols.shape[-1]):
        run = run + cols[..., c]
        t_bytes.append(run & 0xFF)
        run = run >> 8
    t_bytes.append(run)  # t < radix p^2 < 256^(4 n16)
    t8 = torch.stack(t_bytes, dim=-1)  # (B, S, C, 4 n16)
    t16 = t8[..., 0::2] | (t8[..., 1::2] << 8)
    t16 = torch.cat([t16, torch.zeros_like(t16[..., :1])], dim=-1)
    u = _reduce_wide_plain(field, t16, radix)
    if tw is not None:
        u = mont_mul_plain(field, u, tw)
    return u


def dft_reduce_body(field: Field, radix: int) -> str:
    """Which body of the dft_reduce kernel a level takes, from the field
    and the radix alone: "mma" (s8 products on the int8 tensor cores) for
    a 16-limb field at S = 32, 64 or 128, whose folded depth S * 32 fills
    the 256-byte stages of the W ring; "dp4a" (the integer pipe) for every
    other S <= 128, which is the 4-limb fields and the small radices.
    Raises where neither applies."""
    if field.n16 == 16 and radix in MMA_RADICES:
        return "mma"
    if field.n16 in (4, 16) and 1 <= radix <= 128:
        return "dp4a"
    raise ValueError(f"dft_reduce takes n16 of 4 or 16 and S <= 128, got n16={field.n16}, "
                     f"S={radix}")


def dft_reduce(field: Field, w_s8, w_sum, x_s8, radix: int, tw=None, body=None):
    """The fused NTT level on int8 byte planes: the size-`radix` DFT as an
    int8 contraction per base-256 column, the -128 offset corrections, the
    wide Montgomery reduction and the twiddle in one kernel; the columns
    never reach device memory.

    w_s8 (4 n16 - 1, S, S * P) int8 and w_sum (4 n16 - 1, S) int32: the
    folded byte-plane DFT matrix and its row sums (ntt/matmul.py
    folded_dft_matrix), P = 2 n16, or any int8 W with the sums of its
    bytes plus 128; x_s8 (B, C, S * P) int8: the bytes of x[b, j, c] minus
    128, depth index j * P + q contiguous; tw as for ntt_level. Returns
    (B, S, C, n16). CPU: plain version. CUDA: the dft_reduce kernel, in
    the body that `dft_reduce_body` names for the field and S. `body` asks
    for one body by name, for comparing the two on one input: "dp4a"
    serves every shape, "mma" only its own."""
    _check_dft_operands(field, w_s8, w_sum, x_s8, radix)
    bsz, ccols, _ = x_s8.shape
    _check_level_tw(field, x_s8.device, radix, ccols, tw)
    if x_s8.device.type == "cpu":
        return dft_reduce_plain(field, w_s8, w_sum, x_s8, radix, tw)
    if x_s8.device.type != "cuda":
        raise ValueError(f"unsupported device {x_s8.device}")
    if not (w_s8.is_contiguous() and w_sum.is_contiguous() and x_s8.is_contiguous()):
        raise ValueError("dft_reduce operands must be contiguous")
    natural = dft_reduce_body(field, radix)
    if body is None:
        body = natural
    elif body not in DFT_REDUCE_BODIES or (body == "mma" and natural != "mma"):
        raise ValueError(f"body {body!r} does not take n16={field.n16}, S={radix}")
    if body == "mma" and (w_s8.data_ptr() % 16 or x_s8.data_ptr() % 16):
        raise ValueError("dft_reduce operands must be 16-byte aligned")
    out = torch.empty((bsz, radix, ccols, field.n16), dtype=torch.int32, device=x_s8.device)
    if out.numel() == 0:
        return out
    launch = _kernels().hodor_dft_reduce_mma if body == "mma" else _kernels().hodor_dft_reduce
    code = launch(
        field.n16, out.data_ptr(), w_s8.data_ptr(), w_sum.data_ptr(), x_s8.data_ptr(), bsz,
        radix, ccols, *_level_args(field, radix, tw), _stream(),
    )
    _check(code, f"dft_reduce ({body})")
    launch_counts["dft_reduce"] += 1
    dft_reduce_body_counts[body] += 1
    return out
