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
as mont_mul's. `ntt_level` has three bodies in ntt_level.cu: radix-2
butterflies on canonical values in registers ("butterfly") for S = 2, 4,
8, and the limb arithmetic on the integer pipe ("limb") for the rest,
which `ntt_level` picks from the radix (`ntt_level_body`); and radix-2
stages in shared memory ("shared", S = 2 to 2^12 at 16 limbs, entry
`ntt_level_shared`), which reads roots of unity instead of a DFT matrix
and writes at any strides: the passes of ntt/matmul.py's shared plan,
which carry every 16-limb transform of 2^8 to 2^24 points.
`ntt_level_body_counts` counts each beside their sum in `launch_counts`.
`mont_mul` and `addsub` have three bodies each, picked from the collapsed
layout by one rule ("flat", "grid", "general"; `mont_mul_body`,
`addsub_body`), counted in `mont_mul_body_counts` and
`addsub_body_counts`. The three elementwise wrappers (`mont_mul`,
`addsub`, `fri_fold`) keep the launch arguments of every operand layout
they have seen, so a repeated layout costs no broadcast or collapse.
`fri_fold` makes its round's challenge from the previous tree's root
digest and its twiddles from two tables of about sqrt(N) entries on the
card, so a FRI round asks nothing of the host but its launch; it takes
an optional leading lane axis, one proof of a batch a lane with its own
root, all lanes in one launch.

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
from typing import NamedTuple, Optional, Sequence, Tuple

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
NTT_LEVEL_BODIES = ("butterfly", "limb", "shared")
ntt_level_body_counts = {body: 0 for body in NTT_LEVEL_BODIES}
DFT_REDUCE_BODIES = ("mma", "dp4a")
dft_reduce_body_counts = {body: 0 for body in DFT_REDUCE_BODIES}
MONT_MUL_BODIES = ("flat", "grid", "general")
mont_mul_body_counts = {body: 0 for body in MONT_MUL_BODIES}
ADDSUB_BODIES = MONT_MUL_BODIES
addsub_body_counts = {body: 0 for body in ADDSUB_BODIES}


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    for body in NTT_LEVEL_BODIES:
        ntt_level_body_counts[body] = 0
    for body in DFT_REDUCE_BODIES:
        dft_reduce_body_counts[body] = 0
    for body in MONT_MUL_BODIES:
        mont_mul_body_counts[body] = 0
    for body in ADDSUB_BODIES:
        addsub_body_counts[body] = 0


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
    lib.hodor_ntt_level_butterfly.argtypes = [i32, vp, vp, vp, i64, i32, i64, i32, vp, vp, u32,
                                              vp]
    lib.hodor_ntt_level_pass.argtypes = [i32, vp, vp, vp, i64, i32, i64, vp, i32, vp, vp, i32, vp,
                                         u32, u32, vp]
    lib.hodor_fri_fold.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, vp, u32, vp,
                                   vp, u32, vp]
    lib.hodor_wide_reduce.argtypes = [i32, vp, vp, i64, i32, i64, i32, vp, vp, u32, vp, i32, vp]
    lib.hodor_dft_reduce.argtypes = [i32, vp, vp, vp, vp, i64, i32, i64, i32, vp, vp, u32, vp,
                                     i32, vp]
    lib.hodor_dft_reduce_mma.argtypes = lib.hodor_dft_reduce.argtypes
    lib.hodor_s8dot.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    for fn in (lib.hodor_mont_mul, lib.hodor_mont_pow, lib.hodor_addsub, lib.hodor_blake2s,
               lib.hodor_ntt_level, lib.hodor_ntt_level_butterfly,
               lib.hodor_ntt_level_pass, lib.hodor_fri_fold,
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


def _stream() -> int:
    """The current device's current stream as an integer, the value of
    torch.cuda.current_stream().cuda_stream (every entry binds it as
    void *), read without making a Stream object."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


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
    dev, n16 = tensors[0].device, field.n16
    for t in tensors:
        if t.dtype is not torch.int32:
            raise TypeError(f"limb tensors must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.dim() < 1 or t.shape[-1] != n16:
            raise ValueError(f"last dim must be n16={n16}, got shape {tuple(t.shape)}")


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
        if like.shape == shape and like.dtype is torch.int32:
            # less host time than torch.empty: no device argument to parse
            return torch.empty_like(like, memory_format=torch.contiguous_format)
        return torch.empty(shape, dtype=torch.int32, device=like.device)
    if tuple(out.shape) != tuple(shape) or not out.is_contiguous() or out.dtype != torch.int32:
        raise ValueError("out must be a contiguous int32 tensor of the broadcast shape")
    return out


def _elementwise_body(dims) -> str:
    """The body of mont_mul.cu and addsub.cu that collapsed dims take, as
    both launchers pick it: "flat" (one element dim), "grid" (outer two
    dims on the grid, inner at least a warp wide) or "general"
    (element_at division)."""
    if dims[0] == 1 and dims[1] == 1:
        return "flat"
    if dims[0] <= 65535 and dims[1] <= 65535 and dims[2] >= 32:
        return "grid"
    return "general"


def mont_mul_body(a, b) -> str:
    """The body of mont_mul.cu that a product of a and b launches."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return _elementwise_body(_launch_geometry(a, b, shape)[2])


def addsub_body(a, b) -> str:
    """The body of addsub.cu that a sum or difference of a and b launches
    (the rule of `mont_mul_body`)."""
    return mont_mul_body(a, b)


class _ElementwiseLaunch(NamedTuple):
    """What an elementwise launch passes for one pair of operand layouts:
    the output's shape, whether the operands are first copied to a
    contiguous broadcast (a layout that collapses to no three dims), the
    strides and dims as ctypes arrays (None for an empty output) and the
    body the launcher picks."""
    shape: torch.Size
    copy: bool
    a_strides: Optional[ctypes.Array]
    b_strides: Optional[ctypes.Array]
    dims: Optional[ctypes.Array]
    body: Optional[str]


# Launch arguments by operand layout. A layout's first call checks its
# operands and works the arguments out (_check_limbs,
# torch.broadcast_shapes and _launch_geometry, most of a call's host time
# before this cache: PERF.md); later calls read them here. The key holds
# every operand's shape, strides, dtype and device and the field's width,
# so a layout found here passed the checks when it was entered. A cache
# that reaches _LAUNCH_CACHE_MAX layouts starts again empty. The base
# pointers' alignment is checked on every call.
_LAUNCH_CACHE_MAX = 4096
_elementwise_launches = {}
_fold_launches = {}


def _remember(cache, key, value):
    if len(cache) >= _LAUNCH_CACHE_MAX:
        cache.clear()
    cache[key] = value
    return value


def _elementwise_launch(field: Field, a, b):
    """(launch arguments, a, b) of an elementwise kernel over limbs a and
    b, from the cache of layouts; a and b come back copied where the
    layout asks for it. Raises as `_check_limbs` and `_launch_geometry`
    do."""
    key = (field.n16, a.shape, a.stride(), a.dtype, a.device, b.shape, b.stride(), b.dtype,
           b.device)
    launch = _elementwise_launches.get(key)
    if launch is None:
        _check_limbs(field, a, b)
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if 0 in shape:
            return _ElementwiseLaunch(shape, False, None, None, None, None), a, b
        a2, b2, dims, a_st, b_st = _launch_geometry(a, b, shape)
        launch = _remember(_elementwise_launches, key, _ElementwiseLaunch(
            shape, a2 is not a, _i64_array(a_st), _i64_array(b_st), _i64_array(dims),
            _elementwise_body(dims)))
        return launch, a2, b2
    if launch.copy:
        a, b = (t.expand(launch.shape).contiguous() for t in (a, b))
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("limb elements must lie at 16-byte aligned addresses")
    return launch, a, b


def mont_mul(field: Field, a, b, out=None):
    """Elementwise Montgomery product a*b*R^-1 mod p of (..., n16) limbs
    (broadcasting). CPU: plain version. CUDA: the mont_mul kernel."""
    if a.is_cuda:
        launch, a, b = _elementwise_launch(field, a, b)
        out = _out_tensor(out, launch.shape, a)
        if out.numel() == 0:
            return out
        p_words, pinv0, _ = _field_args(field)
        code = _kernels().hodor_mont_mul(
            field.n16, out.data_ptr(), a.data_ptr(), launch.a_strides, b.data_ptr(),
            launch.b_strides, launch.dims, p_words, pinv0, _stream(),
        )
        _check(code, "mont_mul")
        launch_counts["mont_mul"] += 1
        mont_mul_body_counts[launch.body] += 1
        return out
    _check_limbs(field, a, b)
    if not a.is_cpu:
        raise ValueError(f"unsupported device {a.device}")
    res = mont_mul_plain(field, a, b)
    if out is None:
        return res
    out.copy_(res)
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
    if a.is_cuda:
        launch, a, b = _elementwise_launch(field, a, b)
        out = _out_tensor(out, launch.shape, a)
        if out.numel() == 0:
            return out
        code = _kernels().hodor_addsub(
            field.n16, 0 if mode == "add" else 1, out.data_ptr(), a.data_ptr(),
            launch.a_strides, b.data_ptr(), launch.b_strides, launch.dims,
            _field_args(field)[0], _stream(),
        )
        _check(code, "addsub")
        launch_counts["addsub"] += 1
        addsub_body_counts[launch.body] += 1
        return out
    _check_limbs(field, a, b)
    if not a.is_cpu:
        raise ValueError(f"unsupported device {a.device}")
    res = addsub_plain(field, a, b, mode)
    if out is None:
        return res
    out.copy_(res)
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


def ntt_level_butterfly_plain(field: Field, x, w, tw=None):
    """The arithmetic of ntt_level's butterfly body in torch ops: log2 S
    radix-2 decimation-in-frequency stages over axis 1 of x (B, S, C, n16)
    on canonical values, a pair (a, b) at distance h becoming (a + b,
    (a - b) w^e) with w^e = w[1, e] (no product at e = 0), the outputs read
    from their bit-reversed places, then the twiddle as in
    ntt_level_plain. Reads row 1 of w alone, so it equals ntt_level_plain
    only where w is a DFT matrix (w[k, j] = w[1, 1]^(kj)), as dft_matrix
    builds it."""
    size = x.shape[1]
    if size & (size - 1):
        raise ValueError(f"the butterfly body takes a power-of-two S, got {size}")
    out = _dif_plain(field, x, w[1, :size // 2])
    if tw is not None:
        out = mont_mul_plain(field, out, tw)
    return out


def _dif_plain(field: Field, x, roots):
    """log2 S radix-2 decimation-in-frequency stages over axis 1 of x
    (B, S, C, n16) on canonical values, a pair (a, b) at distance h
    becoming (a + b, (a - b) w^e), w^e = roots[e] (roots: (S/2, n16) limbs
    of w^e for the level's S-point root w; no product at e = 0); the
    outputs read back from their bit-reversed places, natural order."""
    bsz, size, cols, n = x.shape
    v = x
    h = size // 2
    while h >= 1:
        pairs = v.reshape(bsz, size // (2 * h), 2, h, cols, n)
        a, b = pairs[:, :, 0], pairs[:, :, 1]
        dif = addsub_plain(field, a, b, "sub")
        if h > 1:
            step = roots[0:size // 2:size // (2 * h)][1:, None, :]  # w^e for i = 1 .. h - 1
            dif = torch.cat([dif[:, :, :1], mont_mul_plain(field, dif[:, :, 1:], step)], dim=2)
        v = torch.stack([addsub_plain(field, a, b, "add"), dif], dim=2).reshape(x.shape)
        h //= 2
    bits = size.bit_length() - 1
    order = [int(format(k, f"0{bits}b")[::-1], 2) if bits else 0 for k in range(size)]
    return v[:, order]


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


BUTTERFLY_RADICES = (2, 4, 8)


def ntt_level_body(field: Field, size: int) -> str:
    """Which body of the ntt_level kernel a level takes, from the radix
    alone: "butterfly" (radix-2 stages in registers) at S = 2, 4, 8,
    which is every level of a field of max_radix 4 and the small terminal
    radices; "limb" (the integer pipe) for every other S <= 128. Raises
    where none applies (a field of neither 4 nor 16 limbs, S above 128)."""
    if field.n16 not in (4, 16) or not 1 <= size <= 128:
        raise ValueError(f"ntt_level takes n16 of 4 or 16 and S <= 128, got n16={field.n16}, "
                         f"S={size}")
    if size in BUTTERFLY_RADICES:
        return "butterfly"
    return "limb"


def ntt_level(field: Field, x, w, tw=None, body=None):
    """One radix-S DFT level over axis 1 of x (B, S, C, n16) with the
    (S, S, n16) Montgomery DFT matrix w, then an optional Montgomery
    twiddle: a scalar (n16,) or an (S, C, n16) table wrapping over B.
    w must be `ntt/matmul.py dft_matrix(ops, S, inverse)` on either
    device: the "butterfly" body is given only its row 1, the roots
    w[1, e] = w[1, 1]^e, so on the card at its radices the result is the
    level for a DFT matrix whatever else w holds (the plain version on the
    CPU multiplies by w as given). CPU: plain version. CUDA: the ntt_level
    kernel, in the body that `ntt_level_body` names for S. `body` asks
    for one body by name, for comparing them on one input: "limb" serves
    every shape, "butterfly" only its own radices."""
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
    elif body not in (natural, "limb"):
        raise ValueError(f"body {body!r} does not take n16={field.n16}, S={size}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if body == "butterfly":
        roots = w[1]
        if roots.data_ptr() % 16:
            raise ValueError("w must lie at a 16-byte aligned address")
        tw_mode, tw_ptr, p_words, pinv0, _, _ = _level_args(field, size, tw)
        code = _kernels().hodor_ntt_level_butterfly(
            field.n16, out.data_ptr(), x.data_ptr(), roots.data_ptr(), bsz, size, cols, tw_mode,
            tw_ptr, p_words, pinv0, _stream(),
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


# ------------------------------------------------ NTT level, shared body

# the longest DFT one pass of the shared body computes: 2^11 points of a
# column in shared memory, the first stage split over two blocks above that
SHARED_MAX_LOG = 12


class PowerTwiddle(NamedTuple):
    """The four-step twiddle w_N^(k c) of output k of column c as two small
    tables: lo[kc mod 2^shift] * hi[kc >> shift], packed words
    (`pack_words`), lo of 2^shift entries, hi of N >> shift."""
    lo: torch.Tensor
    hi: torch.Tensor
    shift: int


def pack_words(limbs):
    """(..., n16) int32 16-bit limbs -> (..., n16 / 2) int32 words (the
    u32 bit patterns), the layout the shared body reads its tables in."""
    return (limbs[..., 0::2] & 0xFFFF) | (limbs[..., 1::2] << 16)


def unpack_words(words):
    """pack_words' inverse."""
    return torch.stack([words & 0xFFFF, (words >> 16) & 0xFFFF], dim=-1).reshape(
        words.shape[:-1] + (2 * words.shape[-1],))


@lru_cache(maxsize=None)
def _zero_words(field: Field) -> int:
    """Bit j set where word j of p is 0: the words whose products the
    kernels' Montgomery reduction may skip."""
    return sum(1 << j for j, word in enumerate(_words(field.p, field.n16 // 2)) if word == 0)


def power_twiddle_plain(field: Field, tw: PowerTwiddle, size: int, cols: int):
    """(S, C, n16) limbs of w_N^(k c) from the two tables."""
    kc = torch.outer(torch.arange(size), torch.arange(cols)).to(tw.lo.device)
    lo = unpack_words(tw.lo)[kc & ((1 << tw.shift) - 1)]
    hi = unpack_words(tw.hi)[kc >> tw.shift]
    return mont_mul_plain(field, lo, hi)


def ntt_level_shared_plain(field: Field, x, roots, tw=None):
    """The arithmetic of ntt_level's shared body in torch ops: x (B, S, C,
    n16), S a power of two, roots the (S/2, n16 / 2) packed words of w^e
    for the level's S-point root w (`pack_words`); log2 S radix-2
    decimation-in-frequency stages on canonical values (as
    ntt_level_butterfly_plain, O(log S) products an output), natural order
    out, then the twiddle: None, an (n16,) scalar or a PowerTwiddle."""
    size, cols = x.shape[1], x.shape[2]
    out = _dif_plain(field, x, unpack_words(roots))
    if isinstance(tw, PowerTwiddle):
        out = mont_mul_plain(field, out, power_twiddle_plain(field, tw, size, cols))
    elif tw is not None:
        out = mont_mul_plain(field, out, tw)
    return out


def _check_pass_view(t, name: str) -> None:
    if t.stride(-1) != 1 or any(st % 4 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} must hold each element's limbs contiguous, at strides of "
                         "16 bytes and a 16-byte aligned address")


def ntt_level_shared(field: Field, x, roots, tw=None, out=None):
    """One DFT level over axis 1 of x (B, S, C, n16), S = 2^1 .. 2^12, in
    the shared body of ntt_level: radix-2 stages in shared memory, roots
    read from `roots` ((S/2, n16 / 2) packed words of w^e, w the S-point
    root), written in natural order into `out` (a (B, S, C, n16) view, at
    any strides of whole elements; a new tensor if None; never x). tw:
    None, an (n16,) scalar or a PowerTwiddle (the four-step's w_N^(k c)).
    x may be any such view too. CPU: the plain version. CUDA: the kernel,
    n16 = 16 only. Counts in launch_counts["ntt_level"] and
    ntt_level_body_counts["shared"]."""
    _check_limbs(field, x)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, C, n16), got {tuple(x.shape)}")
    bsz, size, cols, _ = x.shape
    log_size = size.bit_length() - 1
    if size != 1 << log_size or not 1 <= log_size <= SHARED_MAX_LOG:
        raise ValueError(f"the shared body takes S = 2 .. 2^{SHARED_MAX_LOG}, got {size}")
    nw = field.n16 // 2
    if (roots.dtype != torch.int32 or tuple(roots.shape) != (size // 2, nw)
            or roots.device != x.device):
        raise ValueError(f"roots must be ({size // 2}, {nw}) int32 words on {x.device}")
    if isinstance(tw, PowerTwiddle):
        if (tw.lo.shape != (1 << tw.shift, nw) or tw.hi.dim() != 2 or tw.hi.shape[1] != nw
                or tw.hi.shape[0] << tw.shift < (size - 1) * (cols - 1) + 1
                or tw.lo.device != x.device or tw.hi.device != x.device):
            raise ValueError(f"the power twiddle's tables do not cover S={size}, C={cols}")
    elif tw is not None:
        _check_limbs(field, tw)
        if tuple(tw.shape) != (field.n16,) or tw.device != x.device:
            raise ValueError(f"tw must be an (n16,) scalar on {x.device}, got {tuple(tw.shape)}")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    elif out.shape != x.shape or out.dtype != torch.int32 or out.device != x.device:
        raise ValueError(f"out must be an int32 {tuple(x.shape)} view on {x.device}")
    if x.device.type == "cpu":
        return out.copy_(ntt_level_shared_plain(field, x, roots, tw))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if field.n16 != 16:
        raise ValueError(f"the shared body takes n16 = 16, got {field.n16}")
    _check_pass_view(x, "x")
    _check_pass_view(out, "out")
    for table in (roots,) + ((tw.lo, tw.hi) if isinstance(tw, PowerTwiddle) else ()):
        if not table.is_contiguous() or table.data_ptr() % 16:
            raise ValueError("the shared body's tables must be contiguous and 16-byte aligned")
    if out.numel() == 0:
        return out
    if isinstance(tw, PowerTwiddle):
        tw_mode, tw_ptr, hi_ptr, shift = 3, tw.lo.data_ptr(), tw.hi.data_ptr(), tw.shift
    else:
        tw_mode, tw_ptr = (0, None) if tw is None else (1, tw.data_ptr())
        hi_ptr, shift = None, 0
    p_words, pinv0, _ = _field_args(field)
    strides = _i64_array([x.stride(0), x.stride(2), x.stride(1),
                          out.stride(0), out.stride(2), out.stride(1)])
    code = _kernels().hodor_ntt_level_pass(
        field.n16, out.data_ptr(), x.data_ptr(), roots.data_ptr(), bsz, log_size, cols, strides,
        tw_mode, tw_ptr, hi_ptr, shift, p_words, pinv0, _zero_words(field), _stream(),
    )
    _check(code, "ntt_level (shared)")
    launch_counts["ntt_level"] += 1
    ntt_level_body_counts["shared"] += 1
    return out


# ---------------------------------------------------------------- FRI fold

def fri_fold_plain(field: Field, lo, hi, w, c_scaled, inv2):
    """mont(mont(lo - hi, w), c_scaled) + mont(lo + hi, inv2) on the plain
    add, sub and mul: with c_scaled = c/2 and inv2 = 1/2 this is the fold
    ((lo + hi) + c * w * (lo - hi)) / 2 for explicit twiddles w. With a
    lane axis, lo and hi are (B, half, n16), w (half, n16) is shared and
    c_scaled (B, n16) holds one challenge per lane."""
    if c_scaled.dim() == 2:
        c_scaled = c_scaled[:, None, :]
    odd = mont_mul_plain(field, mont_mul_plain(field, addsub_plain(field, lo, hi, "sub"), w),
                         c_scaled)
    even = mont_mul_plain(field, addsub_plain(field, lo, hi, "add"), inv2)
    return addsub_plain(field, odd, even, "add")


@lru_cache(maxsize=None)
def _shave_mask(field: Field) -> int:
    """The mask Field.from_be_with_shave puts on the repr_size bytes it
    reads: every bit but the top u64 limb's shaved ones."""
    top = 64 * (field.n64 - 1)
    return ((1 << top) - 1) | ((0xFFFFFFFFFFFFFFFF >> ((256 - field.capacity) % 64)) << top)


@lru_cache(maxsize=None)
def _fold_field_args(field: Field):
    """What a fold launch passes beside `_field_args`: R^2 mod p and the
    challenge's shave mask as ctypes words, and the words of p that are 0."""
    nw = field.n16 // 2
    return (_u32_array(_words(field.R2_mod_p, nw)), _u32_array(_words(_shave_mask(field), nw)),
            _zero_words(field))


def fold_challenge_plain(field: Field, roots):
    """(..., 8) int32 root digests -> (..., n16) Montgomery limbs of the
    challenge each draws, as the fri_fold kernel derives it: canonical
    word i is digest word n16/2 - 1 - i byte-swapped (repr_size bytes read
    big-endian), shaved, times R^2. Field.from_be_with_shave of the
    root's bytes."""
    nw, n16 = field.n16 // 2, field.n16
    d = roots[..., :nw].flip(-1).to(torch.int64) & 0xFFFFFFFF
    x = (((d & 0xFF) << 24) | (((d >> 8) & 0xFF) << 16) | (((d >> 16) & 0xFF) << 8)
         | ((d >> 24) & 0xFF))
    x = x & torch.as_tensor(_words(_shave_mask(field), nw), dtype=torch.int64, device=d.device)
    limbs = torch.stack([x & 0xFFFF, x >> 16], dim=-1).reshape(roots.shape[:-1] + (n16,))
    r2 = torch.as_tensor(_int_limbs(field.R2_mod_p, n16), device=d.device)
    return mont_mul_plain(field, limbs, r2)


def _fold_log_n(tw: PowerTwiddle) -> int:
    """log2 N of the N-point domain whose inverse-root tables tw holds."""
    return (tw.hi.shape[0] << tw.shift).bit_length() - 1


def fold_twiddles_plain(field: Field, tw: PowerTwiddle, half: int, stride: int, first: int = 0):
    """(half, n16) limbs of W^(-e), e = ((first + j) stride) mod N for
    j < half, as the fri_fold kernel makes them: tw.lo[e mod 2^shift]
    times tw.hi[e >> shift]."""
    n = 1 << _fold_log_n(tw)
    j = torch.arange(half, dtype=torch.int64, device=tw.lo.device)
    e = ((first + j) % (n // stride)) * stride
    return mont_mul_plain(field, unpack_words(tw.lo)[e & ((1 << tw.shift) - 1)],
                          unpack_words(tw.hi)[e >> tw.shift])


def fri_fold_round_plain(field: Field, lo, hi, roots, tw: PowerTwiddle, stride: int,
                         first: int = 0):
    """The fri_fold kernel's function in torch ops: the challenge from the
    roots (`fold_challenge_plain`), the twiddles from the tables
    (`fold_twiddles_plain`), then `fri_fold_plain` with 1/2 as a product.
    Every product is canonical and the kernel's halving exact, so its
    association and its halving give the same limbs."""
    inv2 = torch.as_tensor(_int_limbs(field.to_mont(field.inv(2)), field.n16), device=lo.device)
    c_scaled = mont_mul_plain(field, fold_challenge_plain(field, roots), inv2)
    w = fold_twiddles_plain(field, tw, lo.shape[-2], stride, first)
    return fri_fold_plain(field, lo, hi, w, c_scaled, inv2)


def _row_stride(t, name: str) -> int:
    """Row stride (int32 units) of a (..., rows, n16) operand the kernels
    read through 16-byte loads (the layout; the base is checked per call)."""
    if t.stride(-1) != 1 or t.stride(-2) % 4:
        raise ValueError(f"{name}: rows must be unit-stride limbs at 16-byte aligned addresses")
    return t.stride(-2)


def _lane_stride(t, lanes, name: str) -> int:
    """Lane stride (int32 units) of a (B, ..., n16) operand; 0 without lanes."""
    if lanes is None:
        return 0
    if t.stride(0) % 4:
        raise ValueError(f"{name}: lanes must lie at 16-byte aligned addresses")
    return t.stride(0)


def _check_fold_operands(field: Field, lo, hi, roots, tw: PowerTwiddle):
    _check_limbs(field, lo, hi)
    if lo.dim() not in (2, 3) or lo.shape != hi.shape:
        raise ValueError(f"lo, hi must share one (half, n16) or (B, half, n16) shape, got "
                         f"{tuple(lo.shape)}, {tuple(hi.shape)}")
    r_shape = (8,) if lo.dim() == 2 else (lo.shape[0], 8)
    if (roots.dtype != torch.int32 or tuple(roots.shape) != r_shape or roots.stride(-1) != 1
            or roots.device != lo.device):
        raise ValueError(f"roots must be unit-stride {r_shape} int32 digest words on "
                         f"{lo.device}, got {tuple(roots.shape)} {roots.dtype}")
    nw = field.n16 // 2
    for t in (tw.lo, tw.hi):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != nw or not t.is_contiguous()
                or t.device != lo.device):
            raise ValueError(f"the fold's tables must be contiguous (entries, {nw}) int32 words "
                             f"on {lo.device}")
    m = tw.hi.shape[0]
    if tw.lo.shape[0] != 1 << tw.shift or m & (m - 1):
        raise ValueError("the fold's tables must hold 2^shift and a power of two entries")


def _fold_strides(field: Field, lo, hi, roots):
    """The geometry hodor_fri_fold reads, in int32 units: (out lane
    stride, lo row and lane strides, hi row and lane strides, the roots'
    lane stride, half, lanes)."""
    lanes = lo.shape[0] if lo.dim() == 3 else None
    half = lo.shape[-2]
    return (half * field.n16, _row_stride(lo, "lo"), _lane_stride(lo, lanes, "lo"),
            _row_stride(hi, "hi"), _lane_stride(hi, lanes, "hi"),
            0 if lanes is None else roots.stride(0), half, 1 if lanes is None else lanes)


def fri_fold(field: Field, lo, hi, roots, tw: PowerTwiddle, stride: int, first: int = 0,
             out=None):
    """One FRI fold round whose challenge and twiddles are made where it
    runs: output row j folds lo[j] and hi[j] (rows first + j and
    first + j + K/2 of the round's K values) into ((lo + hi) + c W^(-e)
    (lo - hi)) / 2, e = ((first + j) stride) mod N, for one proof or for a
    batch of them in one launch.

    lo, hi: (half, n16), or (B, half, n16) with one lane per proof; row-
    and lane-strided views allowed (the two halves of the round's values
    are read in place). roots: the previous tree's root digest, (8,) int32
    words, or (B, 8) one per lane; c is the challenge it draws
    (Field.from_be_with_shave of its bytes). tw: the l0 domain's
    inverse-root tables, W^-1 over N = len(tw.hi) << tw.shift points
    (ntt/matmul.py power_twiddles(ops, N, inverse=True)), shared by the
    lanes. stride: the round's, a power of two up to N. Montgomery limbs
    on one device. CPU: plain version (`fri_fold_round_plain`). CUDA: the
    fri_fold kernel, its layout checked and its geometry worked out on a
    layout's first call only (as `_elementwise_launch`)."""
    log_n = _fold_log_n(tw)
    if stride < 1 or stride & (stride - 1) or stride > 1 << log_n or first < 0:
        raise ValueError(f"stride must be a power of two up to N = 2^{log_n} and first >= 0, "
                         f"got {stride}, {first}")
    if lo.is_cuda:
        key = (field.n16, lo.shape, lo.stride(), lo.dtype, lo.device, hi.shape, hi.stride(),
               hi.dtype, hi.device, roots.shape, roots.stride(), roots.dtype, roots.device,
               tw.lo.shape, tw.lo.device, tw.hi.shape, tw.hi.device, tw.shift)
        geometry = _fold_launches.get(key)
        if geometry is None:
            _check_fold_operands(field, lo, hi, roots, tw)
        out = _out_tensor(out, lo.shape, lo)
        if out.numel() == 0:
            return out
        if geometry is None:
            geometry = _remember(_fold_launches, key,
                                 _i64_array(_fold_strides(field, lo, hi, roots)))
        if lo.data_ptr() % 16 or hi.data_ptr() % 16:
            raise ValueError("lo and hi must lie at 16-byte aligned addresses")
        if tw.lo.data_ptr() % 16 or tw.hi.data_ptr() % 16:
            raise ValueError("the fold's tables must lie at 16-byte aligned addresses")
        p_words, pinv0, _ = _field_args(field)
        r2_words, mask_words, zero_words = _fold_field_args(field)
        code = _kernels().hodor_fri_fold(
            field.n16, out.data_ptr(), lo.data_ptr(), hi.data_ptr(), roots.data_ptr(),
            tw.lo.data_ptr(), tw.hi.data_ptr(), geometry, first, stride.bit_length() - 1, log_n,
            tw.shift, p_words, pinv0, r2_words, mask_words, zero_words, _stream(),
        )
        _check(code, "fri_fold")
        launch_counts["fri_fold"] += 1
        return out
    _check_fold_operands(field, lo, hi, roots, tw)
    if not lo.is_cpu:
        raise ValueError(f"unsupported device {lo.device}")
    res = fri_fold_round_plain(field, lo, hi, roots, tw, stride, first)
    if out is None:
        return res
    out.copy_(res)
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


MMA_RADICES = (32, 64, 128)


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
