"""Prime-field arithmetic on torch tensors of 16-bit Montgomery limbs.

A field array is (..., n16) torch.int32 holding 16-bit limbs,
little-endian, in Montgomery form (x * R mod p, R = 2^(16 n16)), with
values below p: the JAX package's (..., n16) uint32 layout with the same
bytes per element. int32 because CPU torch has no add, shift or compare
for uint32; the plain code widens to int64 for products and carries.

`LimbOps` carries its device. `mul`, `add`, `sub` and the static powers
(`pow_static`, `inv_fermat`) go to the kernel wrappers of field/kernels.py
(CUDA kernel on a CUDA tensor, plain version on a CPU tensor); every
other operation is composed from them and plain tensor ops.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..errors import DivisionByZeroError
from . import kernels
from .field import Field


# ---------------------------------------------------------------- packing

def int_to_limbs(value: int, n16: int) -> np.ndarray:
    return np.array([(value >> (16 * i)) & 0xFFFF for i in range(n16)], dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs, dtype=np.uint64)
    return sum(int(l) << (16 * i) for i, l in enumerate(limbs))


def pack_ints(values, n16: int) -> np.ndarray:
    """Python ints (nested lists / 1-D / 2-D) -> (..., n16) uint32 limbs."""
    arr = np.asarray(values, dtype=object)
    flat = arr.reshape(-1)
    buf = b"".join(int(v).to_bytes(2 * n16, "little") for v in flat)
    return np.frombuffer(buf, dtype="<u2").astype(np.uint32).reshape(arr.shape + (n16,))


def is_u64_rows(values) -> bool:
    """Whether `values` is the packed form of canonical field elements: a
    (..., 4) uint64 array of little-endian 64-bit words (the native witness
    chains' output, utils/native.py)."""
    return (isinstance(values, np.ndarray) and values.dtype == np.uint64 and values.ndim >= 1
            and values.shape[-1] == 4)


def u64_rows_to_limbs(rows: np.ndarray, n16: int, pad_rows: int = 0, out=None) -> np.ndarray:
    """(..., N, 4) uint64 little-endian words -> (..., max(N, pad_rows), n16)
    uint16 limbs, zero rows appended up to pad_rows: a view of the same
    bytes cut to the field's limbs (the words above them must be zero), in
    one copy, into `out` (of that shape and 16-bit items) where given."""
    if not is_u64_rows(rows) or rows.ndim < 2:
        raise ValueError("expected a (..., N, 4) uint64 array")
    if n16 > 16:
        raise ValueError(f"a 4 x 64-bit row holds 16 limbs, the field has {n16}")
    lead, n = rows.shape[:-2], rows.shape[-2]
    u16 = np.ascontiguousarray(rows).view("<u2").reshape(lead + (n, 16))
    if n16 < 16 and u16[..., n16:].any():
        raise ValueError(f"values do not fit {n16} limbs")
    shape = lead + (max(n, pad_rows), n16)
    if out is None:
        out = np.empty(shape, dtype=np.uint16)
    elif out.shape != shape or out.dtype.itemsize != 2:
        raise ValueError(f"out must hold {shape} 16-bit limbs")
    out = out.view(np.uint16)
    out[..., :n, :] = u16[..., :n16]
    out[..., n:, :] = 0
    return out


def unpack_ints(limbs) -> np.ndarray:
    """(..., n16) limbs -> object array of Python ints (a Python int for
    a single element)."""
    limbs = np.asarray(limbs).astype(np.uint64)
    shape = limbs.shape[:-1]
    flat = limbs.reshape(-1, limbs.shape[-1])
    out = np.empty(flat.shape[0], dtype=object)
    for i in range(flat.shape[0]):
        out[i] = limbs_to_int(flat[i])
    return out.reshape(shape) if shape else out[0]


def from_numpy_limbs(arr, device) -> torch.Tensor:
    """A JAX-layout (..., n16) uint32 limb array -> the port's int32
    tensor on `device` (limbs are < 2^16, so the values carry over)."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limb values must be below 2^16")
    return torch.from_numpy(np.ascontiguousarray(arr.astype(np.int32))).to(device)


def fetch_together(tensors):
    """Several device tensors of one dtype brought to the host in one
    device-to-host copy; returns the host tensors in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def to_numpy_limbs(t: torch.Tensor) -> np.ndarray:
    """The port's int32 limb tensor -> a JAX-layout uint32 numpy array."""
    return t.detach().cpu().numpy().astype(np.uint32)


# --------------------------------------------------------------- LimbOps

NTT_IMPLS = ("level", "two_step", "fused")


class LimbOps:
    """Montgomery field ops over (..., n16) int32 limb tensors on one
    device. Constant tables built from the field (DFT matrices,
    twiddles, domain points) are cached in `tables`. `ntt_impl` names the
    form every NTT level of these ops takes (ntt/matmul.py dft_level)."""

    def __init__(self, field: Field, device, ntt_impl: str = "level"):
        if ntt_impl not in NTT_IMPLS:
            raise ValueError(f"ntt_impl must be one of {NTT_IMPLS}, not {ntt_impl!r}")
        self.field = field
        self.device = torch.device(device)
        self.ntt_impl = ntt_impl
        n16 = field.n16
        self.n16 = n16
        # the Montgomery reduce needs u = (t + m p)/R < 2p to fit n16
        # limbs, so p needs a spare top bit
        if field.num_bits > 16 * n16 - 1:
            raise ValueError(
                f"{field}: num_bits={field.num_bits} needs headroom; the u16-limb "
                f"Montgomery arithmetic requires num_bits <= {16 * n16 - 1}"
            )
        self.p_limbs = self._limbs(field.p)
        self.zero_m = self._limbs(0)
        self.one_m = self._limbs(field.R_mod_p)
        self.r2 = self._limbs(field.R2_mod_p)
        self.one_canonical = self._limbs(1)
        self.two_inv_m = self._limbs(field.to_mont(field.inv(2)))
        self.tables: dict = {}

    def _limbs(self, value: int) -> torch.Tensor:
        """(n16,) limbs of a Python int on the device; on the card copied
        from pinned memory, so the host does not wait for the queue."""
        host = torch.from_numpy(int_to_limbs(value, self.n16).astype(np.int32))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    # -- encode / decode (host) --

    def encode(self, values) -> torch.Tensor:
        """Python ints (canonical) -> Montgomery limb tensor on the device;
        the Montgomery conversion (a mul by R^2) runs on the device."""
        packed = pack_ints(values, self.n16)
        t = torch.from_numpy(packed.astype(np.int32)).to(self.device)
        if t.numel() == 0:
            return t
        return self.to_mont_arr(t)

    def encode_u64_rows(self, rows: np.ndarray, pad_rows: int = 0) -> torch.Tensor:
        """(..., N, 4) uint64 canonical little-endian words -> Montgomery
        limb tensor (..., max(N, pad_rows), n16) on the device, zero rows
        appended up to pad_rows. The 16-bit limbs are written once, into
        pinned memory where the device is CUDA, cross to the device as
        they are (2 n16 bytes an element) and are widened to int32 there;
        one to-Montgomery mul."""
        shape = rows.shape[:-2] + (max(rows.shape[-2], pad_rows), self.n16)
        staged = torch.empty(shape, dtype=torch.int16, pin_memory=self.device.type == "cuda")
        u64_rows_to_limbs(rows, self.n16, pad_rows, out=staged.numpy())
        t = staged.to(self.device).to(torch.int32) & 0xFFFF
        if t.numel() == 0:
            return t
        return self.to_mont_arr(t)

    def decode(self, limbs):
        """Montgomery limbs -> object ndarray of canonical ints (an int for
        a single element)."""
        f = self.field
        if isinstance(limbs, torch.Tensor):
            limbs = limbs.detach().cpu().numpy()
        raw = unpack_ints(np.asarray(limbs))
        rinv = pow(f.R, -1, f.p)
        if isinstance(raw, np.ndarray):
            return np.vectorize(lambda v: (int(v) * rinv) % f.p, otypes=[object])(raw)
        return (int(raw) * rinv) % f.p

    def const(self, value: int) -> torch.Tensor:
        """Single canonical int -> (n16,) Montgomery limbs."""
        return self._limbs(self.field.to_mont(value % self.field.p))

    # -- core arithmetic --

    def add(self, a, b, out=None):
        return kernels.addsub(self.field, a, b, "add", out=out)

    def sub(self, a, b, out=None):
        return kernels.addsub(self.field, a, b, "sub", out=out)

    def neg(self, a):
        return self.sub(self.zero_m, a)

    def mul(self, a, b, out=None):
        return kernels.mont_mul(self.field, a, b, out=out)

    def square(self, a):
        return self.mul(a, a)

    def pow_static(self, a, e: int):
        """a^e for a Python-int exponent: square-and-multiply inside one
        launch of the mont_pow kernel, whatever e is."""
        if e == 0:
            return self.one_m.expand(a.shape).clone()
        if e == 1:
            return a
        return kernels.mont_pow(self.field, a.contiguous(), e)

    def to_mont_arr(self, canonical_limbs):
        """Canonical-form limbs -> Montgomery form (mul by R^2)."""
        return self.mul(canonical_limbs, self.r2)

    def from_mont_arr(self, mont_limbs):
        """Montgomery form -> canonical-form limbs (mul by canonical 1)."""
        return self.mul(mont_limbs, self.one_canonical)

    def is_zero(self, a):
        """Boolean mask (...,) - works for Montgomery or canonical form."""
        return (a == 0).all(dim=-1)

    def assert_nonzero(self, arr):
        """Raise DivisionByZeroError where any element of arr is zero (the
        reference's batch_inversion Err); a host check, one sync."""
        if bool(self.is_zero(arr).any()):
            raise DivisionByZeroError("batch inversion of a zero element")

    def select(self, mask, a, b):
        """mask (...,) bool -> where(mask, a, b) elementwise over limbs."""
        return torch.where(mask[..., None], a, b)

    # -- derived bulk ops --

    def powers(self, x, n: int, start=None):
        """[s, s*x, ..., s*x^(n-1)] along a new axis -2, for x of shape
        (..., n16) (a scalar or a batch of bases); `start` defaults to 1.
        Log-doubling: log2(n) muls over the growing table."""
        s = self.one_m if start is None else start
        lead = torch.broadcast_shapes(x.shape[:-1], s.shape[:-1])
        out = torch.empty(lead + (n, self.n16), dtype=torch.int32, device=self.device)
        if n == 0:
            return out
        out[..., 0, :] = s
        step = x
        total = 1
        while total < n:
            take = min(total, n - total)
            dst = out[..., total:total + take, :]
            prod = self.mul(out[..., :take, :], step[..., None, :],
                            out=dst if dst.is_contiguous() else None)
            if prod.data_ptr() != dst.data_ptr():
                dst.copy_(prod)
            if total * 2 < n:
                step = self.square(step)
            total *= 2
        return out

    def sum_reduce(self, arr, axis=0):
        """Field sum along an axis via a binary tree of modular adds."""
        arr = torch.movedim(arr, axis, 0)
        n = arr.shape[0]
        while n > 1:
            half = n // 2
            paired = self.add(arr[:half], arr[half:2 * half])
            if n % 2:
                paired = torch.cat([paired, arr[2 * half:n]], dim=0)
            arr = paired
            n = arr.shape[0]
        return arr[0]

    def prod_scan(self, arr, reverse: bool = False):
        """Inclusive prefix products along axis 0 (Hillis-Steele)."""
        n = arr.shape[0]
        ones = self.one_m.expand(arr.shape)
        shift = 1
        while shift < n:
            if reverse:
                shifted = torch.cat([arr[shift:], ones[:shift]], dim=0)
            else:
                shifted = torch.cat([ones[:shift], arr[:-shift]], dim=0)
            arr = self.mul(arr, shifted)
            shift *= 2
        return arr

    def inv_fermat(self, x):
        """x^(p-2), MSB-first square-and-multiply over the exponent bits
        (about 1.5 * log2(p) products an element) as one launch of the
        mont_pow kernel: one device program, as the JAX package's fori_loop.
        For single elements or small batches; large arrays go through
        `batch_inverse`."""
        return kernels.mont_pow(self.field, x.contiguous(), self.field.p - 2)

    def batch_inverse(self, arr):
        """Elementwise inverse of (..., N, n16) via a product tree along
        axis -2, for every leading index at once: pairwise products up (i
        with i + m/2), one Fermat inverse of the roots, and the inverses
        distributed back down. A zero element yields garbage: callers keep
        zeros out (DEEP checks its divisor points on the host, Polynomial
        checks its values)."""
        n = arr.shape[-2]
        if n == 1:
            return self.inv_fermat(arr)
        n_pad = 1 << (n - 1).bit_length()
        work = arr
        if n_pad != n:
            ones = self.one_m.expand(arr.shape[:-2] + (n_pad - n, self.n16))
            work = torch.cat([arr, ones], dim=-2)
        levels = [work]
        cur = work
        while cur.shape[-2] > 1:
            half = cur.shape[-2] // 2
            cur = self.mul(cur[..., :half, :], cur[..., half:, :])
            levels.append(cur)
        inv = self.inv_fermat(cur)
        for lvl in reversed(levels[:-1]):
            half = lvl.shape[-2] // 2
            a, b = lvl[..., :half, :], lvl[..., half:, :]
            inv = torch.cat([self.mul(inv, b), self.mul(inv, a)], dim=-2)
        return inv[..., :n, :]


@lru_cache(maxsize=None)
def _ops_for(field: Field, device: torch.device) -> LimbOps:
    return LimbOps(field, device)


def ops_for(field: Field, device="cuda") -> LimbOps:
    """The one LimbOps of `field` on `device` (the card unless the caller
    asks for the CPU), shared by every caller in the process with its
    tables. Raises where the device is CUDA and torch sees no card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"ops_for({field}, {device}): torch sees no CUDA device; "
                               "pass device=\"cpu\" for the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return _ops_for(field, device)
