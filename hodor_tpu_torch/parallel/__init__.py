"""Multi-device proving over torch.distributed: meshes, the two
collectives, and the sharded LDE and NTTs (the port of
hodor_tpu/parallel/__init__.py).

The JAX package runs one controller over a `jax.sharding.Mesh` and lets
XLA insert the collectives. The port runs one process per rank, each
with one device, joined by `torch.distributed`; every rank runs the same
program, and every value the host sees is the same on every rank (the
SPMD-controller style of parallel/multihost.py).

Layout: row blocks, JAX's P(axis, None). Rank r of W holds rows
[r N/W, (r+1) N/W) of every evaluation-domain array, in natural order.
Every function here takes and returns such a block (`local_rows` cuts
one from a replicated array, `gather_rows` joins the blocks back,
`rows_to_host` brings them to rank 0's host one at a time). The FRI
ladder (parallel/fri.py) deals its folded blocks to the ranks in another
order: an owner order, order[k] the rank that holds natural block k,
which these three also take.

- `make_mesh`: a 1-D DeviceMesh over the process group;
- `sharded_lde`: the reference's `lde_using_multiple_cosets`
  (src/polynomials/mod.rs:418-482) with the coset axis split over the
  ranks - each rank runs its cosets' NTTs with no exchange - and one
  `all_to_all` for the natural-order interleave;
- `four_step_ntt`: one NTT of N = N1 N2 points (N1 = W) as row NTTs, a
  twiddle product and column NTTs with three `all_to_all` transposes
  (the structure of parallel_fft, src/fft/fft.rs:68-125), or for
  N < W^2 one `all_gather` and a local NTT;
- `four_step_intt`, `sharded_icoset_ntt`, `sharded_coset_lde_rows`.

Every NTT runs through the port's `ntt` on `ntt_level` and `mont_mul`,
as on one device. The exchanges go through `all_to_all` (with
`all_to_all_v`, its form with uneven parts) and `all_gather`, which
count their calls, bytes and seconds by kind in
`collective_counts` (the port's stand-in for the JAX package's audit of
the compiled program's collectives).
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from ..domain import Domain
from ..field.limbs import LimbOps
from ..ntt import _coset_generators, _interleave, ntt

AXIS = "shards"
COLLECTIVES = ("all_to_all", "all_gather")
# per kind: calls, the bytes this rank received from the other ranks, and
# the seconds of the calls (on a card from CUDA events around each call,
# added when they are read, so that no collective waits for the device)
collective_counts = {kind: {"calls": 0, "bytes": 0, "seconds": 0.0} for kind in COLLECTIVES}
_pending_events = []  # (kind, start, end) of card collectives not yet in the seconds


def _settle(wait: bool) -> None:
    """Add the seconds of the card collectives whose end event has passed
    (of all of them when wait) to collective_counts."""
    while _pending_events and (wait or _pending_events[0][2].query()):
        kind, start, end = _pending_events.pop(0)
        end.synchronize()
        collective_counts[kind]["seconds"] += start.elapsed_time(end) / 1e3


def reset_collective_counts() -> None:
    _pending_events.clear()
    for counts in collective_counts.values():
        counts.update(calls=0, bytes=0, seconds=0.0)


def collective_snapshot() -> dict:
    """A copy of `collective_counts` (waits for the card collectives'
    seconds)."""
    _settle(wait=True)
    return {kind: dict(counts) for kind, counts in collective_counts.items()}


def collectives_since(snapshot: dict) -> dict:
    """What the collectives added to `collective_counts` since `snapshot`."""
    _settle(wait=True)
    return {kind: {key: collective_counts[kind][key] - snapshot[kind][key]
                   for key in snapshot[kind]} for kind in COLLECTIVES}


def make_mesh(n_devices=None, device="cuda"):
    """A 1-D DeviceMesh named ("shards",) over the whole process group,
    one rank a device of `device`'s type (the card unless the caller
    asks for the CPU). n_devices, where given, must be the world size:
    one process is one rank."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of that many "
                         f"ranks, this one has {world}")
    return init_device_mesh(torch.device(device).type, (world,), mesh_dim_names=(AXIS,))


@contextlib.contextmanager
def _counted(kind: str, t, nbytes: int):
    """Counts one collective on t; its seconds from the host clock on the
    CPU (gloo blocks there), from CUDA events on the card."""
    if t.is_cuda:
        stream = torch.cuda.current_stream(t.device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
    else:
        t0 = time.perf_counter()
    yield
    counts = collective_counts[kind]
    counts["calls"] += 1
    counts["bytes"] += nbytes
    if t.is_cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        _pending_events.append((kind, start, end))
        _settle(wait=False)
    else:
        counts["seconds"] += time.perf_counter() - t0


def all_to_all(x, mesh):
    """x: (W, ...) on this rank, chunk i for rank i. Returns (W, ...)
    whose chunk i came from rank i (one `all_to_all_single`)."""
    w = mesh.size()
    x = x.contiguous()
    out = torch.empty_like(x)
    with _counted("all_to_all", x, x.nbytes // w * (w - 1)):
        dist.all_to_all_single(out, x, group=mesh.get_group())
    return out


def all_gather(x, mesh):
    """x (...) on every rank -> (W, ...), rank i's x at i (one
    `all_gather`)."""
    w = mesh.size()
    x = x.contiguous()
    out = torch.empty((w,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    with _counted("all_gather", x, x.nbytes * (w - 1)):
        dist.all_gather(list(out.unbind(0)), x, group=mesh.get_group())
    return out


def all_to_all_v(x, send, recv, mesh):
    """Rows to the other ranks in uneven parts: x (sum(send), ...) holds
    send[i] rows for rank i, in rank order; returns the (sum(recv), ...)
    rows received, recv[i] of them from rank i, in rank order (one
    `all_to_all_single` with split sizes, counted as an all_to_all)."""
    x = x.contiguous()
    out = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    r = mesh.get_local_rank()
    row_bytes = out[:1].nbytes if out.shape[0] else 0
    with _counted("all_to_all", x, (sum(recv) - recv[r]) * row_bytes):
        dist.all_to_all_single(out, x, output_split_sizes=list(recv),
                               input_split_sizes=list(send), group=mesh.get_group())
    return out


def local_rows(x, mesh, order=None):
    """This rank's row block of a replicated (..., N, L) array (a view; a
    numpy array works too): natural block r, or under an owner order the
    block k with order[k] = r."""
    n = x.shape[-2] // mesh.size()
    k = mesh.get_local_rank() if order is None else order.index(mesh.get_local_rank())
    return x[..., k * n:(k + 1) * n, :]


def gather_rows(x, mesh, order=None):
    """Every rank's (..., N/W, L) row block -> the (..., N, L) array on
    every rank (one all_gather); blocks in an owner order go back to
    their natural places."""
    got = all_gather(x, mesh)  # (W, ..., N/W, L), rank order
    if order is not None:
        got = got[list(order)]
    return got.movedim(0, -3).reshape(x.shape[:-2] + (-1, x.shape[-1]))


def rows_to_host(x, mesh, order=None):
    """Every rank's (..., N/W, L) row block -> the whole (..., N, L) array
    in host memory on rank 0, None on the other ranks. The blocks travel
    one at a time, each from its owner to rank 0 in one all_to_all_v, and
    each leaves the device as it arrives: no rank holds more than one
    block beyond its own on its device. order: as in gather_rows."""
    w, r = mesh.size(), mesh.get_local_rank()
    rows = x.movedim(-2, 0)  # (N/W, ..., L): all_to_all_v splits the first axis

    def block_of(owner):  # on rank 0 the owner's block, elsewhere nothing
        if owner == 0:
            return rows[:len(rows) if r == 0 else 0]
        send = [len(rows) if r == owner and i == 0 else 0 for i in range(w)]
        recv = [len(rows) if r == 0 and i == owner else 0 for i in range(w)]
        return all_to_all_v(rows[:len(rows) if r == owner else 0], send, recv, mesh)

    blocks = [block_of(owner).cpu() for owner in (range(w) if order is None else order)]
    return torch.cat(blocks).movedim(0, -2) if r == 0 else None


def sharded_lde(ops: LimbOps, coeffs, factor: int, mesh, coset: bool = False):
    """LDE with the coset axis split over the ranks. coeffs: (..., T, L)
    replicated. Returns this rank's rows of the (..., T*factor, L)
    natural-order LDE (ntt.lde's values).

    Rank r computes cosets [r F/W, (r+1) F/W) with no exchange (JAX :66-76);
    one all_to_all then sends peer s the rows j in [s T/W, (s+1) T/W) of
    those cosets, (F/W, T/W, L), and the received (F, T/W, L) cosets
    interleave into rows j F + c, this rank's block of the output (the
    exchange XLA inserts at JAX :83-86)."""
    w = mesh.size()
    t, L = coeffs.shape[-2], coeffs.shape[-1]
    if factor % w or t % w:
        raise ValueError(f"sharded_lde needs the factor ({factor}) and T ({t}) divisible by "
                         f"the mesh size {w}")
    per_rank, tw = factor // w, t // w
    r = mesh.get_local_rank()
    gens = _coset_generators(ops, t, factor, coset)[r * per_rank:(r + 1) * per_rank]
    evals = ntt(ops, ops.mul(coeffs[..., None, :, :], ops.powers(gens, t)))  # (.., F/W, T, L)
    lead = evals.shape[:-3]
    blocks = evals.reshape(lead + (per_rank, w, tw, L)).movedim(-3, 0)  # (W, .., F/W, T/W, L)
    got = all_to_all(blocks, mesh).movedim(0, -4)  # (.., W, F/W, T/W, L): source rank first
    return _interleave(got.reshape(lead + (factor, tw, L)), tw, factor, L)


def four_step_ntt(ops: LimbOps, a, mesh, inverse: bool = False):
    """Natural-order NTT of (..., N, L) held as row blocks: a is this
    rank's (..., N/W, L) block; returns its block of the transform.

    Two forms, JAX's conditions: the three-all_to_all four-step
    (`_four_step_ntt_all_to_all`) where W > 1, N/W >= W and W divides
    N/W; elsewhere (N < W^2, or one rank) one all_gather, the local ntt,
    and this rank's block of it (the form of JAX's `_four_step_ntt_gspmd`,
    which lets GSPMD gather at those sizes)."""
    w = mesh.size()
    n2 = a.shape[-2]
    if w > 1 and n2 >= w and n2 % w == 0:
        return _four_step_ntt_all_to_all(ops, a, mesh, inverse)
    return local_rows(ntt(ops, gather_rows(a, mesh), inverse), mesh)


def _four_step_twiddle_offsets(ops: LimbOps, n: int, n1: int, n2p: int, inverse: bool):
    """(n1, L) Montgomery limbs: row d = w^(d n2') (w^-1 when inverse), the
    base of rank d's step-3 twiddles (rank d owns the j2 block
    [d n2', (d+1) n2') after the corner turn)."""
    domain = Domain.new_for_size(ops.field, n)
    g = domain.generator_inv if inverse else domain.generator
    base = pow(g, n2p, ops.field.p)
    return ops.encode([pow(base, d, ops.field.p) for d in range(n1)])


def _four_step_ntt_all_to_all(ops: LimbOps, a, mesh, inverse: bool, coset_gen=None):
    """The distributed four-step with three all_to_all transposes. a:
    (..., n2, L), rank d's rows j = d n2 + j2 of the (..., N, L) input,
    N = n1 n2 with n1 = W, read as A[j1 = d, j2].

    coset_gen: optional (..., L) Montgomery generators g (one per leading
    index): the transform is then NTT(g^j a[j]), a coset evaluation
    (src/polynomials/mod.rs:544-609), the shift applied on this rank's
    rows alone from g^(d n2), so no N-sized shift table exists."""
    n1 = mesh.size()
    lead = a.shape[:-2]
    n2, L = a.shape[-2], a.shape[-1]
    n2p = n2 // n1  # j2 rows a rank owns after the corner turn
    n = n1 * n2
    d = mesh.get_local_rank()
    domain = Domain.new_for_size(ops.field, n)
    om = ops.const(domain.generator_inv if inverse else domain.generator)
    if coset_gen is not None:
        a = ops.mul(a, ops.powers(coset_gen, n2, start=ops.pow_static(coset_gen, d * n2)))
    # transpose 1 (corner turn): j2 block b of every j1 to rank b
    x = all_to_all(a.reshape(lead + (n1, n2p, L)).movedim(-3, 0), mesh)  # [j1, .., j2l]
    # step 2: n1-point NTTs over j1
    inner = ntt(ops, x.movedim(0, -2), inverse=inverse)  # (.., n2p, n1, L) [j2l, k1]
    # step 3: twiddles w^(k1 j2), j2 = d n2p + j2l: m = w^j2, then m^k1
    offsets = _four_step_twiddle_offsets(ops, n, n1, n2p, inverse)
    m = ops.powers(om, n2p, start=offsets[d])  # (n2p, L)
    inner = ops.mul(inner, ops.powers(m, n1))  # (n2p, n1, L) [j2l, k1]
    # transpose 2: every j2 of k1 to rank k1
    b = all_to_all(inner.movedim(-2, 0), mesh)  # [source j2 block, .., j2l]
    b = b.movedim(0, -3).reshape(lead + (n2, L))  # j2 in natural order, k1 = d
    # step 4: n2-point NTT over j2 (local)
    outer = ntt(ops, b, inverse=inverse)  # [k2] for k1 = d
    # transpose 3: natural-order interleave out[k2 n1 + k1]
    o = all_to_all(outer.reshape(lead + (n1, n2p, L)).movedim(-3, 0), mesh)  # [k1, .., k2l]
    return o.movedim(0, -2).reshape(lead + (n2, L))  # rows k2l n1 + k1 of block d


def four_step_intt(ops: LimbOps, a, mesh):
    """Sharded inverse NTT with the 1/N scale (reference Polynomial::ifft,
    src/polynomials/mod.rs:773-797)."""
    n = a.shape[-2] * mesh.size()
    return ops.mul(four_step_ntt(ops, a, mesh, inverse=True), ops.const(ops.field.inv(n % ops.field.p)))


def sharded_icoset_ntt(ops: LimbOps, a, mesh):
    """Sharded icoset_fft (src/polynomials/mod.rs:799-815): the G
    interpolant's inverse transform, then the g^-i un-shift on this
    rank's rows i."""
    coeffs = four_step_intt(ops, a, mesh)
    n2 = a.shape[-2]
    geninv = ops.field.inv(ops.field.generator)
    start = ops.const(pow(geninv, mesh.get_local_rank() * n2, ops.field.p))
    return ops.mul(coeffs, ops.powers(ops.const(geninv), n2, start=start))


def sharded_coset_lde_rows(ops: LimbOps, coeffs, factor: int, mesh, coset: bool = True):
    """Coset-LDE for blow-up factors below the mesh size, where
    sharded_lde's coset split cannot use every rank: every coset's
    T-point NTT runs row-sharded. coeffs: (..., T, L) replicated; returns
    this rank's rows of the natural-order (..., T*factor, L) LDE,
    final[j factor + c] = coset_c[j] (src/polynomials/mod.rs:544-609).

    Where the three-all_to_all four-step applies (JAX :303-338) the batch
    x coset stack (b factor, T/W, L) is one four-step, each coset's shift
    applied shard-locally; elsewhere the shifted stack goes through
    four_step_ntt's gather form. A rank's rows j of every coset are the
    rows j factor + c of the output block, so the interleave is local."""
    w = mesh.size()
    t, L = coeffs.shape[-2], coeffs.shape[-1]
    tw = t // w
    lead = coeffs.shape[:-2]
    flat = coeffs.reshape((-1, t, L))
    b = flat.shape[0]
    gens = _coset_generators(ops, t, factor, coset)  # (factor, L)
    if w > 1 and tw >= w and tw % w == 0:
        xs = local_rows(flat, mesh)[:, None].expand(b, factor, tw, L).reshape(b * factor, tw, L)
        gs = gens[None].expand(b, factor, L).reshape(b * factor, L)
        ev = _four_step_ntt_all_to_all(ops, xs, mesh, False, coset_gen=gs)
    else:
        shifted = ops.mul(flat[:, None], ops.powers(gens, t))  # (b, factor, T, L)
        ev = four_step_ntt(ops, local_rows(shifted, mesh).reshape(b * factor, tw, L), mesh)
    ev = _interleave(ev.reshape(b, factor, tw, L), tw, factor, L)
    return ev.reshape(lead + (tw * factor, L))
