"""Voxel gather and scatter — the hybrid backbone's PVConv hot path.

Port of pcfm/ops/voxel_sorted.py and of the two TPU kernels under it
(pcfm/ops/pallas/voxel_sorted.py: ``gather_windows`` -> ``_gather_kernel
_fused``, ``scatter_windows`` -> ``_scatter_kernel_fused``).  The kernels
compute what the TPU kernels compute, with the same general contract
(K = 1 or 8 entries per point, any weights, ids in any order):

    voxel_gather:   out[b, n, c] = sum_k w[b, k, n] * grid[b, ids[b, k, n], c]
    voxel_scatter:  out[b, v, c] = sum_{n, k: ids[b, k, n] = v}
                                       w[b, k, n] * upd[b, n, c]

grid (B, V, C) and upd (B, N, C) in bf16 or fp32 with any C (as the TPU
kernels, whose channel block is the whole row up to C = 256), ids
(B, K, N) int32 in [0, V), w (B, K, N) fp32; both return fp32.  The
TPU's one-hot MXU windows (``pick_window``, ``ALIGN``, ``TR``, ``FUSE_TR``, ``GATHER_OUT_BF16``) are
its way around having no vector gather; Hopper gathers with indexed loads
(pcfm_torch/csrc/voxel_gather.cu, one block per tile of points).  The
scatter is deterministic, with no float atomics (PARITY.md deviation 1): a
``ScatterPlan`` holds a stable sort of the (n, k) entries by voxel id, a
CSR row pointer, and the runs longer than ``SCATTER_CHUNK`` entries cut
into chunks (``scatter_chunks``), so that no work item of the kernel
(pcfm_torch/csrc/voxel_scatter.cu) walks a long run alone.  In one
launch, a chunk writes its fp32 partial row and the last chunk of a run to
finish sums the run's partials in chunk order; a short run is summed in
order by its voxel's owner; an empty voxel gets 0; every output row is
written once (``voxel_scatter_chunked_reference`` is that two-level sum in
plain torch).  The plan's row pointer also gives the
per-voxel counts, hence the inverse counts of ``avg_voxelize`` with no
count kernel (the TPU's ``counts_sorted`` / ``inv_counts_*``).
``torch.sort``, ``searchsorted`` and ``cumsum`` that build a plan are
glue, as ``jnp.argsort`` is outside the TPU kernel.

The ops differentiate as the JAX package's custom VJPs do, each through
the other kernel (``torch.autograd.Function``s): avg-voxelize's backward is
the K = 1 gather, devoxelize's the K = 8 scatter, and the entry sort's
permutation's a gather by the inverse permutation; ids, weights and plans
get no gradient.  CUDA tensors launch the kernels (and raise on what they
do not take), forward and backward; CPU tensors run the plain versions
``voxel_gather_reference`` (take_along_axis) and
``voxel_scatter_reference`` (index_add_), which the CPU tests and the
on-card comparison use.  ``launches`` counts kernel launches (one a call
of a wrapper), never plain-version calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pcfm_torch.ops.build import (check_launch, current_device, load_library,
                                  stream_of, use_kernel)
from pcfm_torch.ops.voxel import (corner_ids_weights, flatten_voxel_ids,
                                  normalize_coords)
from pcfm_torch.parallel.collectives import reduce_no_grad

launches = {"voxel_gather": 0, "voxel_scatter": 0}

KS = (1, 8)


# entries a work item of the scatter kernel sums at most (the CUDA
# source's SCATTER_CHUNK must be equal)
SCATTER_CHUNK = 64


@dataclasses.dataclass
class ScatterPlan:
    """The entries of ``ids`` (B, K, N) in voxel order: ``order`` (B, K*N)
    int32 holds flat entry indices k * N + n sorted stably by voxel id,
    ``rowptr`` (B, V + 1) int32 the CSR offsets of each voxel's run;
    ``chunkptr`` (B, V + 1) and ``chunk_voxel`` (B, max_chunks) int32 cut
    the runs longer than ``SCATTER_CHUNK`` entries into chunks of at most
    that many (``scatter_chunks``).  The kernel's scratch lives with the
    plan, so a plan serves one launch at a time (launches on one stream):
    ``done`` (B, V) int32 counts each long run's finished chunks and is
    zero between launches; ``workspace`` holds the chunks' partial rows.
    """
    ids: torch.Tensor
    order: torch.Tensor
    rowptr: torch.Tensor
    num_rows: int
    chunkptr: torch.Tensor
    chunk_voxel: torch.Tensor
    done: torch.Tensor
    _work: dict = dataclasses.field(default_factory=dict, repr=False)

    def counts(self) -> torch.Tensor:
        """(B, V) entries per voxel."""
        return self.rowptr[:, 1:] - self.rowptr[:, :-1]

    def workspace(self, c: int) -> torch.Tensor:
        """(B, max_chunks, c) fp32 scratch for the partial rows, made at
        the first launch with ``c`` channels and kept (one allocation a
        plan, not one a call: the allocation is host time the scatter's
        short launches cannot hide)."""
        if c not in self._work:
            self._work[c] = torch.empty(
                (*self.chunk_voxel.shape, c), dtype=torch.float32,
                device=self.chunk_voxel.device)
        return self._work[c]


def max_chunks(entries: int) -> int:
    """Most chunks ``entries`` entries can make: only runs of c > E =
    SCATTER_CHUNK entries are cut, into ceil(c / E) < 2 c / E chunks, so
    the total is below 2 * entries / E."""
    return 2 * entries // SCATTER_CHUNK


def scatter_chunks(rowptr: torch.Tensor, entries: int) -> tuple:
    """The scatter's work split, from the (B, V + 1) row pointer.

    A voxel's run of c = rowptr[v+1] - rowptr[v] entries is summed by one
    work item when c <= E = SCATTER_CHUNK; a longer run is cut into
    ceil(c / E) chunks, each summed alone into a partial row, and the
    partials are then summed in chunk order.  ``chunkptr`` (B, V + 1) is
    the exclusive prefix of the chunk counts (0 for a run of c <= E), so
    chunk j belongs to the voxel v with chunkptr[v] <= j < chunkptr[v+1]
    and covers the entries [rowptr[v] + (j - chunkptr[v]) * E, min(that +
    E, rowptr[v+1])) of ``order``.  ``chunk_voxel`` (B, max_chunks(entries))
    int32 is that v for every j (V past the cloud's last chunk).  Returns
    (chunkptr, chunk_voxel)."""
    e = SCATTER_CHUNK
    counts = rowptr[:, 1:] - rowptr[:, :-1]
    per_voxel = torch.where(
        counts > e, torch.div(counts + (e - 1), e, rounding_mode="floor"), 0)
    chunkptr = torch.cat([torch.zeros_like(rowptr[:, :1]),
                          per_voxel.cumsum(1, dtype=rowptr.dtype)], dim=1)
    j = torch.arange(max_chunks(entries), dtype=rowptr.dtype,
                     device=rowptr.device)
    chunk_voxel = torch.searchsorted(
        chunkptr[:, 1:].contiguous(), j.expand(rowptr.shape[0], -1)
        .contiguous(), right=True)
    return chunkptr, chunk_voxel.to(torch.int32)


def chunk_entries(plan: ScatterPlan) -> tuple:
    """(start, end) (B, max_chunks) int64: the range of ``order`` each chunk
    sums (empty past the cloud's last chunk), by ``scatter_chunks``'s
    formula."""
    v = plan.num_rows
    cv = plan.chunk_voxel.long()
    live = cv < v
    cvc = cv.clamp(max=v - 1)
    j = torch.arange(cv.shape[1], device=cv.device)
    start = plan.rowptr.long().gather(1, cvc) \
        + (j - plan.chunkptr.long().gather(1, cvc)) * SCATTER_CHUNK
    end = torch.minimum(start + SCATTER_CHUNK,
                        plan.rowptr.long().gather(1, cvc + 1))
    return torch.where(live, start, 0), torch.where(live, end, 0)


def scatter_plan(ids: torch.Tensor, num_rows: int) -> ScatterPlan:
    """Sort the (B, K, N) entries of ``ids`` by voxel id (stable, so each
    voxel's entries keep their (k, n) order), build the row pointer and cut
    the runs into chunks."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    keys, order = torch.sort(flat, dim=1, stable=True)
    bins = torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device)
    rowptr = torch.searchsorted(keys, bins.expand(b, -1).contiguous()) \
        .to(torch.int32)
    chunkptr, chunk_voxel = scatter_chunks(rowptr, flat.shape[1])
    return ScatterPlan(ids=ids, order=order.to(torch.int32), rowptr=rowptr,
                       num_rows=num_rows, chunkptr=chunkptr,
                       chunk_voxel=chunk_voxel,
                       done=torch.zeros_like(rowptr[:, 1:]))


# ------------------------------------------------------------ plain versions

def _acc(x: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: fp32 (fp64 for fp64 inputs, so that
    gradcheck can run on them)."""
    return torch.promote_types(x.dtype, torch.float32)


def voxel_gather_reference(grid: torch.Tensor, ids: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather (fp32 math, corners summed in k order)."""
    b, _, c = grid.shape
    acc = _acc(grid)
    g32 = grid.to(acc)
    out = torch.zeros((b, ids.shape[2], c), dtype=acc, device=grid.device)
    for k in range(ids.shape[1]):
        idx = ids[:, k].long()[..., None].expand(-1, -1, c)
        out = out + w[:, k, :, None].to(acc) * torch.gather(g32, 1, idx)
    return out


def voxel_scatter_reference(upd: torch.Tensor, ids: torch.Tensor,
                            w: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of the scatter (fp32 math, ``index_add_``)."""
    b, n, c = upd.shape
    k = ids.shape[1]
    acc = _acc(upd)
    rows = ids.long() + torch.arange(b, device=ids.device)[:, None, None] \
        * num_rows
    vals = w[..., None].to(acc) * upd.to(acc)[:, None, :, :]   # (B, K, N, C)
    out = torch.zeros((b * num_rows, c), dtype=acc, device=upd.device)
    out.index_add_(0, rows.reshape(-1), vals.reshape(b * k * n, c))
    return out.reshape(b, num_rows, c)


def voxel_scatter_chunked_reference(upd: torch.Tensor, w: torch.Tensor,
                                    plan: ScatterPlan) -> torch.Tensor:
    """The kernel's sums in plain torch (fp32): a run of at most
    ``SCATTER_CHUNK`` entries is summed in ``order``'s order; a longer run's
    chunks are each summed so into a partial row, and the partials summed
    in chunk order; empty voxels are 0."""
    b, n, c = upd.shape
    v, kn = plan.num_rows, plan.order.shape[1]
    order = plan.order.long()
    vals = torch.gather(w.reshape(b, kn), 1, order)[..., None] \
        * torch.gather(upd.to(torch.float32), 1,
                       (order % n)[..., None].expand(-1, -1, c))
    # each position of ``order``: its voxel, and its chunk (-1 in a short
    # run)
    pos = torch.arange(kn, device=upd.device)
    voxel = torch.searchsorted(plan.rowptr[:, 1:].contiguous(),
                               pos.to(torch.int32).expand(b, -1)
                               .contiguous(), right=True).long()
    cp, rp = plan.chunkptr.long(), plan.rowptr.long()
    long_run = (cp[:, 1:] > cp[:, :-1]).gather(1, voxel)
    chunk_of = torch.where(long_run, cp.gather(1, voxel)
                           + (pos - rp.gather(1, voxel)) // SCATTER_CHUNK,
                           -1)
    out = torch.zeros((b, v, c), dtype=torch.float32, device=upd.device)
    for bb in range(b):
        short = ~long_run[bb]
        out[bb].index_add_(0, voxel[bb][short], vals[bb][short])
        part = torch.zeros((plan.chunk_voxel.shape[1], c),
                           dtype=torch.float32, device=upd.device)
        part.index_add_(0, chunk_of[bb][~short], vals[bb][~short])
        live = plan.chunk_voxel[bb] < v
        out[bb].index_add_(0, plan.chunk_voxel[bb][live].long(),
                           part[live])
    return out


# ------------------------------------------------------------ kernels

@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pcfm_voxel_gather.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.pcfm_voxel_gather.restype = i32
    lib.pcfm_voxel_scatter.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
    lib.pcfm_voxel_scatter.restype = i32
    return lib


def _check(what: str, dense: torch.Tensor, ids: torch.Tensor,
           w: torch.Tensor, extra: dict):
    """The kernels' operand contract: one CUDA device, contiguous bf16 /
    fp32 rows of any C > 0 from a 16-byte-aligned base (the kernels move a
    row in slices of 16 bytes when C % 8 == 0, else of the widest of 8, 4
    or 2 bytes that C's rows keep aligned), int32 ids / plan, fp32
    weights, K in (1, 8)."""
    if dense.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: features must be bf16 or fp32, got "
                        f"{dense.dtype}")
    if ids.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"{what}: ids must be int32 and weights fp32, got "
                        f"{ids.dtype} / {w.dtype}")
    if dense.shape[-1] == 0:
        raise ValueError(f"{what} kernel takes C > 0")
    dev = dense.get_device()
    for name, x in {"features": dense, "ids": ids, "weights": w,
                    **extra}.items():
        if x.get_device() != dev:
            raise ValueError(f"{what}: {name} is on {x.device}, features "
                             f"on {dense.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if dense.data_ptr() % 16:
        raise ValueError(f"{what}: features must be 16-byte aligned")


def _check_shapes(what: str, ids: torch.Tensor, w: torch.Tensor, b: int,
                  n: int):
    if ids.dim() != 3 or ids.shape[0] != b or ids.shape[2] != n \
            or ids.shape[1] not in KS:
        raise ValueError(f"{what}: ids must be (B, K, N) with K in {KS}, "
                         f"B={b}, N={n}; got {tuple(ids.shape)}")
    if w.shape != ids.shape:
        raise ValueError(f"{what}: weights {tuple(w.shape)} != ids "
                         f"{tuple(ids.shape)}")


def voxel_gather(grid: torch.Tensor, ids: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """out (B, N, C) fp32 = sum_k w[:, k, n] * grid[:, ids[:, k, n], :],
    any C."""
    if grid.dim() != 3:
        raise ValueError(f"voxel_gather: grid must be (B, V, C), got "
                         f"{tuple(grid.shape)}")
    b, v, c = grid.shape
    _check_shapes("voxel_gather", ids, w, b, ids.shape[-1])
    if not use_kernel(grid, "voxel_gather"):
        return voxel_gather_reference(grid, ids, w)
    _check("voxel_gather", grid, ids, w, {})
    k, n = ids.shape[1], ids.shape[2]
    out = torch.empty((b, n, c), dtype=torch.float32, device=grid.device)
    if n == 0:
        return out
    with current_device(grid):
        err = _lib().pcfm_voxel_gather(
            grid.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, n, k, v, c, int(grid.dtype == torch.bfloat16),
            stream_of(grid))
    check_launch(err, "voxel_gather")
    launches["voxel_gather"] += 1
    return out


def voxel_scatter(upd: torch.Tensor, w: torch.Tensor,
                  plan: ScatterPlan) -> torch.Tensor:
    """out (B, V, C) fp32: each voxel's weighted sum of the rows of ``upd``
    that ``plan.ids`` sends to it (0 where none does), any C."""
    if upd.dim() != 3:
        raise ValueError(f"voxel_scatter: updates must be (B, N, C), got "
                         f"{tuple(upd.shape)}")
    b, n, c = upd.shape
    ids, v = plan.ids, plan.num_rows
    _check_shapes("voxel_scatter", ids, w, b, n)
    if not use_kernel(upd, "voxel_scatter"):
        return voxel_scatter_reference(upd, ids, w, v)
    _check("voxel_scatter", upd, ids, w, {
        "order": plan.order, "rowptr": plan.rowptr,
        "chunkptr": plan.chunkptr, "chunk_voxel": plan.chunk_voxel,
        "done": plan.done})
    kn = ids.shape[1] * n
    mc = max_chunks(kn)
    if plan.order.shape != (b, kn) \
            or plan.rowptr.shape != (b, v + 1) \
            or plan.chunkptr.shape != (b, v + 1) \
            or plan.chunk_voxel.shape != (b, mc) \
            or plan.done.shape != (b, v) \
            or any(x.dtype != torch.int32 for x in (
                plan.order, plan.rowptr, plan.chunkptr, plan.chunk_voxel,
                plan.done)):
        raise ValueError("voxel_scatter: plan does not fit the updates")
    if n == 0:
        return torch.zeros((b, v, c), dtype=torch.float32, device=upd.device)
    out = torch.empty((b, v, c), dtype=torch.float32, device=upd.device)
    work = plan.workspace(c)
    with current_device(upd):
        err = _lib().pcfm_voxel_scatter(
            upd.data_ptr(), w.data_ptr(), plan.order.data_ptr(),
            plan.rowptr.data_ptr(), plan.chunkptr.data_ptr(),
            plan.chunk_voxel.data_ptr(), out.data_ptr(), work.data_ptr(),
            plan.done.data_ptr(), b, n, ids.shape[1], v, c, mc, SCATTER_CHUNK,
            int(upd.dtype == torch.bfloat16), stream_of(upd))
    check_launch(err, "voxel_scatter")
    launches["voxel_scatter"] += 1
    return out


# ------------------------------------------------------------ the voxel ops

def inv_counts(plan: ScatterPlan, axis=None) -> torch.Tensor:
    """(B, N) fp32: 1 / occupancy of each point's voxel (K = 1 plans),
    read off the plan's row pointer.  ``axis``: the points axis of the
    process grid the clouds are cut over; a voxel's points may then lie
    on several ranks, so the (B, R^3) count grids are all-reduced first
    (pcfm/parallel/sp_sorted.py:shmap_inv_counts; exact in fp32 below
    2^24 points a voxel)."""
    grid = reduce_no_grad(plan.counts().to(torch.float32), axis)
    return 1.0 / grid.gather(1, plan.ids[:, 0].long())


class _AvgVoxelize(torch.autograd.Function):
    """Scatter-mean and its transpose (pcfm/ops/voxel_sorted.py:
    _avg_vox_fwd / _avg_vox_bwd): forward the K = 1 scatter with weight
    1 / count, backward the K = 1 gather of the fp32 grid's cotangent with
    the same weights, cast to the features' dtype.  Only the plan and the
    weights are kept for the backward; they get no gradient."""

    @staticmethod
    def forward(ctx, features, w, plan):
        ctx.save_for_backward(w)
        ctx.plan, ctx.dtype = plan, features.dtype
        return voxel_scatter(features.contiguous(), w, plan)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        # g is the fp32 grid's cotangent (the kernels take it as it is)
        df = voxel_gather(g.contiguous(), ctx.plan.ids, w)
        return df.to(ctx.dtype), None, None


class _Devoxelize(torch.autograd.Function):
    """Trilinear gather and its transpose (pcfm/ops/voxel_sorted.py:
    _devox_fwd / _devox_bwd): forward the K = 8 gather, backward the K = 8
    scatter of the fp32 cotangent with the corner weights over the stage's
    ``corner_plan`` (built at the first backward of a stage and kept in its
    cache, so one plan serves the stage's PVConvs), cast to the grid's
    dtype.  Nothing but the stage cache is kept for the backward."""

    @staticmethod
    def forward(ctx, grid_flat, cache):
        ctx.cache, ctx.dtype = cache, grid_flat.dtype
        ctx.rows = grid_flat.shape[1]
        ids8, w8 = cache["corners"]
        return voxel_gather(grid_flat.contiguous(), ids8, w8)

    @staticmethod
    def backward(ctx, g):
        plan = corner_plan(ctx.cache, ctx.rows)
        # g is the fp32 output's cotangent
        dg = voxel_scatter(g.contiguous(), ctx.cache["corners"][1], plan)
        return dg.to(ctx.dtype), None


class _Permute(torch.autograd.Function):
    """Rows of (B, N, C) in ``perm`` order; the backward gathers by the
    inverse permutation (pcfm/ops/voxel_sorted.py:285-301), never a
    scatter (``torch.gather``'s own backward is a zero fill and an atomic
    ``scatter_add_``)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return _take_rows(x, perm)

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        return _take_rows(g, inv), None, None


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def avg_voxelize_sorted(features: torch.Tensor, ids: torch.Tensor,
                        resolution: int, plan: ScatterPlan | None = None,
                        inv_pt: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-mean of (B, N, C) features into a flat (B, R^3, C) fp32 grid
    (pcfm/ops/voxel_sorted.py:avg_voxelize_sorted): one scatter with
    weight 1 / count, differentiable in ``features`` (``_AvgVoxelize``).
    ``ids`` (B, N) need not be sorted; ``plan`` / ``inv_pt`` come from the
    stage cache when there is one."""
    if plan is None:
        plan = scatter_plan(ids[:, None, :].contiguous(), resolution ** 3)
    if inv_pt is None:
        inv_pt = inv_counts(plan)
    return _AvgVoxelize.apply(features, inv_pt[:, None, :], plan)


def corner_data(norm_coords: torch.Tensor, r: int):
    """(B, N, 3) coords -> (ids8 (B, 8, N) int32, w8 (B, 8, N) fp32)."""
    ids8, w8 = corner_ids_weights(norm_coords, r)
    return (ids8.transpose(1, 2).contiguous(),
            w8.transpose(1, 2).contiguous())


def trilinear_devoxelize_sorted(grid_flat: torch.Tensor,
                                norm_coords: torch.Tensor, resolution: int,
                                cache: dict | None = None) -> torch.Tensor:
    """Trilinear interpolation of a flat (B, R^3, C) grid at (B, N, 3)
    coords in [0, R-1] -> (B, N, C) fp32: one K = 8 gather
    (pcfm/ops/voxel_sorted.py:trilinear_devoxelize_sorted), differentiable
    in the grid (``_Devoxelize``).  ``cache``: the stage cache, whose
    corners (and K = 8 plan, for the backward) it uses."""
    if cache is None:
        cache = {"corners": corner_data(norm_coords, resolution)}
    return _Devoxelize.apply(grid_flat, cache)


def build_stage_cache(coords: torch.Tensor, r: int, normalize: bool = True,
                      eps: float = 0.0, axis=None) -> dict:
    """What every PVConv at resolution ``r`` shares in one forward (the
    coordinates do not change across the ContextNet): normalised coords,
    voxel ids, the scatter plan, inverse counts and the 8 corners.
    Returns {'norm_coords', 'vox_ids', 'plan', 'inv_pt', 'corners', 'sp'};
    ``corner_plan`` adds the K = 8 plan on demand (the first backward).
    ``axis`` (kept as 'sp'): the points axis the clouds are cut over; the
    plan is this rank's, the normalisation and the counts the whole
    cloud's (pcfm/parallel/sp_sorted.py:shmap_stage_cache)."""
    norm_coords, vox_coords = normalize_coords(coords, r,
                                               normalize=normalize, eps=eps,
                                               axis=axis)
    ids = flatten_voxel_ids(vox_coords, r)
    plan = scatter_plan(ids[:, None, :].contiguous(), r ** 3)
    return {"norm_coords": norm_coords, "vox_ids": ids, "plan": plan,
            "inv_pt": inv_counts(plan, axis),
            "corners": corner_data(norm_coords, r), "sp": axis}


def corner_plan(cache: dict, num_rows: int | None = None) -> ScatterPlan:
    """The K = 8 plan over a stage cache's corner ids into ``num_rows``
    voxels (R^3; by default the cache's K = 1 plan's): the scatter that is
    devoxelize's transpose (the hybrid backward's), with its chunks; built
    at first use and kept in the cache under 'plan8'."""
    if "plan8" not in cache:
        cache["plan8"] = scatter_plan(
            cache["corners"][0],
            cache["plan"].num_rows if num_rows is None else num_rows)
    return cache["plan8"]


def sort_perm_by_voxel(coords: torch.Tensor, resolution: int,
                       normalize: bool = True, eps: float = 0.0, axis=None):
    """(B, N, 3) coords -> (perm, inv) int64 sorting the points stably by
    their flat voxel id at ``resolution`` (the ContextNet entry sort;
    ``jnp.argsort`` is stable too).  ``axis``: the points axis the clouds
    are cut over; the voxel ids are the whole cloud's, the sort this
    rank's (pcfm/parallel/sp_sorted.py:shmap_sort_perm)."""
    _, vc = normalize_coords(coords, resolution, normalize=normalize,
                             eps=eps, axis=axis)
    ids = flatten_voxel_ids(vc, resolution)
    perm = torch.argsort(ids, dim=1, stable=True)
    return perm, torch.argsort(perm, dim=1)


def permute_points(x: torch.Tensor, perm: torch.Tensor,
                   inv: torch.Tensor) -> torch.Tensor:
    """Rows of (B, N, C) in ``perm`` order (take_along_axis); the gradient
    is a gather by ``inv``, the inverse permutation."""
    return _Permute.apply(x, perm, inv)


def unpermute_points(x: torch.Tensor, perm: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Inverse of ``permute_points``: rows back in the original order (a
    gather by ``inv``; the gradient a gather by ``perm``)."""
    return permute_points(x, inv, perm)
