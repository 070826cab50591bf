"""Voxel gather and scatter — the hybrid backbone's PVConv hot path.

Port of pcfm/ops/voxel_sorted.py and of the two TPU kernels under it
(pcfm/ops/pallas/voxel_sorted.py: ``gather_windows`` -> ``_gather_kernel
_fused``, ``scatter_windows`` -> ``_scatter_kernel_fused``).  The kernels
compute what the TPU kernels compute, with the same general contract
(K = 1 or 8 entries per point, any weights, ids in any order):

    voxel_gather:   out[b, n, c] = sum_k w[b, k, n] * grid[b, ids[b, k, n], c]
    voxel_scatter:  out[b, v, c] = sum_{n, k: ids[b, k, n] = v}
                                       w[b, k, n] * upd[b, n, c]

grid (B, V, C) and upd (B, N, C) in bf16 or fp32, ids (B, K, N) int32 in
[0, V), w (B, K, N) fp32; both return fp32.  The TPU's one-hot MXU windows
(``pick_window``, ``ALIGN``, ``TR``, ``FUSE_TR``, ``GATHER_OUT_BF16``) are
its way around having no vector gather; Hopper gathers with indexed loads
(pcfm_torch/csrc/voxel_gather.cu).  The scatter is deterministic, with no
float atomics (PARITY.md deviation 1): a ``ScatterPlan`` holds a stable
sort of the (n, k) entries by voxel id and a CSR row pointer, and the
kernel (pcfm_torch/csrc/voxel_scatter.cu) sums each voxel's entries in that
fixed order and writes every grid row once, empty voxels 0.  The plan's
row pointer also gives the per-voxel counts, hence the inverse counts of
``avg_voxelize`` with no count kernel (the TPU's ``counts_sorted`` /
``inv_counts_*``).  ``torch.argsort`` and ``searchsorted`` that build a
plan are glue, as ``jnp.argsort`` is outside the TPU kernel.

CUDA tensors launch the kernels (and raise on what they do not take); CPU
tensors run the plain versions ``voxel_gather_reference`` (take_along_axis)
and ``voxel_scatter_reference`` (index_add_), which the CPU tests and the
on-card comparison use.  ``launches`` counts kernel launches, never
plain-version calls.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from pcfm_torch.ops.build import check_launch, load_library, use_kernel
from pcfm_torch.ops.voxel import (corner_ids_weights, flatten_voxel_ids,
                                  normalize_coords)

launches = {"voxel_gather": 0, "voxel_scatter": 0}

KS = (1, 8)


@dataclasses.dataclass
class ScatterPlan:
    """The entries of ``ids`` (B, K, N) in voxel order: ``order`` (B, K*N)
    int32 holds flat entry indices k * N + n sorted stably by voxel id,
    ``rowptr`` (B, V + 1) int32 the CSR offsets of each voxel's run."""
    ids: torch.Tensor
    order: torch.Tensor
    rowptr: torch.Tensor
    num_rows: int

    def counts(self) -> torch.Tensor:
        """(B, V) entries per voxel."""
        return self.rowptr[:, 1:] - self.rowptr[:, :-1]


def scatter_plan(ids: torch.Tensor, num_rows: int) -> ScatterPlan:
    """Sort the (B, K, N) entries of ``ids`` by voxel id (stable, so each
    voxel's entries keep their (k, n) order) and build the row pointer."""
    b = ids.shape[0]
    flat = ids.reshape(b, -1)
    keys, order = torch.sort(flat, dim=1, stable=True)
    bins = torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device)
    rowptr = torch.searchsorted(keys, bins.expand(b, -1).contiguous())
    return ScatterPlan(ids=ids, order=order.to(torch.int32),
                       rowptr=rowptr.to(torch.int32), num_rows=num_rows)


# ------------------------------------------------------------ plain versions

def voxel_gather_reference(grid: torch.Tensor, ids: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather (fp32 math, corners summed in k order)."""
    b, _, c = grid.shape
    g32 = grid.to(torch.float32)
    out = torch.zeros((b, ids.shape[2], c), dtype=torch.float32,
                      device=grid.device)
    for k in range(ids.shape[1]):
        idx = ids[:, k].long()[..., None].expand(-1, -1, c)
        out = out + w[:, k, :, None].to(torch.float32) \
            * torch.gather(g32, 1, idx)
    return out


def voxel_scatter_reference(upd: torch.Tensor, ids: torch.Tensor,
                            w: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain version of the scatter (fp32 math, ``index_add_``)."""
    b, n, c = upd.shape
    k = ids.shape[1]
    rows = ids.long() + torch.arange(b, device=ids.device)[:, None, None] \
        * num_rows
    vals = w[..., None].to(torch.float32) \
        * upd.to(torch.float32)[:, None, :, :]                   # (B, K, N, C)
    out = torch.zeros((b * num_rows, c), dtype=torch.float32,
                      device=upd.device)
    out.index_add_(0, rows.reshape(-1), vals.reshape(b * k * n, c))
    return out.reshape(b, num_rows, c)


# ------------------------------------------------------------ kernels

@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pcfm_voxel_gather.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.pcfm_voxel_gather.restype = i32
    lib.pcfm_voxel_scatter.argtypes = [ptr] * 5 + [i32] * 6 + [ptr]
    lib.pcfm_voxel_scatter.restype = i32
    return lib


def _check(what: str, dense: torch.Tensor, ids: torch.Tensor,
           w: torch.Tensor, extra: dict):
    """The kernels' operand contract: one CUDA device, contiguous,
    16-byte-aligned bf16 / fp32 rows with C % 8 == 0, int32 ids / plan,
    fp32 weights, K in (1, 8)."""
    if dense.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: features must be bf16 or fp32, got "
                        f"{dense.dtype}")
    if ids.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"{what}: ids must be int32 and weights fp32, got "
                        f"{ids.dtype} / {w.dtype}")
    c = dense.shape[-1]
    if c % 8 or c == 0:
        raise ValueError(f"{what} kernel takes C % 8 == 0, got C={c}")
    for name, x in {"features": dense, "ids": ids, "weights": w,
                    **extra}.items():
        if x.device != dense.device:
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
    """out (B, N, C) fp32 = sum_k w[:, k, n] * grid[:, ids[:, k, n], :]."""
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
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = _lib().pcfm_voxel_gather(
            grid.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
            b, n, k, v, c, int(grid.dtype == torch.bfloat16), stream)
    check_launch(err, "voxel_gather")
    launches["voxel_gather"] += 1
    return out


def voxel_scatter(upd: torch.Tensor, w: torch.Tensor,
                  plan: ScatterPlan) -> torch.Tensor:
    """out (B, V, C) fp32: each voxel's weighted sum of the rows of ``upd``
    that ``plan.ids`` sends to it (0 where none does)."""
    if upd.dim() != 3:
        raise ValueError(f"voxel_scatter: updates must be (B, N, C), got "
                         f"{tuple(upd.shape)}")
    b, n, c = upd.shape
    ids, v = plan.ids, plan.num_rows
    _check_shapes("voxel_scatter", ids, w, b, n)
    if not use_kernel(upd, "voxel_scatter"):
        return voxel_scatter_reference(upd, ids, w, v)
    _check("voxel_scatter", upd, ids, w, {"order": plan.order,
                                          "rowptr": plan.rowptr})
    if plan.order.dtype != torch.int32 or plan.rowptr.dtype != torch.int32 \
            or plan.rowptr.shape != (b, v + 1) \
            or plan.order.shape != (b, ids.shape[1] * n):
        raise ValueError("voxel_scatter: plan does not fit the updates")
    if n == 0:
        return torch.zeros((b, v, c), dtype=torch.float32, device=upd.device)
    out = torch.empty((b, v, c), dtype=torch.float32, device=upd.device)
    with torch.cuda.device(upd.device):
        stream = torch.cuda.current_stream(upd.device).cuda_stream
        err = _lib().pcfm_voxel_scatter(
            upd.data_ptr(), w.data_ptr(), plan.order.data_ptr(),
            plan.rowptr.data_ptr(), out.data_ptr(), b, n, ids.shape[1], v,
            c, int(upd.dtype == torch.bfloat16), stream)
    check_launch(err, "voxel_scatter")
    launches["voxel_scatter"] += 1
    return out


# ------------------------------------------------------------ the voxel ops

def inv_counts(plan: ScatterPlan) -> torch.Tensor:
    """(B, N) fp32: 1 / occupancy of each point's voxel (K = 1 plans),
    read off the plan's row pointer."""
    cnt = plan.counts().gather(1, plan.ids[:, 0].long())
    return 1.0 / cnt.to(torch.float32)


def avg_voxelize_sorted(features: torch.Tensor, ids: torch.Tensor,
                        resolution: int, plan: ScatterPlan | None = None,
                        inv_pt: torch.Tensor | None = None) -> torch.Tensor:
    """Scatter-mean of (B, N, C) features into a flat (B, R^3, C) fp32 grid
    (pcfm/ops/voxel_sorted.py:avg_voxelize_sorted): one scatter with
    weight 1 / count.  ``ids`` (B, N) need not be sorted; ``plan`` /
    ``inv_pt`` come from the stage cache when there is one."""
    if plan is None:
        plan = scatter_plan(ids[:, None, :].contiguous(), resolution ** 3)
    if inv_pt is None:
        inv_pt = inv_counts(plan)
    return voxel_scatter(features.contiguous(), inv_pt[:, None, :], plan)


def corner_data(norm_coords: torch.Tensor, r: int):
    """(B, N, 3) coords -> (ids8 (B, 8, N) int32, w8 (B, 8, N) fp32)."""
    ids8, w8 = corner_ids_weights(norm_coords, r)
    return (ids8.transpose(1, 2).contiguous(),
            w8.transpose(1, 2).contiguous())


def trilinear_devoxelize_sorted(grid_flat: torch.Tensor,
                                norm_coords: torch.Tensor, resolution: int,
                                corners: tuple | None = None
                                ) -> torch.Tensor:
    """Trilinear interpolation of a flat (B, R^3, C) grid at (B, N, 3)
    coords in [0, R-1] -> (B, N, C) fp32: one K = 8 gather
    (pcfm/ops/voxel_sorted.py:trilinear_devoxelize_sorted)."""
    if corners is None:
        corners = corner_data(norm_coords, resolution)
    ids8, w8 = corners
    return voxel_gather(grid_flat.contiguous(), ids8, w8)


def build_stage_cache(coords: torch.Tensor, r: int, normalize: bool = True,
                      eps: float = 0.0) -> dict:
    """What every PVConv at resolution ``r`` shares in one forward (the
    coordinates do not change across the ContextNet): normalised coords,
    voxel ids, the scatter plan, inverse counts and the 8 corners.
    Returns {'norm_coords', 'vox_ids', 'plan', 'inv_pt', 'corners'}."""
    norm_coords, vox_coords = normalize_coords(coords, r,
                                               normalize=normalize, eps=eps)
    ids = flatten_voxel_ids(vox_coords, r)
    plan = scatter_plan(ids[:, None, :].contiguous(), r ** 3)
    return {"norm_coords": norm_coords, "vox_ids": ids, "plan": plan,
            "inv_pt": inv_counts(plan),
            "corners": corner_data(norm_coords, r)}


def sort_perm_by_voxel(coords: torch.Tensor, resolution: int,
                       normalize: bool = True, eps: float = 0.0):
    """(B, N, 3) coords -> (perm, inv) int64 sorting the points stably by
    their flat voxel id at ``resolution`` (the ContextNet entry sort;
    ``jnp.argsort`` is stable too)."""
    _, vc = normalize_coords(coords, resolution, normalize=normalize,
                             eps=eps)
    ids = flatten_voxel_ids(vc, resolution)
    perm = torch.argsort(ids, dim=1, stable=True)
    return perm, torch.argsort(perm, dim=1)


def permute_points(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows of (B, N, C) in ``perm`` order (take_along_axis)."""
    return torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[-1]))


def unpermute_points(x: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Inverse of ``permute_points``: rows back in the original order,
    from the inverse permutation ``inv``."""
    return permute_points(x, inv)
