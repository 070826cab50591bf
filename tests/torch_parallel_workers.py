"""Rank processes for the port's parallel tests, on the CPU over gloo.

Imports nothing of JAX, so that a spawned rank starts in the time torch
takes to import.  ``run_ranks(fn, world, tmp, *args)`` spawns ``world``
processes that join one gloo group through a ``file://`` rendezvous in
``tmp`` (so that test workers running side by side never share a port),
and calls ``fn(rank, world, tmp, *args)`` in each; a rank's exception
fails the call.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# each rank's threads (the ranks share the test worker's cores)
THREADS = 2


def _entry(rank: int, fn, world: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(THREADS)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, tmp, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp: str, *args) -> None:
    os.makedirs(tmp, exist_ok=True)
    mp.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world,
                       join=True, start_method="spawn")


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in batch.items()}


def named_params(state) -> dict:
    """{group/name: tensor} of the live enc / pf / lf parameters."""
    return {f"{g}/{n}": p for g in ("enc", "pf", "lf")
            for n, p in getattr(state.bundle, g).named_parameters()}


def step_cases(rank: int, world: int, tmp: str, cases: list) -> None:
    """Each case: (name, cfg kwargs, dp, sp, global batch (numpy), steps,
    state file or None, list of global draws or None).  A rank trains its
    block of the batch for ``steps`` steps from the state (or the seed),
    and writes ``{name}.rank{r}.pt``: the first step's metrics and
    gradients (after the all-reduce and the clip), every step's metrics,
    and the parameters and the point flow's buffers after the last
    step."""
    from pcfm_torch.parallel import sp_context
    from pcfm_torch.parallel.mesh import make_grid, shard_batch
    for name, kw, dp, sp, batch, steps, state_file, draws in cases:
        grid = make_grid(dp, sp, batch["pts"].shape[1])
        sp_context.set_sp_group(grid)
        try:
            out = train_steps(kw, shard_batch(tensors(batch), grid), steps,
                              state_file, draws)
        finally:
            sp_context.set_sp_group(None)
        torch.save(out, os.path.join(tmp, f"{name}.rank{rank}.pt"))


def train_steps(kw: dict, batch: dict, steps: int, state_file=None,
                draws=None) -> dict:
    """``steps`` train steps on ``batch`` (this rank's block, under the
    grid in sp_context; the whole batch on one rank) from the state in
    ``state_file`` (the seed's without one), with the generator's draws
    or the given global ones."""
    from pcfm_torch.config import Config
    from pcfm_torch.train.state import broadcast_state, init_state
    from pcfm_torch.train.step import train_step
    st = init_state(Config(**kw), "cpu", 100,
                    torch.Generator().manual_seed(0))
    if state_file is not None:
        sd = torch.load(state_file, weights_only=True)
        for key, module in st.bundle.modules().items():
            module.load_state_dict(sd[key])
    broadcast_state(st)
    gen = torch.Generator().manual_seed(1)
    out = {"metrics": []}
    for i in range(steps):
        m = train_step(st, batch, gen, 1.0, 0.5,
                       draws=None if draws is None else draws[i])
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {k: p.grad.clone()
                            for k, p in named_params(st).items()
                            if p.grad is not None}
    out["params"] = {k: p.detach().clone()
                     for k, p in named_params(st).items()}
    out["buffers"] = {k: b.clone() for k, b in st.bundle.pf.named_buffers()}
    return out


def op_cases(rank: int, world: int, tmp: str, dp: int, sp: int,
             cases: list) -> None:
    """Each case: (name, fn, inputs): ``fn(grid, inputs)`` is a callable
    of this module run under the grid, returning a dict of tensors that is
    written to ``{name}.rank{r}.pt``."""
    from pcfm_torch.parallel import sp_context
    from pcfm_torch.parallel.mesh import make_grid
    for name, fn, inputs in cases:
        n = next(v.shape[1] for v in inputs.values()
                 if getattr(v, "ndim", 0) >= 2)
        grid = make_grid(dp, sp, n)
        sp_context.set_sp_group(grid)
        try:
            out = fn(grid, inputs)
        finally:
            sp_context.set_sp_group(None)
        torch.save(out, os.path.join(tmp, f"{name}.rank{rank}.pt"))


# ------------------------------------------------------------ the sp ops
# Each op below runs on one rank's block (``grid``: the process grid; None
# on one rank) and returns its outputs and gradients.  The per-rank loss
# is <cotangent, output> for an output cut over the points, and that over
# the points axis's size for a replica (a grid, a pooled code), so that
# the ranks' losses sum to the one-rank loss: then every input's gradient
# is the block of the one-rank gradient, and a parameter's, summed over
# the ranks, the one-rank one.

R = 4                          # voxel resolution of the op cases


def _block(grid, x: torch.Tensor) -> torch.Tensor:
    """This rank's (B / dp, N / sp) block of a global (B, N, ...) input."""
    from pcfm_torch.parallel.mesh import batch_block, point_block
    return x[batch_block(grid, x.shape[0]), point_block(grid, x.shape[1])]


def _share(grid) -> float:
    return 1.0 if grid is None else float(grid.sp)


def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().clone().requires_grad_(True)


def _param_grads(module) -> dict:
    return {f"param/{n}": p.grad.clone() for n, p in module.named_parameters()
            if p.grad is not None}


def op_normalize(grid, inp: dict) -> dict:
    from pcfm_torch.ops.voxel import normalize_coords
    from pcfm_torch.parallel.sp_context import sp_axis
    nc, vc = normalize_coords(_block(grid, inp["pts"]), R, eps=1e-6,
                              axis=sp_axis())
    return {"nc": nc, "vc": vc}


def _cache(grid, pts):
    from pcfm_torch.ops.voxel_sorted import build_stage_cache
    from pcfm_torch.parallel.sp_context import sp_axis
    return build_stage_cache(_block(grid, pts), R, eps=1e-6, axis=sp_axis())


def op_counts(grid, inp: dict) -> dict:
    cache = _cache(grid, inp["pts"])
    return {"inv_pt": cache["inv_pt"], "ids": cache["vox_ids"]}


def op_voxelize(grid, inp: dict) -> dict:
    from pcfm_torch.parallel.sp_ops import sp_avg_voxelize
    f = _leaf(_block(grid, inp["feat"]))
    out = sp_avg_voxelize(f, _cache(grid, inp["pts"]), R)
    ((out * inp["ct_grid"]).sum() / _share(grid)).backward()
    return {"out": out.detach(), "grad": f.grad}


def op_devoxelize(grid, inp: dict) -> dict:
    from pcfm_torch.ops.voxel_sorted import trilinear_devoxelize_sorted
    cache = _cache(grid, inp["pts"])
    g = _leaf(inp["grid"])
    out = trilinear_devoxelize_sorted(g, cache["norm_coords"], R,
                                      cache=cache)
    (out * _block(grid, inp["ct_pts"])).sum().backward()
    return {"out": out.detach(), "param/grid": g.grad}


def op_groupnorm(grid, inp: dict) -> dict:
    from pcfm_torch.nn.common import GroupNorm
    gn = GroupNorm(4, inp["feat"].shape[-1])
    with torch.no_grad():
        gn.weight.copy_(inp["gn_w"])
        gn.bias.copy_(inp["gn_b"])
    x = _leaf(_block(grid, inp["feat"]))
    out = gn(x)
    (out * _block(grid, inp["ct_pts"])).sum().backward()
    return {"out": out.detach(), "grad": x.grad, **_param_grads(gn)}


def op_global_max(grid, inp: dict) -> dict:
    from pcfm_torch.parallel.sp_context import sp_axis
    from pcfm_torch.parallel.sp_ops import sp_global_max
    h = _leaf(_block(grid, inp["ties"]))
    out = sp_global_max(h, sp_axis())
    ((out * inp["ct_code"]).sum() / _share(grid)).backward()
    return {"out": out.detach(), "grad": h.grad}


def _encoder():
    from pcfm_torch.models.encoder import ShapeEncoder
    return ShapeEncoder(latent_dim=8, width=16, depth=4, in_channels=3,
                        generator=torch.Generator().manual_seed(3))


def op_encoder(grid, inp: dict) -> dict:
    enc = _encoder()
    x = _leaf(_block(grid, inp["pts"]))
    z, _ = enc(x)
    ((z * inp["ct_z"]).sum() / _share(grid)).backward()
    return {"out": z.detach(), "grad": x.grad, **_param_grads(enc)}


def _context_net(norm_type: str):
    from pcfm_torch.models.context import ContextNet
    return ContextNet(in_point_dim=6, cond_dim=2, emb_dim=16, ctx_dim=8,
                      stage_channels=(8, 16), stage_blocks=(1, 1),
                      stage_res=(4, 2), with_se=True, norm_type=norm_type,
                      gn_groups=4, generator=torch.Generator().manual_seed(4))


def _op_context(grid, inp: dict, norm_type: str) -> dict:
    from pcfm_torch.nn.common import BatchNorm
    net = _context_net(norm_type)
    with torch.no_grad():     # a non-zero head, so that every path counts
        net.head_out.weight.normal_(0.0, 0.2,
                                    generator=torch.Generator().manual_seed(5))
    x = _leaf(_block(grid, inp["x"]))
    ctx = net(x, inp["t"], inp["cond"])
    (ctx * _block(grid, inp["ct_ctx"])).sum().backward()
    stats = {f"stat/{n}.{k}": getattr(m, k).clone()
             for n, m in net.named_modules() if isinstance(m, BatchNorm)
             for k in ("running_mean", "running_var")}
    return {"out": ctx.detach(), "grad": x.grad, **_param_grads(net),
            **stats}


def op_context_group(grid, inp: dict) -> dict:
    return _op_context(grid, inp, "group")


def op_context_batch(grid, inp: dict) -> dict:
    return _op_context(grid, inp, "batch")
