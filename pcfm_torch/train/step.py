"""The flow-matching train step — port of pcfm/train/step.py (reference
train.py:553-673).

  * encoder z = enc([pts || rgb * color_on])  (geometry warmup zeroes RGB)
  * point-flow FM: t ~ Beta(a, 1), x_t = (1 - t) x0 + t x1, target
    v = x1 - x0, MSE split pos / colour with lambda_color * color_on
  * latent-flow FM on detached z (unconditional)
  * optional endpoint EMD, zreg / var / cov / pair penalties on z and the
    gradient-reversal adversary; optional sliced-OT prior coupling
  * joint grad clip, per-group AdamW, EMA of the point and latent flows

The point flow runs once a step, in training mode: the hybrid's
BatchNorms normalise with the batch's statistics and move their running
ones once (pcfm/train/step.py:118-125); its voxel ops' backward is the
other kernel's (pcfm_torch/ops/voxel_sorted.py).

The random draws (t, priors, CFG drop mask, latent t and noise, pair
indices, the sliced-OT direction) come from an explicit
``torch.Generator`` on the batch's device, or are handed in as ``draws``,
so a test can give both frameworks the same numbers.  Beta(a, 1) is
drawn as ``u ** (1 / a)`` with u ~ U(0, 1) (its CDF is x^a):
``torch.distributions.Beta`` takes no generator.

Under data and point-axis parallelism (pcfm_torch/parallel; the grid in
``sp_context``) each rank holds a (B / dp, N / sp) block of the global
batch.  The draws are made for the global batch from the one generator
(every rank's is seeded alike) and each rank takes its block
(``shard_draws``), so the sharded step sees the single-device step's
numbers, as the JAX package's one ``rng`` gives them.  Each rank's loss
is its block's, as if the block were the batch
(pcfm_torch/parallel/collectives.py gives the rule); the terms that are
not means over points or clouds reduce explicitly:

  * ``loss_var`` and ``loss_cov`` take statistics of z over the global
    batch: z is all-gathered over the data axis (``loss_zreg`` is a mean
    and needs none);
  * the endpoint EMD, the sliced-OT coupling and the pair penalty need
    whole clouds: the cloud (and the prediction, the prior) is
    all-gathered over the points axis first.  The pair penalty's second
    subsample (``idx2``, indices into the whole cloud) is cut over the
    points axis like the cloud, and the encoder pools it over the axis.

The logged metrics are averaged over the world; the gradients are
averaged by ``TrainState.apply_gradients``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from pcfm_torch.models.adversary import grad_reverse
from pcfm_torch.ops.emd import earth_mover_distance
from pcfm_torch.parallel import sp_context
from pcfm_torch.parallel.collectives import all_gather, reduce_no_grad
from pcfm_torch.parallel.mesh import batch_block, point_block
from pcfm_torch.sample.priors import make_pf_prior
from pcfm_torch.train.state import TrainState


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2)


def beta_a1(generator: torch.Generator, a: float, n: int) -> torch.Tensor:
    """n draws of Beta(a, 1), skewed toward 1 for a > 1."""
    u = torch.rand(n, generator=generator, device=generator.device)
    return u ** (1.0 / a)


def sliced_ot_permutation(u: torch.Tensor, data_xyz: torch.Tensor,
                          prior_xyz: torch.Tensor) -> torch.Tensor:
    """(B, N) permutation pairing prior to data points by rank along the
    direction ``u`` (3,) — the exact 1-D OT (monotone rearrangement) in the
    projected space; a fresh direction per step makes it sliced OT in
    expectation (pcfm/train/step.py:sliced_ot_permutation).  new_prior[i]
    = prior[perm[i]] is paired to data[i]: the prior's marginal is
    unchanged, only the coupling tightens.  Stable sorts, as jnp.argsort."""
    u = u / torch.clamp_min(torch.linalg.vector_norm(u), 1e-6)
    rank_d = torch.argsort(data_xyz @ u, dim=1, stable=True)
    rank_p = torch.argsort(prior_xyz @ u, dim=1, stable=True)
    # the k-th ranked prior point lands at the k-th ranked data slot:
    # perm[i] = rank_p[inv_d[i]]
    inv_d = torch.argsort(rank_d, dim=1, stable=True)
    return torch.gather(rank_p, 1, inv_d)


def fm_interpolate(t: torch.Tensor, x1: torch.Tensor, z0: torch.Tensor):
    """x_t = (1 - t) z0 + t x1 and the target velocity x1 - z0."""
    tb = t.reshape((x1.shape[0],) + (1,) * (x1.ndim - 1))
    return (1.0 - tb) * z0 + tb * x1, x1 - z0


def _rgb_path(cfg, batch) -> bool:
    return cfg.pf_point_dim == 6 and batch.get("rgb") is not None


def make_draws(cfg, batch: Dict[str, torch.Tensor],
               generator: torch.Generator, drop_p_now: float
               ) -> Dict[str, torch.Tensor]:
    """Every random number of one step of the global batch, from
    ``generator``: ``t`` (B,), ``x0`` the point prior (B, N, D) before
    ``color_on``, ``drop`` the CFG drop mask (B,) (1 = dropped), ``t_z``
    (B,), ``eps_z`` (B, latent), with ``lambda_pair > 0`` ``idx2`` (B, N),
    and with ``fm_coupling='sliced_ot'`` the direction ``u`` (3,)
    (normal).  ``batch`` is this rank's block: (B, N) are its shape times
    the grid's (dp, sp)."""
    bsz, n, _ = batch["pts"].shape
    grid = sp_context.get_grid()
    if grid is not None:
        bsz, n = bsz * grid.dp, n * grid.sp
    dev = generator.device
    d = 6 if _rgb_path(cfg, batch) else 3
    draws = {
        "t": beta_a1(generator, cfg.t_beta_a, bsz),
        "x0": make_pf_prior(generator, (bsz, n, d), cfg.point_prior_std,
                            cfg.color_prior, cfg.color_prior_std),
        "drop": (torch.rand(bsz, generator=generator, device=dev)
                 < drop_p_now).to(torch.float32),
        "t_z": beta_a1(generator, cfg.t_beta_a, bsz),
        "eps_z": torch.randn((bsz, cfg.latent_dim), generator=generator,
                             device=dev) * cfg.latent_prior_std}
    if cfg.lambda_pair > 0:
        draws["idx2"] = torch.randint(0, n, (bsz, n), generator=generator,
                                      device=dev)
    if cfg.fm_coupling == "sliced_ot":
        draws["u"] = torch.randn(3, generator=generator, device=dev)
    return draws


def shard_draws(draws: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """This rank's block of the global batch's draws: the batch rows of
    each, and the points of ``x0`` and ``idx2`` (whose values stay indices
    into the whole cloud); ``u`` is every rank's.  The draws themselves
    with no grid."""
    grid = sp_context.get_grid()
    if grid is None:
        return draws
    rows = batch_block(grid, draws["t"].shape[0])
    out = {}
    for k, v in draws.items():
        if k == "u":
            out[k] = v
        elif k in ("x0", "idx2"):
            out[k] = v[rows, point_block(grid, v.shape[1])]
        else:
            out[k] = v[rows]
    return out


def compute_loss(bundle, batch: Dict[str, torch.Tensor],
                 draws: Dict[str, torch.Tensor], color_on: float):
    """(loss, metrics) of one batch (pcfm/train/step.py:loss_fn).  batch:
    'pts' (B, N, 3); optional 'rgb' (B, N, 3) in [0, 1]; optional 'cond'
    (B, C)."""
    cfg = bundle.cfg
    pts = batch["pts"].to(torch.float32)
    rgb, cond = batch.get("rgb"), batch.get("cond")
    bsz = pts.shape[0]
    if cond is None and cfg.cond_dim > 0:
        # zero-pad a missing condition (keeps pf_cond_dim consistent)
        cond = torch.zeros((bsz, cfg.cond_dim), device=pts.device)

    x0 = draws["x0"]
    if _rgb_path(cfg, batch):
        data_pf = torch.cat([pts, rgb * color_on], dim=-1)
        # geometry warmup: colour prior zeroed together with colour data
        x0 = torch.cat([x0[..., :3], x0[..., 3:] * color_on], dim=-1)
    else:
        data_pf = pts
    points = sp_context.sp_axis()
    if cfg.fm_coupling == "sliced_ot":
        # the rank pairing runs over the whole cloud; this rank's data
        # points take their prior points from the whole cloud's prior
        x0_all = all_gather(x0, 1, points)
        perm = sliced_ot_permutation(draws["u"], all_gather(pts, 1, points),
                                     x0_all[..., :3])
        perm = perm[:, point_block(sp_context.get_grid(), perm.shape[1])]
        x0 = torch.gather(x0_all, 1, perm[..., None].expand(
            -1, -1, x0.shape[-1]))
    x_t, target_v = fm_interpolate(draws["t"], data_pf, x0)

    if cfg.enc_in_channels == 6:
        rgb_in = rgb if rgb is not None else torch.zeros_like(pts)
        enc_in = torch.cat([pts, rgb_in * color_on], dim=-1)
    else:
        enc_in = pts
    z, _ = bundle.enc(enc_in)
    cond_full = z if cond is None else torch.cat([z, cond.to(z.dtype)], 1)
    pred_v = bundle.pf(x_t, draws["t"], cond_full, draws["drop"][:, None])

    if cfg.pf_point_dim == 6:
        loss_pos = mse(pred_v[..., :3], target_v[..., :3])
        loss_col = mse(pred_v[..., 3:], target_v[..., 3:])
        # warmup: colour loss excluded (color_on = 0)
        loss_point = loss_pos + cfg.lambda_color * color_on * loss_col
    else:
        loss_pos = mse(pred_v, target_v)
        loss_col = torch.zeros((), device=pts.device)
        loss_point = loss_pos

    # latent flow on detached z (train.py:635-645)
    z_det = z.detach()
    y_t, target_vz = fm_interpolate(draws["t_z"], z_det, draws["eps_z"])
    loss_latent = mse(bundle.lf(y_t, draws["t_z"], None), target_vz)

    loss = cfg.lambda_point * loss_point + cfg.lambda_latent * loss_latent
    metrics = {"loss_point": loss_point, "loss_latent": loss_latent,
               "loss_pos": loss_pos, "loss_col": loss_col}
    if cfg.lambda_emd > 0:
        # endpoint EMD: the one-step extrapolation to t = 1 under the
        # predicted field against the data cloud as a measure (dense
        # approxmatch, analytic VJP); xyz only, fp32
        tb = draws["t"].reshape(bsz, 1, 1).to(torch.float32)
        x1_hat = (x_t[..., :3].to(torch.float32)
                  + (1.0 - tb) * pred_v[..., :3].to(torch.float32))
        metrics["loss_emd"] = torch.mean(earth_mover_distance(
            all_gather(x1_hat, 1, points), all_gather(pts, 1, points)))
        loss = loss + cfg.lambda_emd * metrics["loss_emd"]
    if cfg.lambda_zreg > 0:
        metrics["loss_zreg"] = torch.mean(z ** 2)
        loss = loss + cfg.lambda_zreg * metrics["loss_zreg"]
    # the global batch's codes (this rank's block is z)
    z_all = all_gather(z, 0, sp_context.data_axis()) \
        if cfg.lambda_var > 0 or cfg.lambda_cov > 0 else None
    if cfg.lambda_var > 0:
        std = torch.sqrt(torch.var(z_all, dim=0, unbiased=False) + 1e-4)
        metrics["loss_var"] = torch.mean(torch.relu(1.0 - std))
        loss = loss + cfg.lambda_var * metrics["loss_var"]
    if cfg.lambda_cov > 0:
        zc = z_all - z_all.mean(dim=0, keepdim=True)
        cov = (zc.T @ zc) / max(1, z_all.shape[0] - 1)
        off = cov - torch.diag(torch.diag(cov))
        metrics["loss_cov"] = torch.sum(off ** 2) / z.shape[-1]
        loss = loss + cfg.lambda_cov * metrics["loss_cov"]
    if cfg.lambda_pair > 0:
        # a second random subsample of the same clouds must encode alike
        # (idx2 indexes the whole cloud; this rank holds its points' draws)
        idx2 = draws["idx2"][..., None].expand(-1, -1, enc_in.shape[-1])
        z2, _ = bundle.enc(torch.gather(all_gather(enc_in, 1, points), 1,
                                        idx2))
        metrics["loss_pair"] = mse(z, z2)
        loss = loss + cfg.lambda_pair * metrics["loss_pair"]
    if bundle.adv is not None and cond is not None:
        # the adversary learns cond from z; z gets the reversed gradient
        metrics["loss_adv"] = mse(bundle.adv(grad_reverse(z, cfg.lambda_adv)),
                                  cond)
        loss = loss + metrics["loss_adv"]
    metrics["loss"] = loss
    return loss, metrics


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], color_on: float,
               drop_p_now: float,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step in place on ``state``.  Returns the metrics as
    0-d device tensors (no host sync): the losses and the pre-clip
    ``grad_norm``."""
    if draws is None:
        draws = make_draws(state.bundle.cfg, batch, generator, drop_p_now)
    state.opt.zero_grad(set_to_none=True)
    loss, metrics = compute_loss(state.bundle, batch, shard_draws(draws),
                                 color_on)
    loss.backward()
    names = sorted(metrics)
    world = sp_context.world_axis()
    values = torch.stack([metrics[k].detach().float() for k in names])
    if world is not None:       # the world's mean, every rank's value
        values = reduce_no_grad(values, world) / world.size
    out = dict(zip(names, values.unbind()))
    out["grad_norm"] = state.apply_gradients()
    return out
