#!/usr/bin/env python
"""Training-dynamics parity of the PyTorch port against the JAX package.

Both frameworks train the same architecture on the CPU in fp32, from the
same weights (the JAX initialisation carried into the port through
``pcfm_torch.interop``), on identical batches (the port's copy of the
host loader, which yields the JAX loader's batches), with identical draws
at every step: t, the priors and the CFG mask are rebuilt for the port
from the JAX step's own key splits (pcfm/train/step.py:73-106).  The two
runs then differ by rounding alone, so the early losses agree to
rounding and the late ones statistically.  After training, both
reconstruct the train split's test points with Euler x ``sample_steps``
from the EMA weights, from the same prior.

Knobs and defaults are those of scripts/dyn_parity.py (which holds the
JAX package against the reference recipe's torch mirrors).  Writes the
per-step and per-epoch loss curves, the late-window relative differences,
the first steps' largest relative difference and both recon CDs to
``--out_json``.  The test suite runs it small
(tests/test_torch_port_dynamics.py):

    python scripts/torch_dyn_parity.py --backbone mlp \
        --out_json docs/torch_quality/dyn_parity_mlp.json
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# the JAX side's ContextNet (scripts/dyn_parity.py's CTX_KW)
CTX_KW = dict(emb_dim=32, ctx_dim=8, stage_channels=(16, 16),
              stage_blocks=(1, 1), stage_res=(8, 4), with_se=True,
              gn_groups=4, with_global=True, t_gate_k=10.0, t_gate_tau=0.8)
FIRST_STEPS = 20          # steps whose losses agree to rounding
LATE_EPOCHS = 5           # the late window of the epoch curves


def _rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-9)


def config_kwargs(epochs, batch, latent, enc_width, pf_width, lf_width, emb,
                  seed, sample_steps, backbone):
    """The Config of scripts/dyn_parity.py, for either package."""
    hybrid = {}
    if backbone == "hybrid":
        hybrid = dict(ctx_dim=CTX_KW["ctx_dim"], ctx_emb_dim=emb,
                      ctx_stage_channels=list(CTX_KW["stage_channels"]),
                      ctx_stage_blocks=list(CTX_KW["stage_blocks"]),
                      ctx_stage_res=list(CTX_KW["stage_res"]),
                      ctx_with_se=True, ctx_norm="group",
                      ctx_gn_groups=CTX_KW["gn_groups"],
                      ctx_with_global=True,
                      ctx_t_gate_k=CTX_KW["t_gate_k"],
                      ctx_t_gate_tau=CTX_KW["t_gate_tau"],
                      ctx_dtype="fp32", voxel_backend="xla")
    return dict(dataset_type="synthetic", pf_backbone=backbone,
                latent_dim=latent, enc_width=enc_width, enc_depth=4,
                pf_width=pf_width, pf_depth=3, pf_emb_dim=emb,
                lf_width=lf_width, lf_depth=3, lf_emb_dim=emb,
                warmup_steps=20, amp=False, epochs=epochs,
                batch_size=batch, cfg_drop_p=0.0, geom_warmup_epochs=0,
                pointflow_rgb=False, use_rgb_in_latent=False,
                has_rgb=False, cond_dim=1, seed=seed,
                sampler="euler", sample_steps=sample_steps, t_beta_a=2.0,
                **hybrid)


def jax_step_draws(cfg, key, bsz, n, drop_p):
    """The JAX step's draws for an xyz-only batch, from its key splits
    (pcfm/train/step.py:73-106), as the port's ``draws``."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    k_t, k_prior, k_tz, k_priorz, k_drop, _ = jax.random.split(key, 6)
    d = {"t": jax.random.beta(k_t, cfg.t_beta_a, 1.0, (bsz,)).astype(
             jnp.float32),
         "x0": jax.random.normal(k_prior, (bsz, n, 3)) * cfg.point_prior_std,
         "drop": (jax.random.uniform(k_drop, (bsz,)) < drop_p).astype(
             jnp.float32),
         "t_z": jax.random.beta(k_tz, cfg.t_beta_a, 1.0, (bsz,)).astype(
             jnp.float32),
         "eps_z": jax.random.normal(k_priorz, (bsz, cfg.latent_dim))
         * cfg.latent_prior_std}
    return {k: torch.from_numpy(np.asarray(v, np.float32).copy())
            for k, v in d.items()}


def carry_weights(jst, st, backbone):
    """The JAX state's parameters into the port's live modules and EMA."""
    import jax

    from pcfm_torch import interop
    params = jax.device_get(jst.params)
    st.bundle.enc.load_state_dict(interop.shape_encoder_to_sd(params["enc"]))
    st.bundle.lf.load_state_dict(interop.latent_net_to_sd(params["lf"]))
    if backbone == "hybrid":
        stats = jax.device_get(jst.batch_stats).get("pf", {})
        st.bundle.pf.load_state_dict(interop.hybrid_to_sd(
            params["pf"], {"ctx_net": stats.get("ctx_net", {})}))
    else:
        st.bundle.pf.load_state_dict(interop.velocity_net_to_sd(params["pf"]))
    st.bundle.ema_pf.load_state_dict(st.bundle.pf.state_dict())
    st.bundle.ema_lf.load_state_dict(st.bundle.lf.state_dict())


def run(epochs=80, size=64, n_points=256, batch=8, latent=32, enc_width=32,
        pf_width=64, lf_width=64, emb=32, seed=3, sample_steps=16,
        out_json=None, verbose=True, backbone="mlp"):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from pcfm.config import Config as JaxConfig
    from pcfm.sample.priors import make_pf_prior
    from pcfm.train.evaluate import make_recon_fn as jax_recon_fn
    from pcfm.train.state import init_state as jax_init_state
    from pcfm.train.step import make_train_step
    from pcfm_torch.config import Config
    from pcfm_torch.data.loader import DataLoader
    from pcfm_torch.data.synthetic import SyntheticDataset
    from pcfm_torch.ops.chamfer import chamfer_l2
    from pcfm_torch.quality.common import dump_json
    from pcfm_torch.train.evaluate import make_recon_fn
    from pcfm_torch.train.state import init_state
    from pcfm_torch.train.step import train_step

    ds = SyntheticDataset(split="train", size=size,
                          n_points=max(512, n_points),
                          tr_sample_size=n_points, te_sample_size=n_points,
                          with_rgb=False, with_cond=True, seed=0)
    loader = DataLoader(ds, batch, shuffle=True, drop_last=True, seed=seed,
                        num_workers=0)
    kw = config_kwargs(epochs, batch, latent, enc_width, pf_width, lf_width,
                       emb, seed, sample_steps, backbone)
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    total = epochs * len(loader)
    jb, jst, tx = jax_init_state(jcfg, jax.random.PRNGKey(seed), total)
    jstep = make_train_step(jb, tx, donate=False)
    st = init_state(cfg, "cpu", total, torch.Generator().manual_seed(seed))
    carry_weights(jst, st, backbone)

    names = ("loss_point", "loss_latent")
    steps = {"pcfm": {k: [] for k in names},
             "pcfm_torch": {k: [] for k in names}}
    seconds = {"pcfm": 0.0, "pcfm_torch": 0.0}
    gkey = jax.random.PRNGKey(seed + 17)
    for ep in range(1, epochs + 1):
        for b in loader.epoch_batches(ep):
            pts, cond = b["train_points"], b["cond"]
            gkey, k = jax.random.split(gkey)
            t0 = time.time()
            jst, m = jstep(jst, {"pts": jnp.asarray(pts, jnp.float32),
                                 "cond": jnp.asarray(cond, jnp.float32)},
                           k, jnp.float32(0.0), jnp.float32(0.0))
            for n_ in names:
                steps["pcfm"][n_].append(float(m[n_]))
            t1 = time.time()
            draws = jax_step_draws(cfg, k, pts.shape[0], pts.shape[1], 0.0)
            mt = train_step(st, {"pts": torch.from_numpy(pts),
                                 "cond": torch.from_numpy(cond)},
                            None, 0.0, 0.0, draws=draws)
            for n_ in names:
                steps["pcfm_torch"][n_].append(float(mt[n_]))
            seconds["pcfm"] += t1 - t0
            seconds["pcfm_torch"] += time.time() - t1

    # recon of the test points from the EMA weights, from one prior
    jrecon = jax_recon_fn(jb, use_ema=True)
    recon = make_recon_fn(st.bundle, use_ema=True)
    key = jax.random.PRNGKey(seed + 1)
    cds = {"pcfm": [], "pcfm_torch": []}
    for b in loader.epoch_batches(0):
        pts = b["test_points"].astype(np.float32)
        cond = b["cond"].astype(np.float32)
        xj = np.array(jrecon(jst, jnp.asarray(pts), None,
                             jnp.asarray(cond), key))
        x0 = torch.from_numpy(np.asarray(make_pf_prior(
            key, pts.shape, cfg.point_prior_std, cfg.color_prior,
            cfg.color_prior_std)).copy())
        xt = recon(torch.from_numpy(pts), None, torch.from_numpy(cond),
                   x0=x0)
        gt = torch.from_numpy(pts)
        cds["pcfm"].append(chamfer_l2(torch.from_numpy(xj[..., :3]), gt))
        cds["pcfm_torch"].append(chamfer_l2(xt[..., :3], gt))

    per_epoch = len(loader)
    out = {"config": {"epochs": epochs, "size": size, "n_points": n_points,
                      "batch": batch, "latent": latent,
                      "enc_width": enc_width, "pf_width": pf_width,
                      "lf_width": lf_width, "emb": emb, "seed": seed,
                      "sample_steps": sample_steps, "backbone": backbone,
                      "steps_per_epoch": per_epoch}}
    for side, curves in steps.items():
        ep_curves = {k: [float(np.mean(v[i:i + per_epoch]))
                         for i in range(0, len(v), per_epoch)]
                     for k, v in curves.items()}
        out[side] = {
            "loss_point": ep_curves["loss_point"],
            "loss_latent": ep_curves["loss_latent"],
            "step_loss_point": curves["loss_point"],
            "step_loss_latent": curves["loss_latent"],
            "lp_last5": float(np.mean(ep_curves["loss_point"][-LATE_EPOCHS:])),
            "ll_last5": float(np.mean(
                ep_curves["loss_latent"][-LATE_EPOCHS:])),
            "recon_cd": float(torch.cat(cds[side]).mean()),
            "seconds": round(seconds[side], 1)}
    a, b = out["pcfm"], out["pcfm_torch"]
    for k in ("lp_last5", "ll_last5", "recon_cd"):
        out[f"rel_diff_{k}"] = round(_rel(a[k], b[k]), 6)
    out["recon_cd_ratio"] = max(a["recon_cd"], b["recon_cd"]) / max(
        1e-9, min(a["recon_cd"], b["recon_cd"]))
    out["first_steps"] = FIRST_STEPS
    out["first_steps_max_rel_diff"] = {
        k: max(_rel(x, y) for x, y in zip(a[f"step_{k}"][:FIRST_STEPS],
                                          b[f"step_{k}"][:FIRST_STEPS]))
        for k in names}
    if out_json:
        os.makedirs(os.path.dirname(os.path.abspath(out_json)),
                    exist_ok=True)
        dump_json(out_json, out)
    if verbose:
        for side in ("pcfm", "pcfm_torch"):
            o = out[side]
            print(f"[{side}] {epochs} ep in {o['seconds']:.0f}s  "
                  f"lp_last={o['lp_last5']:.4f} ll_last={o['ll_last5']:.4f} "
                  f"recon_cd={o['recon_cd']:.4f}", flush=True)
        print({k: v for k, v in out.items()
               if k.startswith(("rel_diff", "first_steps_max"))}, flush=True)
    return out


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--n_points", type=int, default=256)
    ap.add_argument("--out_json", type=str,
                    default="docs/torch_quality/dyn_parity.json")
    ap.add_argument("--backbone", type=str, default="mlp",
                    choices=["mlp", "hybrid"])
    return ap


if __name__ == "__main__":
    a = build_parser().parse_args()
    run(epochs=a.epochs, size=a.size, n_points=a.n_points,
        out_json=a.out_json, backbone=a.backbone)
