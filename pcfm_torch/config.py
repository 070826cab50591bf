"""Structured training configuration — a copy of pcfm/config.py with the
same fields, defaults, properties and JSON round trip, so that the port
imports nothing of the JAX package and both packages read the same
checkpoint ``args``.

One dataclass mirroring the union of the reference's argparse surface
(train.py:87-175) PLUS the flags that its README/docstring commands use but
never register (--partnet_cond_policy, --partnet_report_file_*,
--lambda_pair/var/cov/zreg/adv — SURVEY.md §5 'Config / flag system').
Policy for the vestigial VICReg-style lambdas: lambda_zreg and lambda_adv
are actually wired into the loss here (trivial and clearly intended);
lambda_pair/var/cov are accepted and wired as standard VICReg variance /
covariance / pair-consistency penalties on z (the reference documents them
but never implements them — we implement the documented intent).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Config:
    # ========== Data ==========
    dataset_type: str = "partnet_h5"      # partnet_h5 | tdcr_h5 | synthetic
    data_dir: str = ""
    batch_size: int = 8
    num_workers: int = 8
    tr_max_sample_points: int = 2048
    te_max_sample_points: int = 2048
    tdcr_use_norm: bool = True
    train_fraction: float = 1.0
    train_count: Optional[int] = None
    train_subset_seed: int = 0
    keep_anno: List[str] = field(default_factory=list)
    keep_anno_file: str = ""
    keep_anno_splits: List[str] = field(default_factory=lambda: ["train"])
    partnet_cond_policy: str = "mode"     # mode | max
    partnet_exclude_outliers: bool = False
    partnet_report_file_train: str = ""
    partnet_report_file_eval: str = ""
    # TDCR conditioning (condition.py)
    cond_mode: str = "motors"
    motor_enc: str = "raw6+geom"
    motor_mod2_offset_deg: float = 0.0
    motor_mod3_offset_deg: float = 0.0
    motor_max_pos: float = 0.4

    # ========== Backbone & Models ==========
    pf_backbone: str = "mlp"              # mlp | hybrid
    latent_dim: int = 256
    enc_width: int = 128
    enc_depth: int = 4
    pf_width: int = 512
    pf_depth: int = 6
    pf_emb_dim: int = 256
    cfg_drop_p: float = 0.1
    lf_width: int = 512
    lf_depth: int = 6
    lf_emb_dim: int = 256
    # Hybrid ContextNet
    ctx_dim: int = 64
    ctx_emb_dim: int = 256
    ctx_stage_channels: List[int] = field(default_factory=lambda: [128, 256, 256])
    ctx_stage_blocks: List[int] = field(default_factory=lambda: [2, 2, 2])
    ctx_stage_res: List[int] = field(default_factory=lambda: [32, 16, 8])
    ctx_with_se: bool = True
    ctx_norm: str = "group"               # group | batch | syncbn | none
    ctx_gn_groups: int = 32
    ctx_with_global: bool = True
    ctx_voxel_normalize: bool = True
    ctx_t_gate_tau: float = 0.8
    ctx_t_gate_k: float = 10.0
    # color switches
    use_rgb_in_latent: bool = True
    pointflow_rgb: bool = True

    # ========== Training ==========
    epochs: int = 300
    lr_enc: float = 3e-4
    lr_pf: float = 3e-4
    lr_lf: float = 3e-4
    min_lr: float = 1e-6
    use_cosine_lr: bool = True
    warmup_steps: int = 1000
    weight_decay: float = 1e-4
    grad_clip_norm: float = 1.0
    t_beta_a: float = 2.0
    # FM prior->data coupling (beyond-reference, opt-in): "indep" is the
    # reference's i.i.d. pairing; "sliced_ot" rank-pairs prior and data
    # points along a fresh random projection each step (the 1-D monotone
    # rearrangement is the exact OT map in the projected space) —
    # marginals unchanged, straighter point trajectories, aimed at the
    # finite-NFE density mismatch the EMD suite metrics expose.
    fm_coupling: str = "indep"            # indep | sliced_ot
    geom_warmup_epochs: int = 200
    cfg_drop_warmup_epochs: int = 100

    # ========== FM priors ==========
    point_prior_std: float = 1.0
    latent_prior_std: float = 1.0
    color_prior: str = "gauss"            # gauss | uniform | zeros
    color_prior_std: float = 1.0

    # ========== Sampling / CFG / EMA ==========
    sample_steps: int = 50
    # eval-time latent-flow NFE override (0 = sample_steps).  The latent
    # flow is a 64-dim ODE — its integration error is a DIVERSITY knob
    # (the z distribution feeding the point flow), decoupled here from the
    # point flow's step count so the two can be swept independently
    # (beyond-reference; the reference shares one step count).
    latent_sample_steps: int = 0
    sampler: str = "heun"                 # euler | midpoint | heun | rk4 | dopri5
    guidance_scale: float = 0.0
    # density-uniformizing eval recipe (beyond-reference, opt-in): sample
    # ceil(k*N) points per cloud and FPS-subsample back to N.  The EMD-
    # variant suite metrics penalize LOCAL density mismatch that CD barely
    # sees (run7: 1-NNA-EMD 0.79 vs the 0.43 oracle floor while CD sat at
    # 0.63); FPS keeps the generated surface but equalizes density.
    eval_oversample: float = 1.0
    ema_decay: float = 0.999
    ema_eval: bool = True

    # ========== Loss ==========
    lambda_point: float = 1.0
    lambda_latent: float = 1.0
    lambda_color: float = 1.0
    # density-aware endpoint-EMD loss (beyond-reference, opt-in — r5,
    # aimed at the EMD-variant suite gap): approxmatch EMD between the
    # one-step endpoint extrapolation x1_hat = x_t + (1-t) v_pred and the
    # data cloud, backpropagated through the ANALYTIC matchcostgrad VJP
    # (pcfm/ops/emd.py; the reference treats EMD as eval-only).  MSE sees
    # points index-paired to the prior; EMD sees the cloud as a measure —
    # it penalizes exactly the local point-density mismatch the 1-NNA-EMD
    # metric exposes.  Typical use: a short fine-tune phase on a trained
    # state (lambda_emd 0.1-1.0).
    lambda_emd: float = 0.0
    # documented-but-unregistered reference flags, wired here:
    lambda_pair: float = 0.0
    lambda_var: float = 0.0
    lambda_cov: float = 0.0
    lambda_zreg: float = 0.0
    lambda_adv: float = 0.0

    # ========== System / I/O ==========
    loader_backend: str = "thread"        # thread | grain (pcfm/data/grain_loader.py)
    out_dir: str = "./runs/hybrid"
    save_every: int = 10
    keep_last_ckpts: int = 0              # GC to newest K checkpoints (0=all)
    async_save: bool = True               # background orbax serialization
    vis_count: int = 8
    seed: int = 123
    amp: bool = True                      # bf16 compute (fp32 params)
    use_bf16: bool = True
    voxel_backend: str = "auto"           # auto|xla|sorted (pvconv path)
    grid_bn: str = "auto"                 # auto|flax|flat|flat_bf16 —
    #   voxel-grid BN impl; auto follows pcfm.nn.pvconv.BN_IMPL (flat_bf16:
    #   native-layout stats + bf16 normalize in the bf16 island; identical
    #   params/stats tree, equality-tested in tests/test_nn.py)
    fused_trunk: str = "auto"             # auto|on|off (pallas film_block)
    pf_film_every: int = 1                # opt-in turbo trunk: FiLM every
                                          # k-th block (1 = reference parity)
    ctx_dtype: str = "bf16"               # bf16|fp32 ContextNet island (PARITY.md)
    # ========== TPU parallelism ==========
    dp: int = -1                          # data-parallel size (-1: all devices)
    sp: int = 1                           # point-axis (sequence) parallel size
    donate: bool = True
    flat_optimizer: bool = True           # fused raveled AdamW (flat_opt.py)
    # ========== Observability ==========
    profile_dir: str = ""                 # write a jax.profiler trace of a few steps
    profile_steps: int = 5
    log_every: int = 50                   # step-metric print cadence (rank 0)
    tensorboard: bool = False             # TB event files in {out_dir}/tb (pcfm/utils/tb.py)

    # ---- derived at runtime (set by the data layer, like the reference
    # writes back onto args — datasets.py:694-696,713-714) ----
    cond_dim: int = 0
    has_rgb: bool = False

    @property
    def enc_in_channels(self) -> int:
        return 6 if (self.use_rgb_in_latent and self.has_rgb) else 3

    @property
    def pf_point_dim(self) -> int:
        return 6 if (self.pointflow_rgb and self.has_rgb) else 3

    @property
    def pf_cond_dim(self) -> int:
        return self.latent_dim + self.cond_dim

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        d = json.loads(s)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
