"""The port's reference-checkpoint importer (pcfm_torch.interop) against
the JAX package's (pcfm.interop), case for case with tests/test_interop.py:
the same reference-format ``hybrid_epNNNN.pt`` (from the torch mirrors)
goes through both importers, and the port's imported run must give the
mirror's and the JAX package's outputs: forward passes at FWD_ATOL, whole
generations on the same priors at SLICE_ATOL, the global step, the EMA
shadow and the fp32 ContextNet island on both sides.  The hybrid
forward-parity cases are in tests/test_torch_port_interop_hybrid.py."""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm import interop as jinterop  # noqa: E402
from pcfm.sample import make_latent_prior as jax_latent_prior  # noqa: E402
from pcfm.sample import make_pf_prior as jax_pf_prior  # noqa: E402
from pcfm.train.evaluate import make_sample_fn as jax_sample_fn  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.sample.cli import load_run  # noqa: E402
from pcfm_torch.train import checkpoint  # noqa: E402
from pcfm_torch.train.evaluate import eval_mode, make_sample_fn  # noqa: E402
from tests import torch_mirror as tm  # noqa: E402
from tests import torch_mirror_hybrid as tmh  # noqa: E402
from tests.test_interop import (_make_mlp_ckpt, _mlp_args,  # noqa: E402
                                _randomize_bn_stats, ref_sd_from_hybrid)

FWD_ATOL = 1e-5
SLICE_ATOL = 1e-4          # tests/test_torch_port_sample.py


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _import(tmp_path, ckpt, name="ref", **over):
    """Save ``ckpt`` as a reference .pt and import it into a port run on
    the CPU; returns (.pt path, run dir, cfg, bundle)."""
    pt = str(tmp_path / f"{name}.pt")
    torch.save(ckpt, pt)
    out = str(tmp_path / f"{name}_run")
    interop.import_reference_checkpoint(pt, out, device="cpu", **over)
    cfg, bundle, ep = load_run(out, device="cpu")
    assert ep == int(ckpt.get("epoch", 0))
    return pt, out, cfg, bundle


# ------------------------------------------------------------- mlp path

def test_import_mlp_forward_parity(tmp_path):
    args = _mlp_args()
    ckpt, enc_t, pf_t, lf_t = _make_mlp_ckpt(args)
    cfg = interop.config_from_reference_args(ckpt["args"],
                                             cond_dim=ckpt["cond_dim"])
    assert not hasattr(cfg, "extra_reference_only_flag")
    _, out, cfg, bundle = _import(tmp_path, ckpt)
    assert cfg.ctx_dtype == "fp32" and cfg.out_dir == out
    saved = torch.load(checkpoint.find_latest(out)[0], weights_only=True)
    assert saved["global_step"] == 421 and saved["epoch"] == 7
    jcfg = jinterop.config_from_reference_args(ckpt["args"],
                                               cond_dim=ckpt["cond_dim"])
    jb, jst, _ = jinterop.state_from_reference_ckpt(ckpt, jcfg)
    assert int(jst.step) == 421

    rng = np.random.RandomState(0)
    x = rng.randn(2, 19, cfg.pf_point_dim).astype(np.float32)
    t = rng.rand(2).astype(np.float32)
    c = rng.randn(2, cfg.pf_cond_dim).astype(np.float32)
    with torch.no_grad(), eval_mode(bundle.pf):
        got = bundle.pf(_t(x), _t(t), _t(c)).numpy()
        want = pf_t(_t(x), _t(t), _t(c)).numpy()
    jgot, _ = jb.apply_pf(jst.params["pf"], {}, jnp.asarray(x),
                          jnp.asarray(t), jnp.asarray(c), None, train=False)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=FWD_ATOL)

    pts = rng.randn(2, 33, cfg.enc_in_channels).astype(np.float32)
    with torch.no_grad():
        got_z = bundle.enc(_t(pts))[0].numpy()
        want_z = enc_t(_t(pts))[0].numpy()
    jz, _, _ = jb.apply_enc(jst.params["enc"], {}, jnp.asarray(pts),
                            train=False)
    np.testing.assert_allclose(got_z, want_z, atol=FWD_ATOL)
    np.testing.assert_allclose(got_z, np.asarray(jz), atol=FWD_ATOL)

    y = rng.randn(2, cfg.latent_dim).astype(np.float32)
    with torch.no_grad():
        got_v = bundle.lf(_t(y), _t(t)).numpy()
        want_v = lf_t(_t(y), _t(t)).numpy()
    jv = jb.apply_lf(jst.params["lf"], jnp.asarray(y), jnp.asarray(t))
    np.testing.assert_allclose(got_v, want_v, atol=FWD_ATOL)
    np.testing.assert_allclose(got_v, np.asarray(jv), atol=FWD_ATOL)

    # the EMA shadow (0.5 x the live weights) landed in the EMA module,
    # as in the JAX package's ema subtree
    torch.testing.assert_close(bundle.ema_pf.input.weight,
                               0.5 * bundle.pf.input.weight, rtol=0, atol=0)
    np.testing.assert_allclose(
        bundle.ema_pf.input.weight.detach().numpy().T,
        np.asarray(jst.ema_pf["params"]["input"]["kernel"]), atol=0)


def _jax_generation(jcfg, jb, jst, key, b, n, cond):
    """JAX's generation on its own priors (make_sample_fn), and the priors
    it drew (pcfm/train/evaluate.py:93-109), for the port."""
    want = np.asarray(jax_sample_fn(jb)(jst, None if cond is None else
                                        jnp.asarray(cond), key, b, n))
    k_z, k_x = jax.random.split(key)
    z0 = jax_latent_prior(k_z, b, jcfg.latent_dim, jcfg.latent_prior_std)
    x0 = jax_pf_prior(k_x, (b, n, jcfg.pf_point_dim), jcfg.point_prior_std,
                      jcfg.color_prior, jcfg.color_prior_std)
    return want, _t(z0), _t(x0)


def test_import_cli_roundtrip(tmp_path):
    """``python -m pcfm_torch.interop`` and ``python -m pcfm.interop`` on
    one reference .pt: the two runs generate the same clouds from the same
    priors, with the same step, epoch and EMA."""
    from pcfm.interop.__main__ import main as jax_interop_main
    from pcfm.sample.cli import load_run as jax_load_run

    args = dict(_mlp_args(), sampler="heun", sample_steps=3,
                latent_sample_steps=2, guidance_scale=0.5)
    ckpt, _, pf_t, _ = _make_mlp_ckpt(args, seed=1)
    pt = str(tmp_path / "hybrid_ep0007.pt")
    torch.save(ckpt, pt)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        interop.main([pt, "--out_dir", port_dir, "--device", "cpu"])
        jax_interop_main([pt, "--out_dir", jax_dir])
    assert "ctx_dtype=fp32" in log.getvalue()

    path, epoch = checkpoint.find_latest(port_dir)
    assert epoch == 7
    saved = torch.load(path, weights_only=True)
    assert saved["global_step"] == 421 and "opt" not in saved   # opt {}
    cfg, bundle, _ = load_run(port_dir, device="cpu")
    jcfg, jb, jst, jep = jax_load_run(jax_dir)
    assert jep == 7 and int(jst.step) == 421
    assert cfg.ctx_dtype == jcfg.ctx_dtype == "fp32"
    want = pf_t.state_dict()["input.weight"]
    torch.testing.assert_close(bundle.pf.input.weight.detach(), want,
                               rtol=0, atol=0)
    np.testing.assert_allclose(
        np.asarray(jst.params["pf"]["input"]["kernel"]), want.numpy().T,
        atol=0)

    b, n = 2, 40
    cond = np.random.RandomState(2).randn(b, cfg.cond_dim).astype(
        np.float32)
    want, z0, x0 = _jax_generation(jcfg, jb, jst, jax.random.PRNGKey(3), b,
                                   n, cond)
    got = make_sample_fn(bundle)(_t(cond), None, b, n, z0=z0, x0=x0)
    np.testing.assert_allclose(got.numpy(), want, atol=SLICE_ATOL)
    # the EMA (0.5 x live) was sampled: the live weights differ
    live = make_sample_fn(bundle, use_ema=False)(_t(cond), None, b, n,
                                                 z0=z0, x0=x0)
    assert float((live - got).abs().max()) > 1e-3


# ------------------------------------------------------------ hybrid path

HYB_CTX = dict(emb_dim=16, ctx_dim=8, stage_channels=(16,),
               stage_blocks=(1,), stage_res=(4,), with_se=True, gn_groups=4,
               with_global=True, t_gate_k=10.0, t_gate_tau=0.8)


def _hybrid_ckpt(seed, norm="group", blocks=1, with_global=True,
                 ema_scale=1.0):
    """A reference-format hybrid checkpoint from the mirrors: its EMA holds
    the float entries only, as the reference's EMA saves them.  Returns
    (ckpt, the HybridMLP mirror, the encoder's, the latent net's)."""
    torch.manual_seed(seed)
    cond_dim, pd, depth, latent = 3, 6, 3, 8
    ctx_kw = dict(HYB_CTX, stage_blocks=(blocks,), with_global=with_global,
                  **({"norm": norm} if norm != "group" else {}))
    head_kw = dict(ctx_dim=8, width=32, depth=depth, emb_dim=16)
    net_t = tmh.HybridMLPT(latent + cond_dim, pd, ctx_kw, head_kw).eval()
    _randomize_bn_stats(net_t, seed=seed)
    enc_t = tm.ShapeEncoderT(latent, 16, 4, 6).eval()
    lf_t = tm.LatentVelocityNetT(latent, 0, 24, 3, 16).eval()
    args = dict(pf_backbone="hybrid", latent_dim=latent, enc_width=16,
                enc_depth=4, pf_width=32, pf_depth=depth, pf_emb_dim=16,
                lf_width=24, lf_depth=3, lf_emb_dim=16, ctx_dim=8,
                ctx_emb_dim=16, ctx_stage_channels=[16],
                ctx_stage_blocks=[blocks], ctx_stage_res=[4],
                ctx_with_se=True, ctx_norm=norm, ctx_gn_groups=4,
                ctx_with_global=with_global, ctx_t_gate_k=10.0,
                ctx_t_gate_tau=0.8, amp=False, use_bf16=False, has_rgb=True,
                cond_dim=cond_dim, use_rgb_in_latent=True,
                pointflow_rgb=True, voxel_backend="xla")
    pf_sd = ref_sd_from_hybrid(net_t)
    ckpt = {"epoch": 2, "global_step": 55, "encoder": enc_t.state_dict(),
            "pf": pf_sd, "lf": lf_t.state_dict(),
            "ema_pf": {k: v.float() * ema_scale for k, v in pf_sd.items()
                       if v.dtype.is_floating_point},
            "ema_lf": lf_t.state_dict(), "args": args,
            "cond_dim": cond_dim}
    return ckpt, net_t, enc_t, lf_t


def test_import_shape_mismatch_raises(tmp_path):
    args = _mlp_args()
    ckpt, *_ = _make_mlp_ckpt(args, seed=2)
    ckpt["args"] = dict(args, pf_width=64)  # config disagrees with tensors
    pt = str(tmp_path / "bad.pt")
    torch.save(ckpt, pt)
    with pytest.raises(ValueError, match="shape|mismatch"):
        interop.import_reference_checkpoint(pt, str(tmp_path / "run"),
                                            device="cpu")
    assert checkpoint.find_latest(str(tmp_path / "run"))[0] is None


def test_import_ddp_prefixed_and_legacy_keys(tmp_path):
    """state_dicts exported from a live DDP wrapper carry a uniform
    'module.' prefix and old checkpoints name the point flow ``model``:
    the importer, and a direct ``checkpoint.load``, read both."""
    args = _mlp_args()
    ckpt, _, pf_t, _ = _make_mlp_ckpt(args, seed=3)
    for key in ("encoder", "pf", "lf", "ema_pf", "ema_lf"):
        ckpt[key] = {f"module.{k}": v for k, v in ckpt[key].items()}
    ckpt["model"] = ckpt.pop("pf")
    pt, _, _, bundle = _import(tmp_path, ckpt)
    want = pf_t.state_dict()
    torch.testing.assert_close(bundle.pf.state_dict(), want, rtol=0, atol=0)
    cfg, direct, _ = checkpoint.load(pt, "cpu")
    assert cfg.ctx_dtype == "fp32"
    for key, module in bundle.modules().items():
        torch.testing.assert_close(direct.modules()[key].state_dict(),
                                   module.state_dict(), rtol=0, atol=0)
    jcfg = jinterop.config_from_reference_args(args,
                                               cond_dim=args["cond_dim"])
    ckpt["pf"] = ckpt.pop("model")        # the JAX importer: prefix only
    _, jst, _ = jinterop.state_from_reference_ckpt(ckpt, jcfg)
    np.testing.assert_allclose(
        np.asarray(jst.params["pf"]["input"]["kernel"]),
        want["input.weight"].numpy().T, atol=0)


BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _reference_adamw(ckpt, orders, seed):
    """A reference AdamW state_dict (groups enc / pf / lf over every
    parameter, the dead conv biases too, train.py:249-253): each group's
    ids in ``orders[group]``, the reference module's ``parameters()``
    order, with random moments.  Returns it and {(group, name): (exp_avg,
    exp_avg_sq)}."""
    g = torch.Generator().manual_seed(seed)
    state, groups, by_name = {}, [], {}
    for grp, key in (("enc", "encoder"), ("pf", "pf"), ("lf", "lf")):
        ids = []
        for name in orders[grp]:
            shape = ckpt[key][name].shape
            m = torch.randn(shape, generator=g)
            v = torch.rand(shape, generator=g)
            by_name[(grp, name)] = (m, v)
            ids.append(len(state))
            state[len(state)] = {"step": torch.tensor(55.0), "exp_avg": m,
                                 "exp_avg_sq": v}
        groups.append({"params": ids, "lr": 1e-3})
    return {"state": state, "param_groups": groups}, by_name


@pytest.mark.parametrize("pf_order", ["reference", "reversed"])
def test_import_carries_a_fitting_optimizer_state(tmp_path, pf_order):
    """A reference AdamW state is carried, each moment to the parameter of
    its name, without the dead conv biases' moments; one that does not
    fit is left out.  The ids follow the reference modules' own parameter
    order (the encoder and latent mirrors', the reference HybridMLP's
    state_dict order); "reversed" is a reference whose point flow
    registers its parameters the other way round, its state_dict and
    optimizer group alike."""
    from pcfm_torch.train.state import init_state

    ckpt, _, enc_t, lf_t = _hybrid_ckpt(4)
    pf_names = [k for k in ckpt["pf"] if not k.endswith(BN_BUFFERS)]
    if pf_order == "reversed":
        ckpt["pf"] = dict(reversed(list(ckpt["pf"].items())))
        pf_names = pf_names[::-1]
    orders = {"enc": [n for n, _ in enc_t.named_parameters()],
              "pf": pf_names, "lf": [n for n, _ in lf_t.named_parameters()]}
    ckpt["opt"], want = _reference_adamw(ckpt, orders, seed=0)
    _, out, cfg, _ = _import(tmp_path, ckpt, name="with_opt")
    st = init_state(cfg, "cpu", 10, torch.Generator().manual_seed(1))
    with contextlib.redirect_stdout(io.StringIO()) as log:
        checkpoint.auto_resume(out, st)
    assert "RESET" not in log.getvalue() and st.step == 55
    live = {id(p) for p in st.trainable()}
    checked = 0
    for grp, module in (("enc", st.bundle.enc), ("pf", st.bundle.pf),
                        ("lf", st.bundle.lf)):
        for name, p in module.named_parameters():
            if id(p) not in live:
                assert p not in st.opt.state       # a dead conv bias
                continue
            m, v = want[(grp, name)]
            torch.testing.assert_close(st.opt.state[p]["exp_avg"], m,
                                       rtol=0, atol=0)
            torch.testing.assert_close(st.opt.state[p]["exp_avg_sq"], v,
                                       rtol=0, atol=0)
            assert float(st.opt.state[p]["step"]) == 55.0
            checked += 1
    assert checked == len(live) < len(want)
    # a state that does not fit (a group short) is not carried
    ckpt["opt"]["param_groups"][1]["params"].pop()
    _, out, _, _ = _import(tmp_path, ckpt, name="short")
    assert "opt" not in torch.load(checkpoint.find_latest(out)[0],
                                   weights_only=True)
