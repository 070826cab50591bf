"""The port's training path (pcfm_torch.train, pcfm_torch.ops.chamfer)
against the JAX package, in fp32 on the CPU.

Weights go JAX -> port through pcfm_torch.interop; batches, gradients and
the train step's random draws are numpy arrays handed to both frameworks
(the step's draws are rebuilt from the JAX step's own key splits,
pcfm/train/step.py:73-106,139-140).  The JAX fused trunk runs its Pallas
kernel in interpret mode; the port's runs its plain backward.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from typing import Any, NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.ops import chamfer as jax_chamfer  # noqa: E402
from pcfm.train import state as jax_state  # noqa: E402
from pcfm.train.step import train_step as jax_train_step  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.models import VelocityNet  # noqa: E402
from pcfm_torch.ops import chamfer  # noqa: E402
from pcfm_torch.train import checkpoint, cli, state, step  # noqa: E402

TINY = dict(latent_dim=16, enc_width=32, enc_depth=4, pf_width=128,
            pf_depth=3, pf_emb_dim=32, lf_width=64, lf_depth=3,
            lf_emb_dim=16, amp=False)
TO_SD = {"enc": interop.shape_encoder_to_sd, "pf": interop.velocity_net_to_sd,
         "lf": interop.latent_net_to_sd}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close_to_max(got, want, rel, where=""):
    """|got - want| <= rel * max|want| elementwise."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, where
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0,
                               err_msg=where)


def _cfgs(**kw):
    """The same settings as the port's Config and the JAX package's."""
    return Config(**kw), JaxConfig(**kw)


def _port_state(cfg, jparams, total_steps):
    """A port TrainState holding the JAX params."""
    st = state.init_state(cfg, "cpu", total_steps,
                          torch.Generator().manual_seed(0))
    for name, conv in TO_SD.items():
        sd = conv(jax.device_get(jparams[name]))
        getattr(st.bundle, name).load_state_dict(sd)
    st.bundle.ema_pf.load_state_dict(st.bundle.pf.state_dict())
    st.bundle.ema_lf.load_state_dict(st.bundle.lf.state_dict())
    return st


def _port_named(st):
    """{group: {name: tensor}} of the port's live parameters."""
    return {g: dict(getattr(st.bundle, g).named_parameters())
            for g in TO_SD}


def _jax_as_port(tree):
    """A JAX {enc, pf, lf} tree (params or grads) in port layout."""
    return {g: TO_SD[g](jax.device_get(tree[g])) for g in TO_SD}


# ------------------------------------------------------------ film block

@pytest.mark.parametrize("film_every", [1, 2])
def test_velocity_net_fused_grads_match_plain(film_every):
    # as tests/test_film_block.py:94 for JAX: one set of params through the
    # fused trunk (autograd Function) and the module trunk
    kw = dict(cond_dim=3, width=128, depth=4, emb_dim=32, point_dim=6,
              film_every=film_every)
    gen = torch.Generator().manual_seed(1)
    nets = {f: VelocityNet(fused_trunk=f, **kw, generator=gen)
            for f in ("on", "off")}
    nets["off"].load_state_dict(nets["on"].state_dict())
    rng = np.random.RandomState(2)
    x, t = _t(rng.randn(2, 50, 6)), _t(rng.rand(2))
    c, mask = _t(rng.randn(2, 3)), _t([[1.0], [0.0]])
    grads = {}
    for f, net in nets.items():
        loss = net(x, t, c, mask).square().mean()
        grads[f] = dict(zip([n for n, _ in net.named_parameters()],
                            torch.autograd.grad(loss,
                                                list(net.parameters()))))
    for name, g in grads["off"].items():
        _close_to_max(grads["on"][name], g, 1e-4, name)


# ------------------------------------------------------------ optimizer

def test_cosine_lr_matches_jax():
    # JAX evaluates the schedule in fp32, the port in Python floats
    for s in (0, 1, 2, 5, 50, 99, 100, 150):
        np.testing.assert_allclose(
            state.cosine_lr(s, 100, 3e-4, 1e-6, 5),
            float(jax_state.cosine_lr(s, 100, 3e-4, 1e-6, 5)), rtol=1e-5)


def test_optimizer_matches_jax_flat_adamw():
    """Identical gradients for 4 steps into JAX's flat AdamW and the port's
    AdamW: warmup, three group LRs, a clip that binds, weight decay."""
    cfg, jcfg = _cfgs(**TINY, has_rgb=True, cond_dim=1, warmup_steps=2,
                      grad_clip_norm=0.05, lr_enc=1e-3, lr_pf=3e-4,
                      lr_lf=2e-4, weight_decay=1e-2, use_cosine_lr=True)
    total = 10
    _, jst, tx = jax_state.init_state(jcfg, jax.random.PRNGKey(0), total)
    params, opt_state = jst.params, jst.opt_state
    st = _port_state(cfg, params, total)
    named = _port_named(st)
    rng = np.random.RandomState(3)
    for i in range(4):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*np.shape(p)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for g, sd in _jax_as_port(grads).items():
            for name, v in sd.items():
                named[g][name].grad = v.clone()
        gnorm = st.apply_gradients()
        np.testing.assert_allclose(float(gnorm), float(opt_state.gnorm),
                                   rtol=1e-5)
        assert float(opt_state.gnorm) > 10 * cfg.grad_clip_norm  # binds
    assert st.step == 4
    for g, sd in _jax_as_port(params).items():
        for name, want in sd.items():
            np.testing.assert_allclose(named[g][name].detach().numpy(),
                                       want.numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"{g}/{name}")


def test_ema_update():
    a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    s = {k: v.clone() for k, v in a.state_dict().items()}
    state.ema_update(a, b, 0.9)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(v, s[k] * 0.9 + b.state_dict()[k] * 0.1)


# ------------------------------------------------------------ train step

class _Capture(NamedTuple):
    """Wraps the JAX optimizer state and keeps the raw gradients of the
    last update (train_step hands them to tx.update before any clip when
    the flat optimizer is on)."""
    inner: Any
    grads: Any

    @property
    def gnorm(self):
        return self.inner.gnorm


def _capturing(tx):
    import optax

    def init(params):
        return _Capture(tx.init(params),
                        jax.tree_util.tree_map(jnp.zeros_like, params))

    def update(grads, st, params):
        updates, inner = tx.update(grads, st.inner, params)
        return updates, _Capture(inner, grads)

    return optax.GradientTransformation(init, update)


def _jax_draws(cfg, rng, bsz, n, drop_p):
    """The JAX step's draws, rebuilt from its key splits (RGB path)."""
    k_t, k_prior, k_tz, k_priorz, k_drop, k_pair = jax.random.split(rng, 6)
    kx, kc = jax.random.split(k_prior)
    z_xyz = jax.random.normal(kx, (bsz, n, 3)) * cfg.point_prior_std
    z_rgb = jax.random.normal(kc, (bsz, n, 3)) * cfg.color_prior_std
    beta = lambda k: jax.random.beta(k, cfg.t_beta_a, 1.0,  # noqa: E731
                                     (bsz,)).astype(jnp.float32)
    d = {"t": beta(k_t), "x0": jnp.concatenate([z_xyz, z_rgb], -1),
         "drop": (jax.random.uniform(k_drop, (bsz,)) < drop_p).astype(
             jnp.float32),
         "t_z": beta(k_tz),
         "eps_z": jax.random.normal(k_priorz, (bsz, cfg.latent_dim))
         * cfg.latent_prior_std,
         "idx2": jax.random.randint(k_pair, (bsz, n), 0, n)}
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in d.items()}


@pytest.mark.parametrize("fused", ["on", "off"])
def test_train_step_matches_jax(fused):
    cfg, jcfg = _cfgs(**TINY, has_rgb=True, cond_dim=1, fused_trunk=fused,
                      warmup_steps=0, grad_clip_norm=1.0, lambda_zreg=0.1,
                      lambda_var=0.5, lambda_cov=0.05, lambda_pair=0.2)
    bsz, n, total, drop_p, color_on = 3, 40, 20, 0.5, 1.0
    rng = np.random.RandomState(4)
    batch = {"pts": rng.randn(bsz, n, 3).astype(np.float32) * 0.5,
             "rgb": rng.rand(bsz, n, 3).astype(np.float32),
             "cond": rng.rand(bsz, 1).astype(np.float32)}
    bundle, jst, tx = jax_state.init_state(jcfg, jax.random.PRNGKey(5),
                                           total)
    # move every leaf off its init (zero biases would hide a misplaced one)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.randn(*p.shape), p.dtype),
        jst.params)
    jst = jst.replace(params=params, ema_pf={**jst.ema_pf,
                                             "params": params["pf"]},
                      ema_lf={**jst.ema_lf, "params": params["lf"]})
    st = _port_state(cfg, jst.params, total)
    cap = _capturing(tx)
    jst = jst.replace(opt_state=cap.init(jst.params))
    key = jax.random.PRNGKey(6)
    new_j, m_j = jax.jit(lambda s, b, k: jax_train_step(
        bundle, cap, s, b, k, jnp.float32(color_on), jnp.float32(drop_p)))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    draws = _jax_draws(cfg, key, bsz, n, drop_p)
    assert 0 < float(draws["drop"].sum()) < bsz     # both CFG branches
    m = step.train_step(st, {k: _t(v) for k, v in batch.items()}, None,
                        color_on, drop_p, draws=draws)
    for k in ("loss", "loss_point", "loss_latent", "loss_pos", "loss_col",
              "loss_zreg", "loss_var", "loss_cov", "loss_pair"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-5)

    # the port's .grad holds the clipped gradient: undo the clip
    gn = float(m["grad_norm"])
    scale = cfg.grad_clip_norm / max(gn, cfg.grad_clip_norm)
    named = _port_named(st)
    for g, sd in _jax_as_port(new_j.opt_state.grads).items():
        for name, want in sd.items():
            _close_to_max(named[g][name].grad.numpy() / scale, want.numpy(),
                          1e-4, f"grad {g}/{name}")

    # Adam's first update is ~lr * g / |g|: an element whose gradient sits
    # at rounding level may flip, so most elements to 1e-3 lr, all to 2 lr
    lr = cfg.lr_pf
    diffs = []
    for g, sd in _jax_as_port(new_j.params).items():
        for name, want in sd.items():
            diffs.append((named[g][name].detach() - want).abs().flatten())
    diffs = torch.cat(diffs)
    assert float((diffs <= 1e-3 * lr).float().mean()) >= 0.999
    assert float(diffs.max()) <= 2 * lr
    ema = interop.velocity_net_to_sd(jax.device_get(new_j.ema_pf["params"]))
    for name, want in ema.items():
        got = st.bundle.ema_pf.state_dict()[name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-3 * lr)


def test_draws_shapes_and_beta():
    cfg = Config(**TINY, has_rgb=True, cond_dim=1, t_beta_a=2.0,
                 lambda_pair=1.0, color_prior="uniform")
    gen = torch.Generator().manual_seed(0)
    batch = {"pts": torch.zeros(4000, 5, 3), "rgb": torch.zeros(4000, 5, 3)}
    d = step.make_draws(cfg, batch, gen, 0.25)
    assert d["x0"].shape == (4000, 5, 6) and d["idx2"].shape == (4000, 5)
    assert d["eps_z"].shape == (4000, 16)
    assert 0.0 <= float(d["x0"][..., 3:].min()) and \
        float(d["x0"][..., 3:].max()) <= 1.0             # uniform colour
    # Beta(2, 1): mean 2/3, P(t < 1/2) = 1/4
    np.testing.assert_allclose(float(d["t"].mean()), 2 / 3, atol=0.02)
    np.testing.assert_allclose(float((d["t"] < 0.5).float().mean()), 0.25,
                               atol=0.02)
    np.testing.assert_allclose(float(d["drop"].mean()), 0.25, atol=0.03)


def test_unported_parallelism_raises(tmp_path):
    # the grain backend runs (worker processes,
    # tests/test_torch_port_grain_loader.py) and a backend it does not know
    # is an error; dp / sp run (one process per rank,
    # tests/test_torch_port_parallel.py), and a layout the world cannot
    # hold is an error, not an idle rank
    from pcfm_torch.train.loop import train
    with pytest.raises(ValueError, match="loader_backend 'threads'"):
        train(Config(dataset_type="synthetic", loader_backend="threads",
                     out_dir=str(tmp_path)), verbose=False, device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        cli.main(["--dataset_type", "synthetic", "--dp", "2",
                  "--out_dir", str(tmp_path), "--device", "cpu"])


# ------------------------------------------------------------ chamfer

def test_chamfer_matches_jax():
    rng = np.random.RandomState(7)
    a = rng.randn(2, 300, 3).astype(np.float32)
    b = rng.randn(2, 250, 3).astype(np.float32)
    want = jax_chamfer.chamfer_distance(jnp.asarray(a), jnp.asarray(b),
                                        chunk=128)
    got = chamfer.chamfer_distance(_t(a), _t(b), chunk=128)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-7)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        chamfer.chamfer_l2(_t(a), _t(b)).numpy(),
        np.asarray(jax_chamfer.chamfer_l2(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5)
    for g, w in zip(chamfer.fscore(got[0], got[1], 0.05),
                    jax_chamfer.fscore(want[0], want[1], 0.05)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


# ------------------------------------------------------------ loop and CLI

ARGV = ["--dataset_type", "synthetic", "--batch_size", "16",
        "--tr_max_sample_points", "64", "--te_max_sample_points", "64",
        "--latent_dim", "16", "--enc_width", "32", "--pf_width", "128",
        "--pf_depth", "3", "--pf_emb_dim", "32", "--lf_width", "32",
        "--lf_depth", "3", "--lf_emb_dim", "16", "--warmup_steps", "2",
        "--sample_steps", "2", "--geom_warmup_epochs", "1",
        "--vis_count", "1", "--num_workers", "0", "--fused_trunk", "on",
        "--save_every", "1", "--device", "cpu"]


def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return out, buf.getvalue()


def test_train_cli_runs_resumes_and_loads_into_jax(tmp_path):
    from pcfm.interop.torch_ckpt import (config_from_reference_args,
                                         state_from_reference_ckpt)
    out_dir = str(tmp_path / "run")
    argv = ARGV + ["--out_dir", out_dir, "--keep_last_ckpts", "2"]
    out, log = _run_cli(argv + ["--epochs", "1"])
    assert out["epochs_run"] == 1 and np.isfinite(out["loss"])
    out, log = _run_cli(argv + ["--epochs", "3", "--tensorboard"])
    assert "Resume from epoch 1" in log and "RESET" not in log
    assert out["epochs_run"] == 2 and np.isfinite(out["loss"])
    assert "Ep3: lp=" in log and "[Val ep0003] random-z CD" in log
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert sorted(os.listdir(checkpoint.ckpt_dir(out_dir))) == [
        "hybrid_ep0002.pt", "hybrid_ep0003.pt"]                  # keep 2
    assert os.listdir(os.path.join(out_dir, "tb"))
    assert sorted(os.listdir(os.path.join(out_dir, "samples_ep0003"))) == [
        "gt_0.ply", "pred_0.ply"]

    out, log = _run_cli(argv + ["--epochs", "3"])
    assert out == {"epochs_run": 0} and "Nothing to do" in log

    ck = torch.load(os.path.join(checkpoint.ckpt_dir(out_dir),
                                 "hybrid_ep0003.pt"), weights_only=True)
    assert ck["global_step"] == 12 and ck["epoch"] == 3   # 64 / 16 a epoch
    assert len(ck["opt"]["param_groups"]) == 3
    cfg = config_from_reference_args(ck["args"], cond_dim=ck["cond_dim"])
    _, jst, _ = state_from_reference_ckpt(ck, cfg)
    want = interop.velocity_net_to_sd(jax.device_get(jst.params["pf"]))
    for name, v in want.items():
        torch.testing.assert_close(v, ck["pf"][name], rtol=0, atol=0)
    assert int(jst.step) == 12


def test_resume_keeps_fresh_what_does_not_fit(tmp_path):
    out_dir = str(tmp_path / "run")
    _run_cli(ARGV + ["--out_dir", out_dir, "--epochs", "1"])
    # a wider latent flow: its weights and the optimizer state do not fit
    out, log = _run_cli(ARGV + ["--out_dir", out_dir, "--epochs", "2",
                                "--lf_width", "64"])
    assert "kept fresh: lf/" in log and "optimizer state RESET" in log
    assert out["epochs_run"] == 1 and np.isfinite(out["loss"])


def test_loop_writes_profile_trace(tmp_path):
    # profile_dir is a Config field (no flag in the JAX parser either)
    from pcfm_torch.train.loop import train
    cfg = cli.parse_config(ARGV + ["--out_dir", str(tmp_path / "run"),
                                   "--epochs", "1"])
    out = train(cfg.replace(profile_dir=str(tmp_path / "prof"),
                            profile_steps=2), verbose=False, device="cpu")
    assert out["epochs_run"] == 1
    assert (tmp_path / "prof" / "trace.json").is_file()


def test_resume_reads_legacy_reference_keys(tmp_path):
    # a reference checkpoint may name the point flow "model" and the
    # optimizer "opt_main" (reference train.py:487,504)
    out_dir = str(tmp_path / "run")
    _run_cli(ARGV + ["--out_dir", out_dir, "--epochs", "1"])
    path = os.path.join(checkpoint.ckpt_dir(out_dir), "hybrid_ep0001.pt")
    ck = torch.load(path, weights_only=True)
    ck["model"], ck["opt_main"] = ck.pop("pf"), ck.pop("opt")
    torch.save(ck, path)
    out, log = _run_cli(ARGV + ["--out_dir", out_dir, "--epochs", "2"])
    assert "0 kept fresh" in log and "RESET" not in log
    assert out["epochs_run"] == 1 and np.isfinite(out["loss"])


def test_epoch_without_batches_is_a_clear_error(tmp_path):
    argv = [a if a != "16" else "128" for a in ARGV]    # batch > dataset
    with pytest.raises(ValueError, match="produced no batches"):
        _run_cli(argv + ["--out_dir", str(tmp_path), "--epochs", "1"])


@pytest.mark.parametrize("argv", [
    [],
    # tests/test_train.py:277 (the reference README command)
    ["--dataset_type", "partnet_h5", "--data_dir", "/tmp/x",
     "--batch_size", "8", "--epochs", "3000", "--save_every", "100",
     "--tr_max_sample_points", "20000", "--te_max_sample_points", "20000",
     "--tdcr_use_norm", "--latent_dim", "128",
     "--partnet_cond_policy", "mode",
     "--lambda_pair", "0.1", "--lambda_var", "1.0",
     "--lambda_cov", "0.01", "--lambda_zreg", "1e-4",
     "--lambda_adv", "0.0", "--lambda_color", "1.0",
     "--use_rgb_in_latent", "--pointflow_rgb",
     "--color_prior", "uniform",
     "--partnet_report_file_train", "/tmp/report.json",
     "--out_dir", "/tmp/run"]])
def test_parser_is_the_jax_parser(argv):
    # the port's own copy of the parser reads every argv as the JAX one
    from pcfm.train.cli import parse_config
    got = cli.parse_config(argv)
    assert isinstance(got, Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(parse_config(argv))


def test_epoch_scalars_match_jax():
    from pcfm.train.loop import epoch_scalars as jax_scalars
    from pcfm_torch.train.loop import epoch_scalars
    cfg, jcfg = _cfgs(has_rgb=True, geom_warmup_epochs=2,
                      cfg_drop_warmup_epochs=4, cfg_drop_p=0.2)
    for ep in range(1, 7):
        got, want = epoch_scalars(cfg, ep), jax_scalars(jcfg, ep)
        np.testing.assert_allclose(got, [float(w) for w in want], rtol=1e-6)


def test_no_port_module_imports_jax():
    code = ("import pkgutil, importlib, sys, pcfm_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "pcfm_torch.__path__, 'pcfm_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert 'pcfm_torch.train.loop' in names, names\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'orbax') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
