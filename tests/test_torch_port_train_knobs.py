"""The train step's opt-in options in the port — the endpoint EMD loss
(``lambda_emd``), the gradient-reversal adversary (``lambda_adv``,
``CondAdversary``) and the sliced-OT prior coupling (``fm_coupling
sliced_ot``) — against the JAX package, in fp32 on the CPU.

Weights go JAX -> port through pcfm_torch.interop; the step's draws are
rebuilt from the JAX step's own key splits (pcfm/train/step.py:73-106),
the sliced-OT direction from ``fold_in(k_prior, 1)``.  Tolerances as in
tests/test_torch_port_train.py: losses and the grad norm to rtol 1e-5,
each gradient within 1e-4 of its max, the updated parameters to 1e-3 lr
for 99.9 % of the elements and 2 lr for all (Adam's first update is
~lr * sign(g)), the EMA to 2e-3 lr.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm.models.adversary import CondAdversary as JaxAdversary  # noqa: E402
from pcfm.models.adversary import grad_reverse as jax_grad_reverse  # noqa: E402
from pcfm.train import state as jax_state  # noqa: E402
from pcfm.train.step import sliced_ot_permutation as jax_sliced_ot  # noqa: E402
from pcfm.train.step import train_step as jax_train_step  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.models.adversary import CondAdversary, grad_reverse  # noqa: E402
from pcfm_torch.train import checkpoint, cli, state, step  # noqa: E402
from tests.test_torch_port_train import (TINY, TO_SD, _capturing,  # noqa: E402
                                         _cfgs, _close_to_max, _jax_draws,
                                         _port_state, _t)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def test_grad_reverse_matches_jax():
    rng = np.random.RandomState(0)
    x, g = rng.randn(4, 7).astype(np.float32), rng.randn(4, 7).astype(
        np.float32)
    y_j, vjp = jax.vjp(lambda v: jax_grad_reverse(v, 0.3), jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = grad_reverse(xt, 0.3)
    y.backward(_t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), -0.3 * g)


def test_cond_adversary_matches_jax():
    rng = np.random.RandomState(1)
    z = rng.randn(5, 16).astype(np.float32)
    jnet = JaxAdversary(cond_dim=3)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"]
    net = CondAdversary(16, 3, generator=torch.Generator().manual_seed(0))
    assert [n for n, _ in net.named_parameters()] == [
        "dense_0.weight", "dense_0.bias", "dense_1.weight", "dense_1.bias",
        "out.weight", "out.bias"]
    assert all(not b.any() for n, b in net.named_parameters()
               if n.endswith("bias"))
    # Kaiming normal: std sqrt(2 / fan_in)
    np.testing.assert_allclose(float(net.dense_1.weight.detach().std()),
                               (2 / 256) ** 0.5, rtol=0.05)
    net.load_state_dict(interop.adversary_to_sd(jax.device_get(params)))
    y = net(_t(z).to(torch.bfloat16))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jnet.apply({"params": params},
                              jnp.asarray(z, jnp.bfloat16))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sliced_ot_permutation_matches_jax(seed):
    rng = np.random.RandomState(seed)
    data = rng.randn(3, 50, 3).astype(np.float32)
    prior = rng.randn(3, 50, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    u = np.asarray(jax.random.normal(key, (3,)))
    want = np.asarray(jax_sliced_ot(key, jnp.asarray(data),
                                    jnp.asarray(prior)))
    perm = step.sliced_ot_permutation(_t(u), _t(data), _t(prior))
    np.testing.assert_array_equal(perm.numpy(), want)
    # a permutation per cloud that pairs equal ranks along u
    assert all(sorted(p) == list(range(50)) for p in perm.tolist())
    un = u / np.linalg.norm(u)
    paired = np.take_along_axis(prior, perm.numpy()[..., None], axis=1)
    for b in range(3):
        np.testing.assert_array_equal(np.argsort(data[b] @ un),
                                      np.argsort(paired[b] @ un))


# the plain trunk but where all three are on (JAX's fused trunk runs its
# Pallas kernel in interpret mode, seconds a step)
KNOBS = {"emd": dict(lambda_emd=0.5, fused_trunk="off"),
         "adv": dict(lambda_adv=0.3, fused_trunk="off"),
         "sliced_ot": dict(fm_coupling="sliced_ot", fused_trunk="off"),
         "all": dict(lambda_emd=0.5, lambda_adv=0.3,
                     fm_coupling="sliced_ot", fused_trunk="on")}


@pytest.mark.parametrize("knob", list(KNOBS))
def test_train_step_with_knob_matches_jax(knob):
    cfg, jcfg = _cfgs(**TINY, has_rgb=True, cond_dim=2,
                      warmup_steps=0, grad_clip_norm=1.0, **KNOBS[knob])
    bsz, n, total, drop_p, color_on = 3, 40, 20, 0.5, 1.0
    rng = np.random.RandomState(7)
    batch = {"pts": rng.randn(bsz, n, 3).astype(np.float32) * 0.5,
             "rgb": rng.rand(bsz, n, 3).astype(np.float32),
             "cond": rng.rand(bsz, 2).astype(np.float32)}
    bundle, jst, tx = jax_state.init_state(jcfg, jax.random.PRNGKey(8),
                                           total)
    assert (bundle.adv is not None) == ("lambda_adv" in KNOBS[knob])
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rng.randn(*p.shape), p.dtype),
        jst.params)
    jst = jst.replace(params=params, ema_pf={**jst.ema_pf,
                                             "params": params["pf"]},
                      ema_lf={**jst.ema_lf, "params": params["lf"]})
    st = _port_state(cfg, jst.params, total)       # init_state takes it
    groups = dict(TO_SD)
    if bundle.adv is not None:
        groups["adv"] = interop.adversary_to_sd
        st.bundle.adv.load_state_dict(
            interop.adversary_to_sd(jax.device_get(params["adv"])))
    assert [g["name"] for g in st.opt.param_groups] == list(groups)
    cap = _capturing(tx)
    jst = jst.replace(opt_state=cap.init(jst.params))
    key = jax.random.PRNGKey(9)
    new_j, m_j = jax.jit(lambda s, b, k: jax_train_step(
        bundle, cap, s, b, k, jnp.float32(color_on), jnp.float32(drop_p)))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    draws = _jax_draws(cfg, key, bsz, n, drop_p)
    k_prior = jax.random.split(key, 6)[1]
    draws["u"] = torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.fold_in(k_prior, 1), (3,))).copy())
    m = step.train_step(st, {k: _t(v) for k, v in batch.items()}, None,
                        color_on, drop_p, draws=draws)
    names = {"loss", "loss_point", "loss_latent", "loss_pos", "loss_col"}
    names |= {"loss_emd"} if cfg.lambda_emd else set()
    names |= {"loss_adv"} if cfg.lambda_adv else set()
    assert names == set(m_j) - {"grad_norm"} == set(m) - {"grad_norm"}
    for k in names | {"grad_norm"}:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]),
                                   rtol=LOSS_RTOL, err_msg=k)

    gn = float(m["grad_norm"])          # the port's .grad is clipped
    scale = cfg.grad_clip_norm / max(gn, cfg.grad_clip_norm)
    g_j = jax.device_get(new_j.opt_state.grads)
    new_p = jax.device_get(new_j.params)
    diffs = []
    for g, conv in groups.items():
        module = getattr(st.bundle, g)
        want_g, want_p = conv(g_j[g]), conv(new_p[g])
        for name, p in module.named_parameters():
            _close_to_max(p.grad.numpy() / scale, want_g[name].numpy(),
                          GRAD_REL, f"grad {g}/{name}")
            diffs.append((p.detach() - want_p[name]).abs().flatten())
    diffs = torch.cat(diffs)
    lr = cfg.lr_pf
    assert float((diffs <= 1e-3 * lr).float().mean()) >= 0.999
    assert float(diffs.max()) <= 2 * lr
    ema = interop.velocity_net_to_sd(jax.device_get(new_j.ema_pf["params"]))
    for name, want in ema.items():
        np.testing.assert_allclose(st.bundle.ema_pf.state_dict()[name]
                                   .numpy(), want.numpy(), atol=2e-3 * lr)


def test_adversary_reverses_the_encoders_gradient():
    """With lambda_adv the encoder's gradient is the task's minus lambda
    times the adversary's; the adversary's own gradient is its loss's."""
    cfg = _cfgs(**TINY, has_rgb=True, cond_dim=2, lambda_adv=0.5)[0]
    st = state.init_state(cfg, "cpu", 10, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    batch = {"pts": torch.randn(2, 30, 3, generator=g),
             "rgb": torch.rand(2, 30, 3, generator=g),
             "cond": torch.rand(2, 2, generator=g)}
    draws = step.make_draws(cfg, batch, g, 0.0)
    b = st.bundle
    params = list(b.enc.parameters())

    def enc_grads(lambd_adv, adv_only):
        b.cfg = cfg.replace(lambda_adv=lambd_adv)
        loss, metrics = step.compute_loss(b, batch, draws, 1.0)
        target = metrics["loss_adv"] if adv_only else loss
        return torch.autograd.grad(target, params, allow_unused=True)

    full = enc_grads(0.5, False)
    task = enc_grads(1e-30, False)          # the adversary's share ~ 0
    adv = enc_grads(1.0, True)              # -1 x the adversary's pull
    for f, t, a in zip(full, task, adv):
        torch.testing.assert_close(f, t + 0.5 * a, rtol=1e-4, atol=1e-6)
    assert max(float(a.abs().max()) for a in adv) > 0


def test_train_cli_with_every_knob_runs_and_resumes(tmp_path):
    """The train CLI takes the three options (before this port they were
    refused at init): two epochs, a resume with the adversary's
    optimizer state, and the adversary in the checkpoint."""
    out_dir = str(tmp_path / "run")
    argv = ["--dataset_type", "synthetic", "--batch_size", "4",
            "--tr_max_sample_points", "32", "--te_max_sample_points", "32",
            "--latent_dim", "16", "--enc_width", "32", "--pf_width", "128",
            "--pf_depth", "3", "--pf_emb_dim", "16", "--lf_width", "32",
            "--lf_depth", "3", "--lf_emb_dim", "16", "--sample_steps", "2",
            "--vis_count", "1", "--num_workers", "0", "--fused_trunk", "on",
            "--save_every", "1", "--lambda_emd", "0.2", "--lambda_adv",
            "0.1", "--fm_coupling", "sliced_ot", "--out_dir", out_dir,
            "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv + ["--epochs", "1"])
        assert np.isfinite(out["loss_emd"]) and np.isfinite(out["loss_adv"])
        out = cli.main(argv + ["--epochs", "2"])
    log = buf.getvalue()
    assert "Resume from epoch 1" in log and "RESET" not in log
    assert out["epochs_run"] == 1 and np.isfinite(out["loss"])
    path, ep = checkpoint.find_latest(out_dir)
    ck = torch.load(path, weights_only=True)
    assert ep == 2 and set(ck["adv"]) == {
        f"{n}.{w}" for n in ("dense_0", "dense_1", "out")
        for w in ("weight", "bias")}
    assert [g["name"] for g in ck["opt"]["param_groups"]] == [
        "enc", "pf", "lf", "adv"]
    _, bundle, _ = checkpoint.load(path, "cpu")
    torch.testing.assert_close(bundle.adv.state_dict(), ck["adv"])
