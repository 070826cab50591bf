"""The port's sampling slice against the JAX package, in fp32 on the CPU:
integrators, priors, the whole latent-flow -> point-flow generation on
the same injected priors, checkpoints in the reference format, and the
sampling CLI."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.data.ply import load_ply  # noqa: E402
from pcfm.interop.torch_ckpt import state_from_reference_ckpt  # noqa: E402
from pcfm.sample import integrators as jint  # noqa: E402
from pcfm.sample import make_pf_prior as jax_prior  # noqa: E402
from pcfm.train.evaluate import _cond_full as jax_cond_full  # noqa: E402
from pcfm.train.evaluate import make_recon_fn as jax_recon  # noqa: E402
from pcfm.train.state import ModelBundle as JaxBundle  # noqa: E402
from pcfm.train.state import init_state  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.ops import film_block as fb  # noqa: E402
from pcfm_torch.sample import cli  # noqa: E402
from pcfm_torch.sample import integrators as tint  # noqa: E402
from pcfm_torch.sample.priors import make_latent_prior, make_pf_prior  # noqa: E402
from pcfm_torch.train import checkpoint  # noqa: E402
from pcfm_torch.train.evaluate import make_recon_fn, make_sample_fn  # noqa: E402
from pcfm_torch.train.state import ModelBundle  # noqa: E402

SLICE_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# a fixed nonlinear field that uses x, t and cond in both frameworks
def _field_jax(x, t, cond):
    c = 0.0 if cond is None else jnp.sum(cond, -1)[:, None, None]
    return -x * (1.0 + t[:, None, None]) + jnp.sin(x) + 0.1 * c


def _field_torch(x, t, cond):
    c = 0.0 if cond is None else cond.sum(-1)[:, None, None]
    return -x * (1.0 + t[:, None, None]) + torch.sin(x) + 0.1 * c


@pytest.mark.parametrize("name", ["euler", "midpoint", "heun", "rk4"])
@pytest.mark.parametrize("guidance", [0.0, 0.7])
def test_integrators_match_jax(name, guidance):
    rng = np.random.RandomState(0)
    x0 = rng.randn(3, 11, 6).astype(np.float32)
    cond = rng.randn(3, 4).astype(np.float32)
    want = np.asarray(jint.get_sampler(name)(
        _field_jax, jnp.asarray(x0), 7, cond=jnp.asarray(cond),
        guidance_scale=guidance))
    got = tint.get_sampler(name)(_field_torch, _t(x0), 7, cond=_t(cond),
                                 guidance_scale=guidance).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_guided_is_one_batched_call():
    calls = []

    def vf(x, t, cond):
        calls.append(x.shape[0])
        return x * cond.sum(-1)[:, None, None]

    x, cond = torch.ones(2, 3, 3), torch.ones(2, 4)
    v = tint.make_guided(vf, cond, 0.5)(x, torch.zeros(2))
    assert calls == [4]                          # one 2B call
    torch.testing.assert_close(v, x * 4 * 1.5)   # v_c + s (v_c - 0)


def test_get_sampler_errors():
    assert tint.get_sampler("dopri5") is tint.dopri5_sample
    with pytest.raises(ValueError, match="unknown sampler"):
        tint.get_sampler("nope")


@pytest.mark.parametrize("color", ["gauss", "uniform", "zeros"])
def test_priors(color):
    g = torch.Generator().manual_seed(0)
    x = make_pf_prior(g, (4, 5000, 6), 2.0, color, 0.5)
    assert x.shape == (4, 5000, 6) and x.dtype == torch.float32
    np.testing.assert_allclose(x[..., :3].std().item(), 2.0, rtol=0.03)
    rgb = x[..., 3:]
    if color == "gauss":
        np.testing.assert_allclose(rgb.std().item(), 0.5, rtol=0.03)
    elif color == "uniform":
        assert 0.0 <= rgb.min() and rgb.max() <= 1.0
    else:
        assert not rgb.any()
    again = make_pf_prior(torch.Generator().manual_seed(0), (4, 5000, 6),
                          2.0, color, 0.5)
    torch.testing.assert_close(x, again)          # a seed fixes the draw
    z = make_latent_prior(g, 3, 16, 0.8)
    assert z.shape == (3, 16)
    with pytest.raises(ValueError):
        make_pf_prior(g, (1, 2, 6), 1.0, "bad")


def _small_cfgs(**kw):
    """The same settings as the port's Config and the JAX package's."""
    base = dict(latent_dim=16, pf_width=128, pf_depth=3, pf_emb_dim=32,
                lf_width=64, lf_depth=3, lf_emb_dim=16, enc_width=32,
                has_rgb=True, cond_dim=2, amp=False, sample_steps=3,
                tr_max_sample_points=64, epochs=1, seed=0)
    base.update(kw)
    return Config(**base), JaxConfig(**base)


def _small_cfg(**kw):
    return _small_cfgs(**kw)[0]


def _jax_state(cfg, seed):
    """A JAX state whose EMA shadows differ from the live params (so the
    EMA choice is checked), as numpy trees."""
    _, state, _ = init_state(cfg, jax.random.PRNGKey(seed), total_steps=1)
    rng = np.random.RandomState(seed)

    def move(tree):
        return jax.tree_util.tree_map(
            lambda p: np.asarray(p, np.float32)
            + 0.05 * rng.randn(*np.shape(p)).astype(np.float32), tree)

    return state.replace(params=move(jax.device_get(state.params)),
                         ema_pf={"params": move(state.ema_pf["params"]),
                                 "batch_stats": {}},
                         ema_lf={"params": move(state.ema_lf["params"]),
                                 "batch_stats": {}})


def _port_bundle(cfg, state):
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(1))
    bundle.enc.load_state_dict(
        interop.shape_encoder_to_sd(state.params["enc"]))
    bundle.pf.load_state_dict(interop.velocity_net_to_sd(state.params["pf"]))
    bundle.lf.load_state_dict(interop.latent_net_to_sd(state.params["lf"]))
    bundle.ema_pf.load_state_dict(
        interop.velocity_net_to_sd(state.ema_pf["params"]))
    bundle.ema_lf.load_state_dict(
        interop.latent_net_to_sd(state.ema_lf["params"]))
    return bundle


@pytest.mark.parametrize("sampler,guidance,fused,with_cond", [
    ("heun", 0.0, "off", True),
    ("heun", 0.5, "off", False),
    ("euler", 0.0, "off", False),
    ("euler", 0.5, "off", True),
    ("heun", 0.5, "on", True)])
def test_sample_slice_matches_jax(sampler, guidance, fused, with_cond):
    cfg, jcfg = _small_cfgs(sampler=sampler, guidance_scale=guidance,
                            fused_trunk=fused, latent_sample_steps=2)
    state = _jax_state(jcfg, seed=3)
    jb = JaxBundle(jcfg)
    rng = np.random.RandomState(4)
    b, n = 2, 50
    z0 = rng.randn(b, cfg.latent_dim).astype(np.float32)
    x0 = rng.randn(b, n, cfg.pf_point_dim).astype(np.float32)
    cond = rng.randn(b, cfg.cond_dim).astype(np.float32) if with_cond \
        else None

    # the JAX package's make_sample_fn body, on the same priors
    js = jint.get_sampler(sampler)
    z = js(jb.lf_velocity_fn(state.ema_lf["params"]), jnp.asarray(z0), 2,
           cond=None, guidance_scale=0.0)
    cf = jax_cond_full(jcfg, z,
                       None if cond is None else jnp.asarray(cond))
    want = np.asarray(js(jb.pf_velocity_fn(state.ema_pf["params"], {}),
                         jnp.asarray(x0), 3, cond=cf,
                         guidance_scale=guidance))

    sample = make_sample_fn(_port_bundle(cfg, state))
    got = sample(None if cond is None else _t(cond), None, b, n,
                 z0=_t(z0), x0=_t(x0)).numpy()
    np.testing.assert_allclose(got, want, atol=SLICE_ATOL)
    # and the live weights give another answer: the EMA was used
    live = make_sample_fn(_port_bundle(cfg, state), use_ema=False)(
        None if cond is None else _t(cond), None, b, n, z0=_t(z0),
        x0=_t(x0)).numpy()
    assert np.abs(live - got).max() > 1e-3


def test_recon_matches_jax():
    cfg, jcfg = _small_cfgs(sampler="heun")
    state = _jax_state(jcfg, seed=5)
    rng = np.random.RandomState(6)
    pts = rng.randn(2, 40, 3).astype(np.float32)
    rgb = rng.rand(2, 40, 3).astype(np.float32)
    # JAX draws its prior inside recon: hand the port the same draw
    key = jax.random.PRNGKey(7)
    x0 = np.asarray(jax_prior(key, (2, 40, 6), cfg.point_prior_std,
                              cfg.color_prior, cfg.color_prior_std))
    want = np.asarray(jax_recon(JaxBundle(jcfg))(
        state, jnp.asarray(pts), jnp.asarray(rgb), None, key))
    got = make_recon_fn(_port_bundle(cfg, state))(
        _t(pts), _t(rgb), None, x0=_t(x0)).numpy()
    np.testing.assert_allclose(got, want, atol=SLICE_ATOL)


def test_eval_oversample_not_ported():
    # ported since: ceil(k N) points are integrated, FPS keeps N
    # (tests/test_torch_port_eval.py holds it against JAX)
    cfg = _small_cfg(eval_oversample=2.0)
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(0))
    x = make_sample_fn(bundle)(None, torch.Generator().manual_seed(1), 2, 30)
    assert x.shape == (2, 30, cfg.pf_point_dim) and torch.isfinite(x).all()


def test_checkpoint_loads_into_jax(tmp_path):
    cfg, jcfg = _small_cfgs(pf_depth=4)
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(8))
    with torch.no_grad():                # EMA apart from the live weights
        for p in bundle.ema_pf.parameters():
            p.add_(0.01)
    checkpoint.save(str(tmp_path), 3, bundle, global_step=17)
    checkpoint.save(str(tmp_path), 12, bundle, global_step=40)
    path, ep = checkpoint.find_latest(str(tmp_path))
    assert ep == 12 and path.endswith("hybrid_ep0012.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    assert {"encoder", "pf", "lf", "ema_pf", "ema_lf", "args", "cond_dim",
            "epoch", "global_step"} <= set(ckpt)

    _, jstate, _ = state_from_reference_ckpt(ckpt, jcfg)
    assert int(jstate.step) == 40
    for got, module in ((jstate.params["pf"], bundle.pf),
                        (jstate.ema_pf["params"], bundle.ema_pf)):
        sd = interop.velocity_net_to_sd(jax.device_get(got))
        torch.testing.assert_close(sd, module.state_dict(), rtol=0, atol=0)
    torch.testing.assert_close(
        interop.latent_net_to_sd(jax.device_get(jstate.params["lf"])),
        bundle.lf.state_dict(), rtol=0, atol=0)
    torch.testing.assert_close(
        interop.shape_encoder_to_sd(jax.device_get(jstate.params["enc"])),
        bundle.enc.state_dict(), rtol=0, atol=0)

    cfg2, b2, _ = checkpoint.load(path, "cpu", {"sampler": "euler"})
    assert cfg2.sampler == "euler" and cfg2.pf_depth == 4
    torch.testing.assert_close(b2.ema_pf.state_dict(),
                               bundle.ema_pf.state_dict())


def test_sample_cli_writes_plys(tmp_path):
    cfg = _small_cfg(fused_trunk="on")
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(9))
    checkpoint.save(str(tmp_path), 1, bundle)
    before = fb.launches
    x = cli.main(["--out_dir", str(tmp_path), "--num_samples", "3",
                  "--n_points", "64", "--sample_steps", "2",
                  "--guidance_scale", "0.25", "--cond", "0.5",
                  "--device", "cpu"])
    assert fb.launches == before                  # CPU: no kernel
    assert x.shape == (3, 64, 6) and np.isfinite(x).all()
    out = tmp_path / "generated"
    assert sorted(os.listdir(out)) == [f"sample_{i}.ply" for i in range(3)]
    xyz, rgb = load_ply(str(out / "sample_0.ply"))
    assert xyz.shape == (64, 3) and rgb.shape == (64, 3)
    np.testing.assert_allclose(xyz, x[0, :, :3], atol=1e-5)
    with pytest.raises(FileNotFoundError):
        cli.main(["--out_dir", str(tmp_path / "empty"), "--device", "cpu"])

