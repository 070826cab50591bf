"""The port's modules (pcfm_torch.nn / pcfm_torch.models / ModelBundle)
against the JAX package, layer by layer, in fp32 on the CPU.

Weights go JAX -> port through pcfm_torch.interop; inputs are numpy draws
handed to both frameworks.  The JAX VelocityNet with ``fused_trunk="on"``
runs its Pallas kernel in interpret mode (pcfm/models/velocity.py:90).
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm import models as jm  # noqa: E402
from pcfm.interop import torch_ckpt  # noqa: E402
from pcfm.models.embeddings import timestep_embedding as jax_temb  # noqa: E402
from pcfm.nn.film import FiLMBlock as JaxFiLMBlock  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.models import (ConditionalLatentVelocityNet,  # noqa: E402
                               ShapeEncoder, VelocityNet)
from pcfm_torch.models.embeddings import timestep_embedding  # noqa: E402
from pcfm_torch.nn import common  # noqa: E402
from pcfm_torch.nn.film import FiLMBlock  # noqa: E402
from pcfm_torch.ops import film_block as fb  # noqa: E402
from pcfm_torch.train.state import ModelBundle  # noqa: E402

ATOL = 2e-5          # as tests/test_torch_parity.py
GEN = dict(generator=torch.Generator().manual_seed(0))


def _perturbed(params, seed, scale=0.05):
    """JAX init params with every leaf moved off its init value (LayerNorm
    ones/zeros and zero biases would hide a misplaced s, t or bias)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + scale * rng.randn(*np.shape(p)).astype(np.float32), params)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_timestep_embedding():
    t = np.random.RandomState(0).rand(5).astype(np.float32)
    np.testing.assert_allclose(timestep_embedding(_t(t), 64).numpy(),
                               np.asarray(jax_temb(jnp.asarray(t), 64)),
                               atol=1e-6)


@pytest.mark.parametrize("init,std,trunc", [
    (common.kaiming_normal_, np.sqrt(2.0 / 256), None),
    (common.normal02_, 0.02, None),
    (common.lecun_normal_, np.sqrt(1.0 / 256) / 0.87962566103423978, 2.0)])
def test_inits(init, std, trunc):
    lin = common.linear(256, 512, init, torch.Generator().manual_seed(1))
    w = lin.weight.detach().numpy()
    assert lin.weight.shape == (512, 256) and not lin.bias.any()
    if trunc is None:
        np.testing.assert_allclose(w.std(), std, rtol=0.02)
        assert np.abs(w).max() > 3.0 * std          # untruncated tails
    else:
        assert np.abs(w).max() <= trunc * std
        # a normal truncated at 2 sigma has std 0.8796 sigma: flax's
        # rescaling makes the result's std sqrt(1 / fan_in)
        np.testing.assert_allclose(w.std(), np.sqrt(1.0 / 256), rtol=0.02)


def test_film_block_module():
    width, emb_dim = 128, 32
    rng = np.random.RandomState(2)
    h = rng.randn(2, 50, width).astype(np.float32) * 2 + 0.5
    emb = rng.randn(2, emb_dim).astype(np.float32)
    jmod = JaxFiLMBlock(width)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(h),
                                  jnp.asarray(emb))["params"], 3)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(h),
                                 jnp.asarray(emb)))
    mod = FiLMBlock(width, emb_dim, **GEN)
    sd = {"norm.weight": _t(params["norm"]["scale"]),
          "norm.bias": _t(params["norm"]["bias"]),
          "affine.weight": _t(params["affine"]["kernel"]).T,
          "affine.bias": _t(params["affine"]["bias"])}
    mod.load_state_dict(sd)
    with torch.no_grad():
        got = mod(_t(h), _t(emb)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _velocity_pair(cond_dim, fused, film_every, seed, width=128, depth=3,
                   emb_dim=32, point_dim=6):
    kw = dict(cond_dim=cond_dim, width=width, depth=depth, emb_dim=emb_dim,
              point_dim=point_dim, fused_trunk=fused, film_every=film_every)
    jnet = jm.VelocityNet(**kw)
    x0 = jnp.zeros((2, 8, point_dim))
    params = jnet.init(jax.random.PRNGKey(seed), x0, jnp.zeros((2,)),
                       jnp.zeros((2, cond_dim)) if cond_dim else None)
    params = _perturbed(params["params"], seed)
    net = VelocityNet(**kw, **GEN)
    net.load_state_dict(interop.velocity_net_to_sd(params))
    return jnet, params, net.eval()


@pytest.mark.parametrize("fused", ["on", "off"])
@pytest.mark.parametrize("film_every", [1, 2])
@pytest.mark.parametrize("cond_dim", [0, 5])
def test_velocity_net(fused, film_every, cond_dim):
    jnet, params, net = _velocity_pair(cond_dim, fused, film_every, seed=4)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 77, 6).astype(np.float32)
    t = rng.rand(2).astype(np.float32)
    c = rng.randn(2, cond_dim).astype(np.float32) if cond_dim else None
    mask = np.array([[1.0], [0.0]], np.float32)
    for m in (None, mask):
        want = np.asarray(jnet.apply(
            {"params": params}, jnp.asarray(x), jnp.asarray(t),
            None if c is None else jnp.asarray(c),
            cond_drop_mask=None if m is None else jnp.asarray(m)))
        before = fb.launches
        with torch.no_grad():
            got = net(_t(x), _t(t), None if c is None else _t(c),
                      cond_drop_mask=None if m is None else _t(m)).numpy()
        assert fb.launches == before              # CPU: plain version
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_velocity_net_fused_width_rule():
    # width % 128 != 0 falls back to the unfused trunk, as in JAX
    jnet, params, net = _velocity_pair(3, "on", 1, seed=6, width=96)
    rng = np.random.RandomState(7)
    x, t = rng.randn(2, 20, 6).astype(np.float32), rng.rand(2)
    c = rng.randn(2, 3).astype(np.float32)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x),
                                 jnp.asarray(t, jnp.float32),
                                 jnp.asarray(c)))
    with torch.no_grad():
        got = net(_t(x), _t(t), _t(c)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_velocity_net_rejects_wrong_point_dim():
    _, _, net = _velocity_pair(0, "off", 1, seed=8)
    with pytest.raises(ValueError, match="point_dim"):
        net(torch.zeros(1, 4, 3), torch.zeros(1), None)


@pytest.mark.parametrize("cond_dim", [0, 4])
def test_latent_net(cond_dim):
    kw = dict(latent_dim=16, cond_dim=cond_dim, width=64, depth=4,
              emb_dim=32)
    jnet = jm.ConditionalLatentVelocityNet(**kw)
    params = _perturbed(jnet.init(
        jax.random.PRNGKey(9), jnp.zeros((2, 16)), jnp.zeros((2,)),
        jnp.zeros((2, cond_dim)) if cond_dim else None)["params"], 9)
    net = ConditionalLatentVelocityNet(**kw, **GEN).eval()
    net.load_state_dict(interop.latent_net_to_sd(params))
    rng = np.random.RandomState(10)
    y, t = rng.randn(3, 16).astype(np.float32), rng.rand(3)
    c = rng.randn(3, cond_dim).astype(np.float32) if cond_dim else None
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(y),
                                 jnp.asarray(t, jnp.float32),
                                 None if c is None else jnp.asarray(c)))
    with torch.no_grad():
        got = net(_t(y), _t(t), None if c is None else _t(c)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("depth,in_ch", [(4, 3), (6, 6)])
def test_shape_encoder(depth, in_ch):
    kw = dict(latent_dim=24, width=64, depth=depth, in_channels=in_ch)
    jnet = jm.ShapeEncoder(**kw)
    params = _perturbed(jnet.init(jax.random.PRNGKey(11),
                                  jnp.zeros((2, 8, in_ch)))["params"], 11)
    net = ShapeEncoder(**kw, **GEN).eval()
    net.load_state_dict(interop.shape_encoder_to_sd(params))
    pts = np.random.RandomState(12).randn(2, 100, in_ch).astype(np.float32)
    z_j, h_j = jnet.apply({"params": params}, jnp.asarray(pts))
    with torch.no_grad():
        z, h = net(_t(pts))
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=ATOL)


def _tree_close(a, b, where=""):
    assert set(a) == set(b), where
    for k in a:
        if isinstance(a[k], dict):
            _tree_close(a[k], b[k], f"{where}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=where)


def test_interop_round_trips_through_torch_ckpt():
    _, params, _ = _velocity_pair(5, "off", 1, seed=13)
    _tree_close(torch_ckpt.velocity_net_from_sd(
        interop.velocity_net_to_sd(params)), params)
    lnet = jm.ConditionalLatentVelocityNet(latent_dim=8, width=32, depth=3,
                                           emb_dim=16)
    lp = lnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8)),
                   jnp.zeros((1,)))["params"]
    _tree_close(torch_ckpt.latent_net_from_sd(interop.latent_net_to_sd(lp)),
                jax.device_get(lp))
    enet = jm.ShapeEncoder(latent_dim=8, width=32, depth=5)
    ep = enet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 3)))["params"]
    _tree_close(torch_ckpt.shape_encoder_from_sd(
        interop.shape_encoder_to_sd(ep)), jax.device_get(ep))


def test_interop_shape_check():
    _, params, _ = _velocity_pair(0, "off", 1, seed=14)
    params["block_0"]["bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="block_0"):
        interop.velocity_net_to_sd(params)


@pytest.mark.parametrize("amp", [True, False])
def test_model_bundle_dtype_policy(amp):
    cfg = Config(latent_dim=16, pf_width=128, pf_depth=4, pf_emb_dim=32,
                 lf_width=64, lf_depth=3, lf_emb_dim=16, enc_width=32,
                 has_rgb=True, cond_dim=2, amp=amp, pf_film_every=2)
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(0))
    want = torch.bfloat16 if amp else torch.float32
    assert bundle.dtype == bundle.pf.dtype == bundle.lf.dtype == want
    for m in bundle.modules().values():
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert sorted(bundle.pf.films.keys()) == ["0", "2"]
    assert bundle.pf.input.in_features == 6 + 32
    assert bundle.pf.c_proj.in_features == 16 + 2
    assert bundle.enc.mlp[0].in_features == 6
    v = bundle.pf(torch.zeros(2, 5, 6), torch.zeros(2), torch.zeros(2, 18))
    assert v.dtype == torch.float32 and v.shape == (2, 5, 6)
    torch.testing.assert_close(bundle.ema_pf.state_dict(),
                               bundle.pf.state_dict())


def test_model_bundle_rejects_hybrid():
    # the hybrid serves and trains (tests/test_torch_port_hybrid.py,
    # tests/test_torch_port_hybrid_train.py): a train state builds; an
    # unknown backbone is refused
    from pcfm_torch.models import HybridMLP
    from pcfm_torch.train.state import init_state
    st = init_state(Config(pf_backbone="hybrid", ctx_stage_channels=[16],
                           ctx_stage_blocks=[1], ctx_stage_res=[8],
                           ctx_gn_groups=4), "cpu", 10,
                    torch.Generator().manual_seed(0))
    assert isinstance(st.bundle.pf, HybridMLP) and st.bundle.pf.training
    with pytest.raises(ValueError, match="pf_backbone"):
        ModelBundle(Config(pf_backbone="pointnet"), "cpu",
                    torch.Generator().manual_seed(0))


def test_port_imports_no_jax():
    code = ("import sys, pcfm_torch, pcfm_torch.models, pcfm_torch.interop, "
            "pcfm_torch.ops.film_block, pcfm_torch.ops.build, "
            "pcfm_torch.train.evaluate, pcfm_torch.train.checkpoint, "
            "pcfm_torch.sample.cli; "
            "bad = [m for m in ('jax', 'flax', 'optax', 'orbax') "
            "if m in sys.modules]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
