"""The port's hybrid backbone (PVConv, ContextNet, HybridMLP) and its
sampling slice against the JAX package, on the CPU.

Weights go JAX -> port through ``pcfm_torch.interop.hybrid_to_sd`` (params
and BatchNorm statistics, moved off their init values); inputs and priors
are numpy draws handed to both frameworks.  Both JAX voxel backends are
held against the port: ``xla`` and ``sorted`` (its Pallas kernels in
interpret mode, with ``SORTED_N_MIN`` / ``SORTED_R3_MIN`` at 0 as
tests/test_voxel_sorted.py:169 sets them, and exact HIGHEST window tiles).
On both, the JAX package's dense one-hot route (``DENSE_R3_MAX``, R <= 16)
is turned off: it rounds the interpolation weights to bf16, a TPU speed
choice that ROADMAP lists as "do not port"; the port's plain versions
compute the same function in fp32.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pcfm.nn.pvconv as jpvconv  # noqa: E402
import pcfm.ops.voxel_sorted as jvs  # noqa: E402
from pcfm import models as jm  # noqa: E402
from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.interop.torch_ckpt import state_from_reference_ckpt  # noqa: E402
from pcfm.sample import integrators as jint  # noqa: E402
from pcfm.train.evaluate import _cond_full as jax_cond_full  # noqa: E402
from pcfm.train.state import ModelBundle as JaxBundle  # noqa: E402
from pcfm.train.state import init_state as jax_init_state  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.models import ContextNet, HybridMLP  # noqa: E402
from pcfm_torch.nn.common import BatchNorm  # noqa: E402
from pcfm_torch.nn.pvconv import PVConv  # noqa: E402
from pcfm_torch.ops import film_block as fb  # noqa: E402
from pcfm_torch.ops import voxel_sorted as tvs  # noqa: E402
from pcfm_torch.sample import cli  # noqa: E402
from pcfm_torch.sample import integrators as tint  # noqa: E402
from pcfm_torch.train import checkpoint  # noqa: E402
from pcfm_torch.train.evaluate import make_sample_fn  # noqa: E402
from pcfm_torch.train.state import ModelBundle, init_state  # noqa: E402
from tests import torch_mirror_hybrid as tmh  # noqa: E402
from tests.test_interop import ref_sd_from_hybrid  # noqa: E402

# fp32: conv reduction order plus knife-edge voxel rounding, as
# tests/test_torch_parity_hybrid.py:19
ATOL = 5e-4
# the bf16 island (ctx_dtype bf16, bf16 head): both sides round the convs,
# the grid BatchNorm, SE and the Dense layers to bf16, but at different
# places (the port also rounds the scatter's input, as the JAX package's
# sorted kernels do on the TPU); measured 6.5e-3 of max |v| at this size
BF16_REL = 3e-2
GEN = dict(generator=torch.Generator().manual_seed(0))
SMALL = dict(ctx_dim=8, ctx_emb_dim=16, stage_channels=(16, 32),
             stage_blocks=(1, 1), stage_res=(16, 8), with_se=True,
             gn_groups=4, with_global=True, pf_width=128, pf_depth=3,
             pf_emb_dim=16)


@pytest.fixture(params=["xla", "sorted"])
def backend(request, monkeypatch):
    """A JAX voxel backend with its exact (fp32) routes."""
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    if request.param == "sorted":
        monkeypatch.setattr(jpvconv, "SORTED_N_MIN", 0)
        monkeypatch.setattr(jpvconv, "SORTED_R3_MIN", 0)
        monkeypatch.setattr(jvs, "DOT_PRECISION", jax.lax.Precision.HIGHEST)
    return request.param


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _moved(params, stats, seed):
    """Params moved off init and BatchNorm statistics away from (0, 1), so
    that a misplaced scale, bias, mean or variance shows."""
    rng = np.random.RandomState(seed)

    def p(x):
        return np.asarray(x, np.float32) \
            + 0.05 * rng.randn(*np.shape(x)).astype(np.float32)

    def s(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("'mean']"):
            return x + 0.1 * rng.randn(*x.shape).astype(np.float32)
        return x * rng.uniform(0.75, 1.25, x.shape).astype(np.float32)

    return (jax.tree_util.tree_map(p, params),
            jax.tree_util.tree_map_with_path(s, stats))


def _inputs(seed, b=2, n=300, d=6, cond_dim=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, d).astype(np.float32)
    t = rng.rand(b).astype(np.float32)
    c = rng.randn(b, cond_dim).astype(np.float32) if cond_dim else None
    return x, t, c


def _close(got, want, atol=ATOL):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)


# ------------------------------------------------------------ modules

def test_pvconv_matches_jax(backend):
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 300, 8).astype(np.float32)
    coords = rng.randn(2, 300, 3).astype(np.float32)
    jnet = jpvconv.PVConv(out_channels=16, kernel_size=3, resolution=16,
                          with_se=True, eps=1e-6, voxel_backend=backend)
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                  jnp.asarray(coords), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 1)
    want, _ = jnet.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(feats), jnp.asarray(coords),
                         train=False)
    net = PVConv(8, 16, 3, 16, True, True, 1e-6, **GEN)
    net.load_state_dict(interop.pvconv_to_sd(params, stats))
    with torch.no_grad():
        got, c = net.eval()(_t(feats), _t(coords))
    assert torch.equal(c, _t(coords))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cond_dim,norm", [(5, "group"), (0, "group"),
                                           (5, "batch")])
def test_context_net_matches_jax(backend, cond_dim, norm):
    kw = dict(in_point_dim=6, cond_dim=cond_dim, emb_dim=16, ctx_dim=8,
              stage_channels=(16, 32), stage_blocks=(2, 1),
              stage_res=(16, 8), with_se=True, norm_type=norm, gn_groups=4,
              with_global=True, t_gate_tau=0.4)
    x, t, c = _inputs(2, cond_dim=cond_dim)
    jnet = jm.ContextNet(voxel_backend=backend, **kw)
    jc = None if c is None else jnp.asarray(c)
    v = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t), jc,
                  train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 3)
    want = jnet.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), jnp.asarray(t), jc, train=False)
    net = ContextNet(**kw, **GEN)
    net.load_state_dict(interop.context_net_to_sd(params, stats))
    with torch.no_grad():
        got = net.eval()(_t(x), _t(t), None if c is None else _t(c))
    _close(got.numpy(), np.asarray(want))


def _hybrid_pair(cond_dim, seed, backend="xla", dtype=jnp.float32,
                 tdtype=torch.float32, fused="on"):
    kw = dict(cond_dim=cond_dim, point_dim=6, **SMALL)
    jnet = jm.HybridMLP(voxel_backend=backend, dtype=dtype,
                        ctx_island_dtype=dtype, fused_trunk=fused, **kw)
    x, t, c = _inputs(seed, cond_dim=cond_dim)
    v = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t),
                  None if c is None else jnp.asarray(c), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], seed + 1)
    net = HybridMLP(dtype=tdtype, ctx_island_dtype=tdtype, fused_trunk=fused,
                    **kw, **GEN)
    net.load_state_dict(interop.hybrid_to_sd(params, stats))
    return jnet, {"params": params, "batch_stats": stats}, net.eval()


@pytest.mark.parametrize("cond_dim", [5, 0])
def test_hybrid_mlp_matches_jax(backend, cond_dim):
    jnet, var, net = _hybrid_pair(cond_dim, 4, backend)
    x, t, c = _inputs(5, cond_dim=cond_dim)
    jc = None if c is None else jnp.asarray(c)
    # the CFG mask: row 0 dropped, row 1 kept
    for mask in (None, np.array([[1.0], [0.0]], np.float32)):
        want = jnet.apply(var, jnp.asarray(x), jnp.asarray(t), jc,
                          cond_drop_mask=None if mask is None
                          else jnp.asarray(mask), train=False)
        before = fb.launches, dict(tvs.launches)
        with torch.no_grad():
            got = net(_t(x), _t(t), None if c is None else _t(c),
                      cond_drop_mask=None if mask is None else _t(mask))
        assert (fb.launches, tvs.launches) == before     # CPU: plain
        _close(got.numpy(), np.asarray(want))


def test_hybrid_bf16_island_matches_jax():
    jnet, var, net = _hybrid_pair(5, 6, dtype=jnp.bfloat16,
                                  tdtype=torch.bfloat16)
    x, t, c = _inputs(7)
    want = np.asarray(jnet.apply(var, jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(c), train=False))
    with torch.no_grad():
        got = net(_t(x), _t(t), _t(c)).numpy()
    assert got.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=BF16_REL)


def test_guided_hybrid_uses_zero_cond():
    """CFG for the hybrid: the unconditional branch is a zeroed condition
    (pcfm/models/hybrid.py:3-8), in one batched 2B call."""
    net = HybridMLP(cond_dim=5, point_dim=6, **SMALL, **GEN).eval()
    x, t, c = (_t(a) for a in _inputs(8))
    with torch.no_grad():
        for p in net.parameters():           # leave the zero-init start
            p.add_(0.05 * torch.randn(p.shape, **GEN))
        v_c, v_u = net(x, t, c), net(x, t, torch.zeros_like(c))
        got = tint.make_guided(net, c, 0.25)(x, t)
    torch.testing.assert_close(got, v_c + 0.25 * (v_c - v_u), atol=1e-5,
                               rtol=1e-5)
    assert (v_c - v_u).abs().max() > 1e-3


def test_batchnorm_train_mode_uses_batch_statistics():
    """Train mode normalises with each batch's statistics (so a cloud's
    context depends on the other clouds of its batch) and moves the
    running statistics; eval mode normalises with the running ones (each
    cloud alone) and moves nothing."""
    net = HybridMLP(cond_dim=5, point_dim=6, **SMALL, **GEN).ctx_net
    x, t, c = (_t(a) for a in _inputs(9))
    x[1] = 3.0 * x[1] + 1.0              # a second cloud unlike the first
    t = torch.ones(2)                    # the t-gate passes the pyramid
    with torch.no_grad():
        for p in net.parameters():           # leave the zero-init start
            p.add_(0.05 * torch.randn(p.shape, **GEN))
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    stats = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
    with torch.no_grad():
        v_eval = net.eval()(x, t, c)
        v_eval0 = net(x[:1], t[:1], c[:1])
        assert all(torch.equal(m.running_mean, s[0]) for m, s in
                   zip(bns, stats))
        v_train = net.train()(x, t, c)
        v_train0 = net(x[:1], t[:1], c[:1])
    torch.testing.assert_close(v_eval0, v_eval[:1], atol=1e-5, rtol=1e-5)
    assert (v_train0 - v_train[:1]).abs().max() > 1e-3
    assert (v_train - v_eval).abs().max() > 1e-3
    for m, (mean, var) in zip(bns, stats):
        assert int(m.num_batches_tracked) == 2
        assert not torch.equal(m.running_mean, mean)
        assert not torch.equal(m.running_var, var)


# ------------------------------------------------------------ the slice

def _small_cfg(**kw):
    base = dict(pf_backbone="hybrid", latent_dim=16, pf_width=128,
                pf_depth=3, pf_emb_dim=16, lf_width=64, lf_depth=3,
                lf_emb_dim=16, enc_width=32, has_rgb=True, cond_dim=1,
                amp=False, ctx_dtype="fp32", ctx_dim=8, ctx_emb_dim=16,
                ctx_stage_channels=[16, 32], ctx_stage_blocks=[1, 1],
                ctx_stage_res=[16, 8], ctx_gn_groups=4, fused_trunk="on",
                sampler="heun", sample_steps=4, latent_sample_steps=2,
                voxel_backend="xla", epochs=1, seed=0)
    base.update(kw)
    return Config(**base), JaxConfig(**base)


def _jax_hybrid_state(jcfg, seed):
    """A JAX state whose EMA differs from the live weights, as numpy."""
    _, st, _ = jax_init_state(jcfg, jax.random.PRNGKey(seed), total_steps=1)
    params = jax.device_get(st.params)
    pf, pf_s = _moved(params["pf"], jax.device_get(st.batch_stats["pf"]),
                      seed)
    ema, ema_s = _moved(params["pf"], jax.device_get(st.batch_stats["pf"]),
                        seed + 1)
    lf, _ = _moved(params["lf"], {}, seed + 2)
    enc, _ = _moved(params["enc"], {}, seed + 3)
    return {"enc": enc, "pf": pf, "pf_stats": pf_s, "ema_pf": ema,
            "ema_pf_stats": ema_s, "lf": lf}


def _port_hybrid_bundle(cfg, js):
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(1))
    bundle.enc.load_state_dict(interop.shape_encoder_to_sd(js["enc"]))
    bundle.lf.load_state_dict(interop.latent_net_to_sd(js["lf"]))
    bundle.ema_lf.load_state_dict(interop.latent_net_to_sd(js["lf"]))
    bundle.pf.load_state_dict(interop.hybrid_to_sd(js["pf"], js["pf_stats"]))
    bundle.ema_pf.load_state_dict(
        interop.hybrid_to_sd(js["ema_pf"], js["ema_pf_stats"]))
    return bundle


@pytest.mark.parametrize("guidance", [0.0, 0.25])
def test_hybrid_sample_slice_matches_jax(monkeypatch, guidance):
    """Heun x 4 through the latent flow and the hybrid point flow on the
    same injected priors (as tests/test_torch_port_sample.py:153)."""
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    cfg, jcfg = _small_cfg(guidance_scale=guidance)
    js = _jax_hybrid_state(jcfg, seed=3)
    jb = JaxBundle(jcfg)
    rng = np.random.RandomState(4)
    b, n = 2, 200
    z0 = rng.randn(b, cfg.latent_dim).astype(np.float32)
    x0 = rng.randn(b, n, cfg.pf_point_dim).astype(np.float32)
    cond = rng.rand(b, cfg.cond_dim).astype(np.float32)

    sampler = jint.get_sampler("heun")
    z = sampler(jb.lf_velocity_fn(js["lf"]), jnp.asarray(z0), 2, cond=None,
                guidance_scale=0.0)
    cf = jax_cond_full(jcfg, z, jnp.asarray(cond))
    want = np.asarray(sampler(
        jb.pf_velocity_fn(js["ema_pf"], js["ema_pf_stats"]),
        jnp.asarray(x0), 4, cond=cf, guidance_scale=guidance))

    bundle = _port_hybrid_bundle(cfg, js)
    got = make_sample_fn(bundle)(_t(cond), None, b, n, z0=_t(z0),
                                 x0=_t(x0)).numpy()
    _close(got, want)
    assert bundle.pf.training and bundle.ema_pf.training   # modes restored
    live = make_sample_fn(bundle, use_ema=False)(
        _t(cond), None, b, n, z0=_t(z0), x0=_t(x0)).numpy()
    assert np.abs(live - got).max() > 1e-3                 # the EMA was used


def test_port_hybrid_checkpoint_loads_into_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    cfg, jcfg = _small_cfg()
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(5))
    with torch.no_grad():                 # leave the zero-init start
        for m in (bundle.pf, bundle.ema_pf):
            for p in m.parameters():
                p.add_(0.05 * torch.randn(p.shape, **GEN))
    checkpoint.save(str(tmp_path), 2, bundle, global_step=9)
    path, _ = checkpoint.find_latest(str(tmp_path))
    ck = torch.load(path, map_location="cpu", weights_only=False)

    # the key set is the reference HybridMLP's (the mirror re-keyed)
    mirror = tmh.HybridMLPT(
        cfg.pf_cond_dim, 6,
        dict(emb_dim=16, ctx_dim=8, stage_channels=(16, 32),
             stage_blocks=(1, 1), stage_res=(16, 8), with_se=True,
             gn_groups=4, with_global=True, t_gate_k=10.0, t_gate_tau=0.8),
        dict(ctx_dim=8, width=128, depth=3, emb_dim=16))
    assert set(ck["pf"]) == set(ref_sd_from_hybrid(mirror))

    _, jst, _ = state_from_reference_ckpt(ck, jcfg)
    assert int(jst.step) == 9
    jb = JaxBundle(jcfg)
    x, t, c = _inputs(10, cond_dim=cfg.pf_cond_dim)
    for jp, js, module in (
            (jst.params["pf"], jst.batch_stats["pf"], bundle.pf),
            (jst.ema_pf["params"], jst.ema_pf["batch_stats"],
             bundle.ema_pf)):
        want, _ = jb.apply_pf(jp, js, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(c), None, train=False)
        with torch.no_grad():
            got = module.eval()(_t(x), _t(t), _t(c))
        _close(got.numpy(), np.asarray(want))
    cfg2, b2, _ = checkpoint.load(path, "cpu")
    assert cfg2 == cfg and cfg2.voxel_backend == "xla"    # flag as given
    torch.testing.assert_close(b2.ema_pf.state_dict(),
                               bundle.ema_pf.state_dict())


def test_reference_checkpoint_loads_into_port():
    """A reference-keyed state_dict (the torch mirror, with conv biases and
    BatchNorm statistics) loads into the port as it is, the EMA shadow
    without ``num_batches_tracked``; the port folds the conv biases into
    the running means as the JAX importer does."""
    torch.manual_seed(6)
    ctx_kw = dict(emb_dim=16, ctx_dim=8, stage_channels=(16,),
                  stage_blocks=(1,), stage_res=(8,), with_se=True,
                  gn_groups=4, with_global=True, t_gate_k=10.0,
                  t_gate_tau=0.8)
    mirror = tmh.HybridMLPT(5, 6, ctx_kw, dict(ctx_dim=8, width=32, depth=3,
                                               emb_dim=16)).eval()
    g = torch.Generator().manual_seed(7)
    for mod in mirror.modules():
        if isinstance(mod, (torch.nn.BatchNorm1d, torch.nn.BatchNorm3d)):
            mod.running_mean.copy_(torch.randn(mod.running_mean.shape,
                                               generator=g) * 0.1)
            mod.running_var.uniform_(0.75, 1.25, generator=g)
    sd = ref_sd_from_hybrid(mirror)
    assert any(k.endswith("voxel_layers.0.bias") for k in sd)
    net = HybridMLP(cond_dim=5, point_dim=6, ctx_dim=8, ctx_emb_dim=16,
                    stage_channels=(16,), stage_blocks=(1,), stage_res=(8,),
                    gn_groups=4, pf_width=32, pf_depth=3, pf_emb_dim=16,
                    **GEN)
    ema = {k: v for k, v in sd.items() if v.dtype.is_floating_point}
    for state in (sd, ema):
        net.load_state_dict(state)
        x, t, c = _inputs(11, n=120)
        with torch.no_grad():
            want = mirror(_t(x), _t(t), _t(c)).numpy()
            got = net.eval()(_t(x), _t(t), _t(c)).numpy()
        _close(got, want)


# ------------------------------------------------------------ bundle, CLI

def test_model_bundle_builds_hybrid():
    cfg, _ = _small_cfg(amp=True, ctx_dtype="bf16", grid_bn="flat")
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(0))
    pf = bundle.pf
    assert isinstance(pf, HybridMLP) and pf.dtype == torch.bfloat16
    assert pf.ctx_net.island_dtype == torch.bfloat16
    pv = pf.ctx_net.stages[0].blocks[0].pvconv
    assert pv.dtype == torch.bfloat16 and pv.bn_dtype == torch.float32
    assert pf.head.input.in_features == 6 + 8 + 16
    for m in bundle.modules().values():
        assert all(p.dtype == torch.float32 for p in m.parameters())
    torch.testing.assert_close(bundle.ema_pf.state_dict(),
                               bundle.pf.state_dict())
    # the hybrid trains: its optimizer leaves out the dead conv biases
    # (2 a PVConv, 1 a SharedMLP), which the JAX package does not have
    st = init_state(cfg, "cpu", 10, torch.Generator().manual_seed(0))
    pf_group = next(g for g in st.opt.param_groups if g["name"] == "pf")
    assert len(pf_group["params"]) == len(list(pf.parameters())) - 10


def test_sample_cli_hybrid_on_cpu(tmp_path):
    cfg, _ = _small_cfg(amp=True, ctx_dtype="bf16")
    bundle = ModelBundle(cfg, "cpu", torch.Generator().manual_seed(9))
    checkpoint.save(str(tmp_path), 1, bundle)
    before = fb.launches, dict(tvs.launches)
    x = cli.main(["--out_dir", str(tmp_path), "--num_samples", "2",
                  "--n_points", "150", "--sample_steps", "2",
                  "--guidance_scale", "0.25", "--device", "cpu"])
    assert (fb.launches, tvs.launches) == before          # CPU: no kernel
    assert x.shape == (2, 150, 6) and np.isfinite(x).all()
    assert sorted(os.listdir(tmp_path / "generated")) == [
        "sample_0.ply", "sample_1.ply"]
