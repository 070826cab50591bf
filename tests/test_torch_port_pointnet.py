"""The port's PointNet++ ops and modules (pcfm_torch/ops/ball_query.py,
interpolate.py, losses.py, sampling.logits_mask, pcfm_torch/nn/pointnet.py)
against the JAX package and tests/oracles.py, in fp32 on the CPU.

No model path of either package calls these; they are plain PyTorch as the
JAX package's are plain jnp.  Module weights go JAX -> port through
``pcfm_torch.interop``'s ``pointnet_*_to_sd``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pcfm import nn as jnn  # noqa: E402
from pcfm import ops as jops  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.nn import pointnet  # noqa: E402
from pcfm_torch.ops import ball_query as bq  # noqa: E402
from pcfm_torch.ops import interpolate, losses, sampling  # noqa: E402
from tests import oracles  # noqa: E402

GEN = dict(generator=torch.Generator().manual_seed(0))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_ball_query_matches_jax_and_oracle(rng):
    centers = rng.randn(2, 10, 3).astype(np.float32) * 0.5
    points = rng.randn(2, 50, 3).astype(np.float32) * 0.5
    got = bq.ball_query(_t(centers), _t(points), 0.7, 8)
    assert got.dtype == torch.int32 and got.shape == (2, 10, 8)
    want = np.asarray(jops.ball_query(jnp.asarray(centers),
                                      jnp.asarray(points), radius=0.7,
                                      num_neighbors=8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  oracles.ball_query_np(centers, points,
                                                        0.7, 8))


def test_ball_query_backfill_and_no_hits():
    # tests/test_ops.py:266: hits at 1 and 3, the rest back-filled with 1
    points = _t([[[5, 0, 0], [0.1, 0, 0], [6, 0, 0], [0, 0.1, 0],
                  [7, 0, 0]]])
    idx = bq.ball_query(torch.zeros(1, 1, 3), points, 1.0, 4)
    assert idx[0, 0].tolist() == [1, 3, 1, 1]
    # tests/test_ops.py:336: no hit anywhere -> every index 0
    idx = bq.ball_query(torch.zeros(1, 2, 3), torch.ones(1, 5, 3) * 100.0,
                        0.1, 3)
    assert idx.shape == (1, 2, 3) and not idx.any()


def test_grouping_matches_jax_with_gradient(rng):
    feats = rng.randn(2, 50, 6).astype(np.float32)
    idx = rng.randint(0, 50, size=(2, 10, 8)).astype(np.int32)
    cot = rng.randn(2, 10, 8, 6).astype(np.float32)
    want, vjp = jax.vjp(lambda f: jops.grouping(f, jnp.asarray(idx)),
                        jnp.asarray(feats))
    f = _t(feats).requires_grad_(True)
    got = bq.grouping(f, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (g,) = torch.autograd.grad(got, f, _t(cot))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               atol=1e-5)


def test_three_nn_and_interpolate_match_jax_and_oracle(rng):
    points = rng.randn(2, 40, 3).astype(np.float32)
    centers = rng.randn(2, 12, 3).astype(np.float32)
    feats = rng.randn(2, 12, 5).astype(np.float32)
    d2, idx = interpolate.three_nn(_t(points), _t(centers))
    jd2, jidx = jops.three_nn(jnp.asarray(points), jnp.asarray(centers))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), atol=1e-5)
    np.testing.assert_allclose(interpolate.three_nn_weights(d2).numpy(),
                               np.asarray(jops.three_nn_weights(jd2)),
                               rtol=1e-5, atol=1e-6)
    got = interpolate.nearest_neighbor_interpolate(_t(points), _t(centers),
                                                   _t(feats))
    want = np.asarray(jops.nearest_neighbor_interpolate(
        jnp.asarray(points), jnp.asarray(centers), jnp.asarray(feats)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(),
                               oracles.three_nn_interp_np(points, centers,
                                                          feats),
                               rtol=1e-4, atol=1e-4)


def test_three_nn_ties_keep_the_earlier_index():
    # centers 1 and 3 at distance 1, 0 and 4 at distance 4, 2 farther: the
    # earlier index first on each tie, as JAX's top_k and the reference
    points = torch.zeros(1, 1, 3)
    centers = _t([[[2, 0, 0], [1, 0, 0], [3, 0, 0], [-1, 0, 0],
                   [0, 2, 0]]])
    d2, idx = interpolate.three_nn(points, centers)
    assert idx[0, 0].tolist() == [1, 3, 0]
    assert d2[0, 0].tolist() == [1.0, 1.0, 4.0]
    jd2, jidx = jops.three_nn(jnp.asarray(points.numpy()),
                              jnp.asarray(centers.numpy()))
    assert np.asarray(jidx)[0, 0].tolist() == [1, 3, 0]


def test_interpolate_gradient_reaches_features_only(rng):
    points = _t(rng.randn(2, 30, 3)).requires_grad_(True)
    centers = _t(rng.randn(2, 9, 3)).requires_grad_(True)
    feats_np = rng.randn(2, 9, 4).astype(np.float32)
    cot = rng.randn(2, 30, 4).astype(np.float32)
    feats = _t(feats_np).requires_grad_(True)
    out = interpolate.nearest_neighbor_interpolate(points, centers, feats)
    g_p, g_c, g_f = torch.autograd.grad(out, (points, centers, feats),
                                        _t(cot), allow_unused=True)
    assert g_p is None and g_c is None
    _, vjp = jax.vjp(lambda f: jops.nearest_neighbor_interpolate(
        jnp.asarray(points.detach().numpy()),
        jnp.asarray(centers.detach().numpy()), f), jnp.asarray(feats_np))
    np.testing.assert_allclose(g_f.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(4, 10), (2, 7, 5)])
def test_kl_loss_matches_jax_with_gradient(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    want, (gx, gy) = jax.value_and_grad(
        lambda a, b: jops.kl_loss(a, b), argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(y))
    xt, yt = _t(x).requires_grad_(True), _t(y).requires_grad_(True)
    got = losses.kl_loss(xt, yt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert xt.grad is None or not xt.grad.any()       # no gradient to x
    assert not np.asarray(gx).any()
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), atol=1e-6)
    assert abs(losses.kl_loss(xt, xt.detach()).item()) < 1e-6


def test_huber_loss_matches_jax_with_gradient():
    err = np.array([0.5, -2.0, 0.0, 1.0, 3.5], np.float32)
    want, g = jax.value_and_grad(lambda e: jops.huber_loss(e, 1.0))(
        jnp.asarray(err))
    et = _t(err).requires_grad_(True)
    got = losses.huber_loss(et, 1.0)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(g), atol=1e-7)
    assert abs(float(losses.huber_loss(_t([0.5, -2.0]), 1.0))
               - np.mean([0.125, 1.5])) < 1e-6


# ------------------------------------------------------------ logits_mask

def _mask_case(rng, b=3, n=40):
    coords = rng.randn(b, n, 3).astype(np.float32)
    logits = rng.randn(b, n, 2).astype(np.float32)
    logits[1, :, 1] = logits[1, :, 0] - 1.0           # cloud 1: none
    logits[2, :, 1] = logits[2, :, 0] - 1.0           # cloud 2: two
    logits[2, [5, 17], 1] = logits[2, [5, 17], 0] + 1.0
    return coords, logits


def test_logits_mask_mask_and_mean_match_jax(rng):
    # the draws differ (a torch.Generator against a JAX key): the mask and
    # the mean follow from the logits alone; the mask agrees exactly, the
    # mean up to the order of its fp32 sum
    coords, logits = _mask_case(rng)
    sel, mean, mask = sampling.logits_mask(
        _t(coords), _t(logits), 16, torch.Generator().manual_seed(0))
    jsel, jmean, jmask = jops.logits_mask(jnp.asarray(coords),
                                          jnp.asarray(logits), 16,
                                          jax.random.PRNGKey(0))
    assert sel.shape == (3, 16, 3) and mean.shape == (3, 3)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6,
                               atol=1e-7)
    assert tuple(jsel.shape) == tuple(sel.shape)


def test_logits_mask_selects_positives_only(rng):
    # every selected point, mean added back, is a positive of its cloud;
    # with at least M positives none repeats (a draw without replacement);
    # with fewer, each positive appears floor(M / cnt) or that + 1 times
    coords, logits = _mask_case(rng)
    sel, mean, mask = sampling.logits_mask(
        _t(coords), _t(logits), 16, torch.Generator().manual_seed(1))
    masked = coords * mask.numpy()[..., None]
    for b in (0, 2):
        pos = masked[b][mask.numpy()[b]] - mean.numpy()[b]
        rows = [int(np.flatnonzero((np.abs(pos - p) < 1e-6).all(1))[0])
                for p in sel.numpy()[b]]
        counts = np.bincount(rows, minlength=len(pos))
        assert counts.sum() == 16
        if len(pos) >= 16:
            assert counts.max() == 1
        else:
            assert counts.min() >= 16 // len(pos)
            assert counts.max() <= 16 // len(pos) + 1
    assert len(pos) == 2 and sorted(counts.tolist()) == [8, 8]


def test_logits_mask_no_positives():
    # tests/test_ops.py:392: no positive -> mask empty, mean 0, every
    # selected point index 0 of the zeroed coords
    coords = torch.ones(1, 10, 3)
    logits = torch.stack([torch.ones(1, 10), torch.zeros(1, 10)], dim=-1)
    sel, mean, mask = sampling.logits_mask(coords, logits, 4,
                                           torch.Generator().manual_seed(0))
    assert not mask.any() and not mean.any() and not sel.any()
    assert sel.shape == (1, 4, 3)


def test_logits_mask_draws_from_its_generator(rng):
    coords, logits = _mask_case(rng)
    runs = [sampling.logits_mask(_t(coords), _t(logits), 16,
                                 torch.Generator().manual_seed(s))[0]
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])


# ------------------------------------------------------------ modules

def _jax_module(mod, args, seed):
    """(params, batch_stats) of a flax module, every leaf moved off its
    init value (unit scales and zero biases would hide a misplaced one)."""
    v = mod.init(jax.random.PRNGKey(seed), *args, train=False)
    r = np.random.RandomState(seed)

    def move(tree, lo):
        return jax.tree_util.tree_map(
            lambda p: np.asarray(p, np.float32)
            + (lo + 0.1 * np.abs(r.randn(*np.shape(p)))).astype(np.float32),
            tree)
    return move(v["params"], 0.0), move(v["batch_stats"], 0.05)


def _check_module(jmod, tmod, sd, params, stats, jargs, targs, n_out):
    """The port module against the flax one in eval mode (running
    statistics) and in training mode (batch statistics, the running
    statistics' update, and the input gradient of the first output)."""
    tmod.load_state_dict(sd)
    want = jax.jit(lambda *a: jmod.apply(
        {"params": params, "batch_stats": stats}, *a, train=False))(*jargs)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*targs)
    for g, w in zip(got[:n_out], want[:n_out]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    cot = np.random.RandomState(1).randn(*np.shape(want[0])).astype(
        np.float32)

    def jax_out(x0):
        out, upd = jmod.apply({"params": params, "batch_stats": stats}, x0,
                              *jargs[1:], train=True,
                              mutable=["batch_stats"])
        return jnp.sum(out[0] * cot), (out, upd)
    (_, (want, upd)), gx = jax.jit(jax.value_and_grad(jax_out,
                                                      has_aux=True))(jargs[0])
    tmod.train()
    x0 = targs[0].clone().requires_grad_(True)
    got = tmod(x0, *targs[1:])
    (g,) = torch.autograd.grad((got[0] * _t(cot)).sum(), x0)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    moved = tmod.state_dict()
    checked = 0
    for k in sd:
        for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
            if k.endswith(ours):
                np.testing.assert_allclose(
                    moved[k].numpy(),
                    np.asarray(_stat(upd["batch_stats"], k, theirs)),
                    rtol=1e-4, atol=1e-5, err_msg=k)
                checked += 1
    assert checked and checked % 2 == 0


def _stat(stats, key, which):
    """The flax statistic at a port state_dict key (``...mlps.{i}.layers.
    {3j+1}.running_var`` or ``...mlp.layers.{3j+1}.running_var``)."""
    parts = key.split(".")
    node = stats[f"mlp_{parts[parts.index('mlps') + 1]}"] \
        if "mlps" in parts else stats["mlp"]
    return node[f"bn_{int(parts[-2]) // 3}"][which]


def test_ball_query_module_matches_jax(rng):
    pts = (rng.randn(2, 64, 3) * 0.3).astype(np.float32)
    feats = rng.randn(2, 64, 4).astype(np.float32)
    jmod = jnn.BallQuery(radius=0.8, num_neighbors=8)
    tmod = pointnet.BallQuery(0.8, 8)
    for f in (feats, None):
        want = jmod.apply({}, jnp.asarray(pts), jnp.asarray(pts[:, :16]),
                          None if f is None else jnp.asarray(f))
        got = tmod(_t(pts), _t(pts[:, :16]), None if f is None else _t(f))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError):
        pointnet.BallQuery(0.8, 8, include_coordinates=False)(
            _t(pts), _t(pts[:, :16]))


@pytest.mark.parametrize("ocs", [[16], [[8, 16], [12]]])
def test_pointnet_a_module_matches_jax(rng, ocs):
    feats = rng.randn(2, 64, 8).astype(np.float32)
    coords = rng.randn(2, 64, 3).astype(np.float32)
    jmod = jnn.PointNetAModule(out_channels=ocs)
    args = (jnp.asarray(feats), jnp.asarray(coords))
    params, stats = _jax_module(jmod, args, 3)
    tmod = pointnet.PointNetAModule(8, ocs, **GEN)
    _check_module(jmod, tmod, interop.pointnet_a_to_sd(params, stats),
                  params, stats, args, (_t(feats), _t(coords)), 2)


@pytest.mark.parametrize("radius,nn_,ocs", [
    (0.5, 16, [16, 16]),
    ([0.4, 0.8], [8, 16], [[8, 12], [16]])])
def test_pointnet_sa_module_matches_jax(rng, radius, nn_, ocs):
    feats = rng.randn(2, 128, 5).astype(np.float32)
    coords = (rng.randn(2, 128, 3) * 0.4).astype(np.float32)
    jmod = jnn.PointNetSAModule(num_centers=32, radius=radius,
                                num_neighbors=nn_, out_channels=ocs)
    args = (jnp.asarray(feats), jnp.asarray(coords))
    params, stats = _jax_module(jmod, args, 4)
    tmod = pointnet.PointNetSAModule(32, radius, nn_, 5, ocs, **GEN)
    sd = interop.pointnet_sa_to_sd(params, stats)
    assert sd["mlps.0.layers.0.weight"].dim() == 4    # reference Conv2d
    _check_module(jmod, tmod, sd, params, stats, args,
                  (_t(feats), _t(coords)), 2)


def test_pointnet_fp_module_matches_jax(rng):
    coords = rng.randn(2, 128, 3).astype(np.float32)
    centers = coords[:, ::4].copy()
    cfeats = rng.randn(2, 32, 16).astype(np.float32)
    pfeats = rng.randn(2, 128, 8).astype(np.float32)
    jmod = jnn.PointNetFPModule(out_channels=[12, 8])
    # the centers' features first: the gradient the check takes
    args = (jnp.asarray(coords), jnp.asarray(centers), jnp.asarray(cfeats),
            jnp.asarray(pfeats))
    params, stats = _jax_module(jmod, args, 5)
    tmod = pointnet.PointNetFPModule(24, [12, 8], **GEN)

    class CentersFirst(torch.nn.Module):
        """The FP module with its centers' features as the first input."""
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, cf, coords, centers, pf):
            return self.m(coords, centers, cf, pf)

    class JaxCentersFirst:
        def apply(self, variables, cf, coords, centers, pf, **kw):
            return jmod.apply(variables, coords, centers, cf, pf, **kw)

    sd = {f"m.{k}": v for k, v in
          interop.pointnet_fp_to_sd(params, stats).items()}
    _check_module(JaxCentersFirst(), CentersFirst(tmod), sd, params, stats,
                  (args[2], args[0], args[1], args[3]),
                  (_t(cfeats), _t(coords), _t(centers), _t(pfeats)), 1)
