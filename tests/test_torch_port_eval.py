"""The port's evaluation path (pcfm_torch.ops.chamfer / emd / sampling, the
dopri5 sampler, eval_oversample, pcfm_torch.eval) against the JAX package,
in fp32 on the CPU, on the same numpy inputs.

Tolerances, each with its reason:
  * chamfer distances rtol 1e-5, atol 1e-7: both take the winner's
    distance in fp32 difference form; indices exact (the inputs hold no
    near ties);
  * EMD values and gradients rtol 1e-4: the same fp32 algorithm, matrix
    products and sums in another order;
  * FPS indices, COV and 1-NNA exact.

On the CPU the chamfer wrapper runs its plain version; the CUDA kernel is
held against that by the ``gpu`` tests at the bottom.  JAX is imported only
in a fixture, so that on a card without JAX the ``gpu`` tests run alone:

    python -m pytest tests/test_torch_port_eval.py -m gpu --noconftest
"""
import contextlib
import io
import json
import math
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.eval import cli as eval_cli  # noqa: E402
from pcfm_torch.eval import metrics  # noqa: E402
from pcfm_torch.ops import chamfer, emd, sampling  # noqa: E402
from pcfm_torch.sample import integrators as tint  # noqa: E402
from pcfm_torch.train import checkpoint  # noqa: E402
from pcfm_torch.train.state import ModelBundle  # noqa: E402
from tests import oracles  # noqa: E402

CD_RTOL, CD_ATOL = 1e-5, 1e-7
EMD_RTOL = 1e-4


@pytest.fixture
def jx():
    """The JAX package's evaluation modules."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from pcfm.eval import metrics as jmetrics
    from pcfm.ops import chamfer as jchamfer
    from pcfm.ops import emd as jemd
    from pcfm.ops import sampling as jsampling
    from pcfm.ops.pallas import chamfer_distance_pallas_v3
    from pcfm.sample import integrators as jint
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, metrics=jmetrics, chamfer=jchamfer, emd=jemd,
        sampling=jsampling, pallas_v3=chamfer_distance_pallas_v3, int=jint)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _clouds(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_chamfer(got, want):
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=CD_RTOL, atol=CD_ATOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _grad_close(got, want, rtol=EMD_RTOL):
    """rtol of each element, with an absolute floor of rtol x max |want|
    for the elements near 0."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ------------------------------------------------------------ chamfer

@pytest.mark.parametrize("n,m,d", [(300, 250, 3), (700, 500, 3),
                                   (64, 90, 6)])
def test_chamfer_matches_jax_and_the_pallas_kernel(jx, n, m, d):
    a, b = _clouds(0, 2, n, d), _clouds(1, 2, m, d)
    got = [x.numpy() for x in chamfer.chamfer_distance(_t(a), _t(b),
                                                       chunk=128)]
    _assert_chamfer(got, jx.chamfer.chamfer_distance(
        jx.jnp.asarray(a), jx.jnp.asarray(b), chunk=128))
    if d == 3:      # the TPU kernel, interpreted (its width is padded to 8)
        _assert_chamfer(got, jx.pallas_v3(jx.jnp.asarray(a),
                                          jx.jnp.asarray(b),
                                          interpret=True))


def test_chamfer_matches_double_oracle():
    a, b = _clouds(2, 3, 257, 3), _clouds(3, 3, 129, 3)
    got = [x.numpy() for x in chamfer.chamfer_distance(_t(a), _t(b))]
    want = oracles.chamfer_np(a, b)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,m", [(1, 40), (40, 1), (1, 1)])
def test_chamfer_single_point(jx, n, m):
    a, b = _clouds(4, 2, n, 3), _clouds(5, 2, m, 3)
    got = [x.numpy() for x in chamfer.chamfer_distance(_t(a), _t(b))]
    _assert_chamfer(got, jx.chamfer.chamfer_distance(jx.jnp.asarray(a),
                                                     jx.jnp.asarray(b)))


def test_chamfer_ties_go_to_the_lowest_index():
    base = _clouds(6, 2, 50, 3)
    # every target point twice, the copy 50 indices later; a query on a
    # target point itself
    target = np.concatenate([base, base], axis=1)
    query = np.concatenate([base[:, ::-1], _clouds(7, 2, 30, 3)], axis=1)
    d1, d2, i1, i2 = chamfer.chamfer_distance(_t(query), _t(target))
    assert int(i1.max()) < 50
    np.testing.assert_array_equal(i1[:, :50].numpy(),
                                  np.arange(50)[::-1][None].repeat(2, 0))
    assert float(d1[:, :50].abs().max()) == 0.0
    # both copies of a target find the same query point
    np.testing.assert_array_equal(i2[:, :50].numpy(), i2[:, 50:].numpy())


def test_chamfer_pairs_form_matches_per_pair_calls():
    q, t = _clouds(8, 4, 70, 3), _clouds(9, 3, 55, 3)
    qi, ti = [0, 3, 3, 1, 2, 0], [2, 0, 1, 1, 2, 0]
    dist, idx = chamfer.chamfer_nn(_t(q), _t(t), qi, ti)
    assert dist.shape == (6, 70) and idx.dtype == torch.int32
    for p, (a, b) in enumerate(zip(qi, ti)):
        d1, _, i1, _ = chamfer.chamfer_distance(_t(q[a:a + 1]),
                                                _t(t[b:b + 1]))
        torch.testing.assert_close(dist[p], d1[0], rtol=0, atol=0)
        torch.testing.assert_close(idx[p], i1[0], rtol=0, atol=0)


def test_chamfer_gradient_matches_jax_grad(jx):
    a, b = _clouds(10, 2, 40, 3), _clouds(11, 2, 30, 3)
    w1, w2 = _clouds(12, 2, 40), _clouds(13, 2, 30)

    def jloss(a_, b_):
        d1, d2, _, _ = jx.chamfer.chamfer_distance(a_, b_)
        return jx.jnp.sum(d1 * w1) + jx.jnp.sum(d2 * w2)

    ga, gb = jx.jax.grad(jloss, argnums=(0, 1))(jx.jnp.asarray(a),
                                                jx.jnp.asarray(b))
    ta, tb = _t(a, grad=True), _t(b, grad=True)
    d1, d2, _, _ = chamfer.chamfer_distance(ta, tb)
    ((d1 * _t(w1)).sum() + (d2 * _t(w2)).sum()).backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga),
                               rtol=CD_RTOL, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb),
                               rtol=CD_RTOL, atol=1e-6)
    # chamfer_l2 is differentiable too
    ta.grad = None
    chamfer.chamfer_l2(ta, tb).sum().backward()
    assert torch.isfinite(ta.grad).all() and ta.grad.abs().max() > 0


def test_chamfer_nn_refuses_bad_pairs():
    q, t = torch.zeros(2, 5, 3), torch.zeros(3, 4, 3)
    with pytest.raises(ValueError, match="indices"):
        chamfer.chamfer_nn(q, t, [0, 2], [0, 1])
    with pytest.raises(ValueError, match="indices"):
        chamfer.chamfer_nn(q, t, [0], [-1])
    with pytest.raises(ValueError, match="one length"):
        chamfer.chamfer_nn(q, t, [0, 1], [0])
    with pytest.raises(ValueError, match="one D"):
        chamfer.chamfer_nn(q, torch.zeros(3, 4, 2), [0], [0])
    with pytest.raises(ValueError, match="one point"):
        chamfer.chamfer_nn(q, torch.zeros(3, 0, 3), [0], [0])


def test_cpu_calls_count_no_launch():
    before = chamfer.launches
    a, b = torch.randn(2, 30, 3), torch.randn(2, 20, 3)
    chamfer.chamfer_distance(a, b)
    metrics.cd_matrix(a, b)
    assert chamfer.launches == before


# ------------------------------------------------------------ EMD

@pytest.mark.parametrize("n,m", [(64, 64), (64, 40), (30, 70)])
def test_emd_matches_jax_values_and_grads(jx, n, m):
    a, b = _clouds(14, 2, n, 3), _clouds(15, 2, m, 3) * 0.7
    w = np.array([1.0, -0.5], np.float32)

    def jloss(a_, b_):
        return jx.jnp.sum(jx.emd.earth_mover_distance(a_, b_) * w)

    want = jx.emd.earth_mover_distance(jx.jnp.asarray(a), jx.jnp.asarray(b))
    ga, gb = jx.jax.grad(jloss, argnums=(0, 1))(jx.jnp.asarray(a),
                                                jx.jnp.asarray(b))
    ta, tb = _t(a, grad=True), _t(b, grad=True)
    got = emd.earth_mover_distance(ta, tb)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=EMD_RTOL)
    np.testing.assert_allclose(got.detach().numpy(), oracles.emd_np(a, b),
                               rtol=EMD_RTOL)
    _grad_close(ta.grad.numpy(), ga)
    _grad_close(tb.grad.numpy(), gb)


def test_approxmatch_matches_jax(jx):
    a, b = _clouds(16, 2, 40, 3), _clouds(17, 2, 25, 3)
    got = emd.approxmatch(_t(a), _t(b))
    want = jx.emd.approxmatch(jx.jnp.asarray(a), jx.jnp.asarray(b))
    assert got.shape == (2, 25, 40)
    # the match's entries are sensitive to fp32 rounding (exp(-16384 d^2)
    # of near-equal distances): JAX and the float64 oracle differ by
    # 1.2e-3 of the largest entry at these inputs; the cost, the contract,
    # is held at rtol 1e-4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-3)
    np.testing.assert_allclose(
        emd.matchcost(_t(a), _t(b), got).numpy(),
        np.asarray(jx.emd.matchcost(jx.jnp.asarray(a), jx.jnp.asarray(b),
                                    want)), rtol=EMD_RTOL)


@pytest.mark.parametrize("n,m,chunk", [(256, 256, 64), (192, 128, 64)])
def test_emd_streamed_matches_jax_values_and_grads(jx, n, m, chunk):
    a, b = _clouds(18, 2, n, 3), _clouds(19, 2, m, 3) + 0.3

    def jloss(a_, b_):
        return jx.jnp.sum(jx.emd.earth_mover_distance_streamed(
            a_, b_, chunk=chunk))

    want = jx.emd.earth_mover_distance_streamed(
        jx.jnp.asarray(a), jx.jnp.asarray(b), chunk=chunk)
    ga, gb = jx.jax.grad(jloss, argnums=(0, 1))(jx.jnp.asarray(a),
                                                jx.jnp.asarray(b))
    ta, tb = _t(a, grad=True), _t(b, grad=True)
    got = emd.earth_mover_distance_streamed(ta, tb, chunk=chunk)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=EMD_RTOL)
    _grad_close(ta.grad.numpy(), ga)
    _grad_close(tb.grad.numpy(), gb)
    # and the dense formulation, gradients included
    da, db = _t(a, grad=True), _t(b, grad=True)
    dense = emd.earth_mover_distance(da, db)
    dense.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(),
                               dense.detach().numpy(), rtol=EMD_RTOL)
    _grad_close(ta.grad.numpy(), da.grad.numpy())


def test_emd_streamed_needs_a_common_chunk():
    with pytest.raises(ValueError, match="divisible"):
        emd.earth_mover_distance_streamed(torch.zeros(1, 300, 3),
                                          torch.zeros(1, 256, 3), chunk=256)


# ------------------------------------------------------------ FPS

def test_fps_matches_jax_and_oracle(jx):
    x = _clouds(20, 3, 400, 3)
    got = sampling.furthest_point_sample_indices(_t(x), 37).numpy()
    assert got.dtype == np.int32 and (got[:, 0] == 0).all()
    np.testing.assert_array_equal(got, np.asarray(
        jx.sampling.furthest_point_sample_indices(jx.jnp.asarray(x), 37)))
    np.testing.assert_array_equal(got, oracles.fps_np(x, 37))
    pts = sampling.furthest_point_sample(_t(x), 37)
    np.testing.assert_array_equal(
        pts.numpy(), np.take_along_axis(x, got[..., None].astype(int), 1))


# ------------------------------------------------------------ dopri5

def _field_jax(jnp):
    def field(x, t, cond):
        c = 0.0 if cond is None else jnp.sum(cond, -1)[:, None, None]
        return -x * (1.0 + t[:, None, None]) + jnp.sin(3.0 * x) + 0.1 * c
    return field


def _field_torch(x, t, cond):
    c = 0.0 if cond is None else cond.sum(-1)[:, None, None]
    return -x * (1.0 + t[:, None, None]) + torch.sin(3.0 * x) + 0.1 * c


@pytest.mark.parametrize("guidance", [0.0, 0.5])
def test_dopri5_matches_jax(jx, guidance):
    x0, cond = _clouds(21, 3, 11, 6), _clouds(22, 3, 4)
    want = np.asarray(jx.int.dopri5_sample(
        _field_jax(jx.jnp), jx.jnp.asarray(x0), 5,
        cond=jx.jnp.asarray(cond), guidance_scale=guidance))
    assert tint.get_sampler("dopri5") is tint.dopri5_sample
    got = tint.get_sampler("dopri5")(_field_torch, _t(x0), 5, cond=_t(cond),
                                     guidance_scale=guidance).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dopri5_warns_when_truncated(jx):
    x0 = _clouds(23, 2, 5, 3)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        want = np.asarray(jx.int.dopri5_sample(
            _field_jax(jx.jnp), jx.jnp.asarray(x0), 2, max_steps=2))
    with pytest.warns(UserWarning, match="max_steps=2 exhausted"):
        got = tint.dopri5_sample(_field_torch, _t(x0), 2, max_steps=2)
    assert any("PARTIAL" in str(r.message) for r in rec)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a full run does not warn
        tint.dopri5_sample(_field_torch, _t(x0), 2)


# ------------------------------------------------------------ metrics

@pytest.mark.parametrize("n,m,emd_max", [(128, 96, 4096), (512, 512, 256)])
def test_cloud_metrics_match_jax(jx, n, m, emd_max):
    # (128, 96): the exact EMD; (512, 512) over 256 points: streamed
    pred, gt = _clouds(24, 2, n, 6), _clouds(25, 2, m, 3) * 0.5
    want = jx.metrics.cloud_metrics(jx.jnp.asarray(pred),
                                    jx.jnp.asarray(gt),
                                    emd_max_points=emd_max,
                                    fscore_threshold=0.1)
    got = metrics.cloud_metrics(_t(pred), _t(gt), emd_max_points=emd_max,
                                fscore_threshold=0.1)
    assert list(got) == list(want)
    for k in ("cd", "fscore", "precision", "recall"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=CD_RTOL, err_msg=k)
    np.testing.assert_allclose(got["emd"].numpy(), np.asarray(want["emd"]),
                               rtol=EMD_RTOL)
    agg = metrics.aggregate([got, got])
    want_agg = jx.metrics.aggregate([want, want])
    assert list(agg) == list(want_agg)
    for k, v in want_agg.items():
        np.testing.assert_allclose(agg[k], v, rtol=EMD_RTOL, err_msg=k)


def test_cloud_metrics_subsampled_emd():
    # no common chunk >= 256 of 600 and 500: EMD on 256-point subsamples
    pred, gt = _t(_clouds(26, 1, 600, 3)), _t(_clouds(27, 1, 500, 3))
    a = metrics.cloud_metrics(pred, gt, emd_max_points=256)
    b = metrics.cloud_metrics(pred, gt, emd_max_points=256)
    assert torch.equal(a["emd"], b["emd"])        # the clouds fix the draw
    g = torch.Generator().manual_seed(3)
    c = metrics.cloud_metrics(pred, gt, emd_max_points=256, generator=g)
    assert torch.isfinite(c["emd"]).all() and not torch.equal(a["emd"],
                                                              c["emd"])


def test_aggregate_weights_by_clouds():
    got = metrics.aggregate([{"cd": np.array([1.0, 3.0])},
                             {"cd": np.array([5.0])}])
    assert got == {"cd": 3.0}


@pytest.mark.parametrize("metric,rtol", [("cd", CD_RTOL), ("emd", EMD_RTOL)])
def test_cd_matrix_matches_jax(jx, metric, rtol):
    a, b = _clouds(28, 5, 64, 3), _clouds(29, 4, 48, 6) + 0.2
    want = jx.metrics.cd_matrix(a, b, pair_block=2, metric=metric)
    got = metrics.cd_matrix(a, b, pair_block=2, metric=metric)
    assert got.shape == (5, 4) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=rtol)
    with pytest.raises(ValueError, match="unknown metric"):
        metrics.cd_matrix(a, b, metric="l1")


def test_cd_matrix_splits_pairs_into_blocks(monkeypatch):
    a, b = torch.randn(3, 20, 3), torch.randn(4, 30, 3)
    whole = metrics.cd_matrix(a, b)
    monkeypatch.setattr(metrics, "MATRIX_PAIR_ELEMS", 30 * 5)  # 5 pairs
    np.testing.assert_array_equal(metrics.cd_matrix(a, b), whole)


def test_generative_metrics_match_jax(jx):
    ref = _clouds(30, 6, 48, 3)
    gen = _clouds(31, 5, 48, 3) * 0.8 + 0.1
    want = jx.metrics.generative_metrics(gen, ref, pair_block=4,
                                         metrics=("cd", "emd"))
    got = metrics.generative_metrics(gen, ref, pair_block=4,
                                     metrics=("cd", "emd"))
    assert list(got) == list(want)
    for k, v in want.items():
        if k.startswith(("cov", "nna")):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=EMD_RTOL, err_msg=k)


# ------------------------------------------------------------ eval_oversample

def test_sample_fn_eval_oversample_applies_fps(jx):
    from pcfm.train.evaluate import _cond_full as jax_cond_full
    from pcfm.train.state import ModelBundle as JaxBundle
    from pcfm_torch.train.evaluate import make_sample_fn
    from tests.test_torch_port_sample import (_jax_state, _port_bundle,
                                              _small_cfgs)
    cfg, jcfg = _small_cfgs(eval_oversample=1.5, sample_steps=2,
                            latent_sample_steps=2)
    state = _jax_state(jcfg, seed=5)
    b, n = 2, 40
    n_gen = math.ceil(n * 1.5)
    z0 = _clouds(32, b, cfg.latent_dim)
    x0 = _clouds(33, b, n_gen, cfg.pf_point_dim)
    cond = _clouds(34, b, cfg.cond_dim)
    # the JAX package's make_sample_fn body on the same priors
    jb, jnp = JaxBundle(jcfg), jx.jnp
    js = jx.int.get_sampler("heun")
    z = js(jb.lf_velocity_fn(state.ema_lf["params"]), jnp.asarray(z0), 2)
    x = js(jb.pf_velocity_fn(state.ema_pf["params"], {}), jnp.asarray(x0),
           2, cond=jax_cond_full(jcfg, z, jnp.asarray(cond)))
    idx = jx.sampling.furthest_point_sample_indices(x[..., :3], n)
    want = np.asarray(jnp.take_along_axis(x, idx[..., None], axis=1))

    sample = make_sample_fn(_port_bundle(cfg, state))
    got = sample(_t(cond), None, b, n, z0=_t(z0), x0=_t(x0)).numpy()
    assert got.shape == (b, n, cfg.pf_point_dim)
    np.testing.assert_allclose(got, want, atol=1e-4)
    # drawn priors: ceil(1.5 N) integrated points, N kept
    g = torch.Generator().manual_seed(0)
    assert sample(None, g, b, n).shape == (b, n, cfg.pf_point_dim)


# ------------------------------------------------------------ the eval CLI

def test_pad_batch():
    x = torch.arange(12.0).reshape(3, 4)
    y = eval_cli.pad_batch(x, 5)
    assert y.shape == (5, 4)
    torch.testing.assert_close(y[:3], x)
    torch.testing.assert_close(y[3], x[-1])
    assert eval_cli.pad_batch(None, 5) is None
    assert eval_cli.pad_batch(x, 3) is x


TINY_RUN = dict(dataset_type="synthetic", pf_backbone="mlp", latent_dim=16,
                enc_width=16, enc_depth=4, pf_width=32, pf_depth=3,
                pf_emb_dim=16, lf_width=32, lf_depth=3, lf_emb_dim=16,
                amp=False, batch_size=4, tr_max_sample_points=32,
                te_max_sample_points=32, has_rgb=True, cond_dim=1,
                sample_steps=2)


def _keys(out):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in out.items()}


def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue().strip().splitlines()[-1]


def test_eval_cli_on_cpu_gives_the_jax_keys(jx, tmp_path):
    from pcfm.config import Config as JaxConfig
    from pcfm.eval.cli import main as jax_main
    from pcfm.train import checkpoint as jax_ckpt
    from pcfm.train.state import init_state
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    checkpoint.save(port_dir, 1, ModelBundle(
        Config(**TINY_RUN), "cpu", torch.Generator().manual_seed(0)))
    jcfg = JaxConfig(**TINY_RUN)
    _, jstate, _ = init_state(jcfg, jx.jax.random.PRNGKey(0), total_steps=1)
    jax_ckpt.save(jax_dir, 1, jstate, jcfg, async_save=False)

    before = chamfer.launches
    for argv in (["--mode", "both", "--max_batches", "2",
                  "--emd_max_points", "16"],
                 ["--mode", "suite", "--max_batches", "2", "--suite_emd",
                  "--suite_seeds", "3,4"],
                 ["--mode", "suite", "--max_batches", "1", "--seed", "3"]):
        want, _ = _quiet(jax_main, ["--out_dir", jax_dir, *argv])
        got, line = _quiet(eval_cli.main, ["--out_dir", port_dir, *argv,
                                           "--device", "cpu"])
        assert json.loads(line) == got
        assert list(got) == list(want) and _keys(got) == _keys(want)
        if "per_seed" in got:
            assert [list(r) for r in got["per_seed"]] == \
                [list(r) for r in want["per_seed"]]
            assert got["n_clouds"] == want["n_clouds"] == 8
        for k, v in got.items():
            if k not in ("epoch", "sampler", "seeds", "per_seed"):
                vals = v.values() if isinstance(v, dict) else [v]
                assert all(np.isfinite(x) for x in vals), k
    assert chamfer.launches == before                     # CPU: no kernel


def test_eval_cli_seed_fixes_the_suite(tmp_path):
    run = str(tmp_path / "port")
    checkpoint.save(run, 1, ModelBundle(Config(**TINY_RUN), "cpu",
                                        torch.Generator().manual_seed(1)))
    argv = ["--out_dir", run, "--mode", "suite", "--max_batches", "2",
            "--device", "cpu"]
    band, _ = _quiet(eval_cli.main, argv + ["--suite_seeds", "5,6"])
    single, _ = _quiet(eval_cli.main, argv + ["--suite_seeds", "5"])
    assert band["seeds"] == [5, 6] and len(band["per_seed"]) == 2
    assert single["nna_cd"] == band["per_seed"][0]["nna_cd"]
    assert single["mmd_cd"] == band["per_seed"][0]["mmd_cd"]
    for k in ("nna_cd", "cov_cd", "mmd_cd"):
        assert band[k]["min"] <= band[k]["mean"] <= band[k]["max"]


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _check_nn(query, target, qi, ti, dist, idx):
    """The kernel's (dist, idx) against the plain version on the card:
    distances within 1e-6 * max(d) + 1e-9 (the same fp32 difference form,
    the fused multiply-adds aside), indices equal unless the chosen
    neighbour's plain distance is within that of the best."""
    ref_d, ref_i = chamfer.chamfer_nn_reference(query, target, qi, ti)
    tol = 1e-6 * float(ref_d.max()) + 1e-9
    assert float((dist - ref_d).abs().max()) <= tol
    qq = query[torch.as_tensor(qi, device=query.device).long()]
    tt = target[torch.as_tensor(ti, device=query.device).long()]
    chosen = ((qq - torch.gather(tt, 1, idx.long()[..., None].expand(
        -1, -1, tt.shape[-1]))) ** 2).sum(-1)
    differ = idx != ref_i
    if differ.any():
        assert float((chosen - ref_d)[differ].abs().max()) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 3, 6, 8])
def test_chamfer_kernel_matches_plain_version(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(d)
    a = torch.randn(3, 1000, d, device=cuda, generator=g)
    b = torch.randn(3, 777, d, device=cuda, generator=g)
    before = chamfer.launches
    got = chamfer.chamfer_distance(a, b)
    again = chamfer.chamfer_distance(a, b)
    torch.cuda.synchronize()
    assert chamfer.launches == before + 4
    pairs = [0, 1, 2]
    _check_nn(a, b, pairs, pairs, got[0], got[2])
    _check_nn(b, a, pairs, pairs, got[1], got[3])
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_chamfer_kernel_ties_and_pairs_form(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    base = torch.randn(2, 1500, 3, device=cuda, generator=g)
    target = torch.cat([base, base], dim=1)        # copies 1500 later
    query = torch.randn(2, 900, 3, device=cuda, generator=g)
    _, _, i1, _ = chamfer.chamfer_distance(query, target)
    assert int(i1.max()) < 1500
    sets = torch.randn(5, 300, 3, device=cuda, generator=g)
    qi = torch.arange(5).repeat_interleave(5)
    ti = torch.arange(5).repeat(5)
    dist, idx = chamfer.chamfer_nn(sets, sets, qi, ti)
    _check_nn(sets, sets, qi, ti, dist, idx)
    diag = dist.reshape(5, 5, 300).diagonal().T
    assert float(diag.abs().max()) == 0.0


def _clouds_on(cuda, case: str):
    """Adversarial (query, target) stacks for the kernel's screen: shifted
    clouds, an integer lattice with exact ties, clouds sorted along x, D = 8,
    and sizes off every tile (128 queries a block; 256 targets a tile, 32 a
    group, 8 an mma; 256 seeds)."""
    g = torch.Generator(device=cuda).manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, device=cuda, generator=g)

    def by_x(x):
        return torch.gather(x, 1, x[..., :1].argsort(dim=1).expand(
            -1, -1, x.shape[-1])).contiguous()

    if case.startswith("shift"):
        shift = float(case.split("_")[1])
        return rnd(2, 1500, 3) + shift, rnd(2, 1300, 3) + shift
    if case == "lattice":
        return tuple(torch.randint(0, 8, (2, n, 3), device=cuda,
                                   generator=g).float() for n in (1500, 1300))
    if case == "sorted":
        return by_x(rnd(2, 1500, 3)), by_x(rnd(2, 1300, 3))
    if case == "sorted_d8":
        return by_x(rnd(2, 1000, 8)), by_x(rnd(2, 777, 8))
    if case == "ragged":
        return rnd(3, 129, 3), rnd(3, 263, 3)
    return rnd(2, 301, 3), rnd(2, 5, 3)          # fewer targets than an mma


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["shift_1e2", "shift_1e4", "lattice",
                                  "sorted", "sorted_d8", "ragged", "few"])
def test_chamfer_kernel_on_adversarial_clouds(cuda, case):
    a, b = _clouds_on(cuda, case)
    got = chamfer.chamfer_distance(a, b)
    again = chamfer.chamfer_distance(a, b)
    torch.cuda.synchronize()
    pairs = list(range(a.shape[0]))
    _check_nn(a, b, pairs, pairs, got[0], got[2])
    _check_nn(b, a, pairs, pairs, got[1], got[3])
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    if case == "lattice":       # exact ties: the lowest index, as argmin
        for (q, t, idx) in ((a, b, got[2]), (b, a, got[3])):
            ref_i = chamfer.chamfer_nn_reference(q, t, pairs, pairs)[1]
            assert torch.equal(idx, ref_i)


@pytest.mark.gpu
@pytest.mark.parametrize("d,shift", [(3, 0.0), (3, 1e4), (8, 0.0)])
def test_chamfer_screen_error_within_the_kernels_bound(cuda, d, shift):
    """The tensor cores' screen against its plain version: within
    SCREEN_KAPPA (|a~| + |b~|)^2, the bound the kernel's margin assumes."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(700, d, device=cuda, generator=g) + shift
    t = torch.randn(900, d, device=cuda, generator=g) + shift
    s = chamfer.screen(q, t).double()
    exact, scale = chamfer.screen_reference(q, t)
    assert float(((s - exact).abs() / scale).max()) <= chamfer.SCREEN_KAPPA


@pytest.mark.gpu
def test_chamfer_kernel_gives_a_nan_query_a_valid_index(cuda):
    """No share of a query with a NaN coordinate passes its threshold: it
    keeps index 0 (with +inf), the other queries' results do not move, and
    the gradient path gathers in range."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn(2, 300, 3, device=cuda, generator=g)
    b = torch.randn(2, 270, 3, device=cuda, generator=g)
    clean = chamfer.chamfer_nn(a, b, [0, 1], [0, 1])
    a[1, 7, 2] = float("nan")
    dist, idx = chamfer.chamfer_nn(a, b, [0, 1], [0, 1])
    back = chamfer.chamfer_nn(b, a, [0, 1], [0, 1])[1]
    assert int(idx[1, 7]) == 0 and float(dist[1, 7]) == float("inf")
    assert 0 <= int(idx.min()) and int(idx.max()) < 270
    assert 0 <= int(back.min()) and int(back.max()) < 300
    rest = torch.ones_like(idx, dtype=torch.bool)
    rest[1, 7] = False
    assert torch.equal(dist[rest], clean[0][rest])
    assert torch.equal(idx[rest], clean[1][rest])
    a.requires_grad_(True)
    b.requires_grad_(True)
    d1, d2, _, _ = chamfer.chamfer_distance(a, b)
    (d1.nan_to_num(0.0).sum() + d2.sum()).backward()
    torch.cuda.synchronize()
    assert torch.isfinite(b.grad[0]).all()     # the pair without the NaN


@pytest.mark.gpu
def test_chamfer_kernel_refuses_what_it_does_not_take(cuda):
    a = torch.randn(2, 10, 9, device=cuda)
    with pytest.raises(ValueError, match="D <= 8"):
        chamfer.chamfer_nn(a, a, [0], [0])
    with pytest.raises(TypeError, match="fp32"):
        chamfer.chamfer_nn(a[..., :3].double().contiguous(),
                           a[..., :3].double().contiguous(), [0], [0])
    with pytest.raises(ValueError, match="contiguous"):
        chamfer.chamfer_nn(a[..., :3], a[..., :3].contiguous(), [0], [0])


@pytest.mark.gpu
def test_eval_cli_on_card_goes_through_the_chamfer_kernel(cuda, tmp_path):
    run = str(tmp_path / "run")
    checkpoint.save(run, 1, ModelBundle(Config(**TINY_RUN), "cpu",
                                        torch.Generator().manual_seed(2)))
    before = chamfer.launches
    out = eval_cli.main(["--out_dir", run, "--mode", "both",
                         "--max_batches", "2", "--emd_max_points", "16"])
    # 2 protocols x 2 batches x one chamfer_distance (2 launches)
    assert chamfer.launches - before == 8
    assert np.isfinite(out["recon_cd"]) and np.isfinite(out["gen_emd"])
    before = chamfer.launches
    out = eval_cli.main(["--out_dir", run, "--mode", "suite",
                         "--max_batches", "2", "--suite_emd"])
    # 3 cd matrices (gen-ref, gen-gen, ref-ref), 2 launches each
    assert chamfer.launches - before == 6
    assert 0.0 <= out["nna_cd"] <= 1.0 and np.isfinite(out["mmd_emd"])
