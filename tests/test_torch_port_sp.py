"""The port's point-axis parallel ops (pcfm_torch.parallel) against one
rank, on the CPU: two ranks over gloo hold a cloud's two halves of points
(sp = 2), or two halves of the batch (dp = 2), and every output and
gradient must be the one-rank one's (its block, or the replica itself).

Tolerances: fp32; the all-reduced sums add the ranks' partial sums in
another order than one rank's sum, so values agree to a few fp32 ulps of
the sums (OUT_TOL of each output's max, GRAD_TOL of each gradient's max);
the voxel ids and counts, and the max and its ties, are exact.  The loss
terms run through the whole train step: the losses within LOSS_RTOL (as
tests/test_parallel.py's sharded step), every gradient within GRAD_TOL of
its max.  A parameter gradient that is 0 in exact arithmetic (a bias
that a normalisation after it cancels) holds only rounding: it is held
against the largest parameter gradient of its case.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import torch_parallel_workers as tw  # noqa: E402

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL = 2e-4
B, N, C = 2, 64, 8


def _close_to_max(got, want, rel, where="", floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    assert float(np.abs(got - want).max()) <= rel * scale, where


def _inputs():
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    pts = rng.randn(B, N, 3) * 0.5
    return {
        "pts": t(pts), "feat": t(rng.randn(B, N, C)),
        "ct_grid": t(rng.randn(B, tw.R ** 3, C)),
        "grid": t(rng.randn(B, tw.R ** 3, C)),
        "ct_pts": t(rng.randn(B, N, C)),
        "gn_w": t(1.0 + 0.3 * rng.randn(C)), "gn_b": t(0.3 * rng.randn(C)),
        # values on a coarse lattice: the max has ties within and across
        # the two halves
        "ties": t(np.round(rng.randn(B, N, C) * 2.0) / 2.0),
        "ct_code": t(rng.randn(B, C)),
        "ct_z": t(rng.randn(B, 8)),
        "x": t(np.concatenate([pts, rng.rand(B, N, 3)], -1)),
        "t": t(rng.rand(B)), "cond": t(rng.randn(B, 2)),
        "ct_ctx": t(rng.randn(B, N, 8)),
    }


OPS = ("normalize", "counts", "voxelize", "devoxelize", "groupnorm",
       "global_max", "encoder", "context_group", "context_batch")


@pytest.fixture(scope="module")
def sp_ops(tmp_path_factory):
    """Every op on two ranks at sp = 2 (one spawn), and on one rank."""
    tmp = str(tmp_path_factory.mktemp("sp_ops"))
    inp = _inputs()
    cases = [(name, getattr(tw, f"op_{name}"), inp) for name in OPS]
    tw.run_ranks(tw.op_cases, 2, tmp, 1, 2, cases)
    out = {}
    for name in OPS:
        torch.manual_seed(0)
        one = getattr(tw, f"op_{name}")(None, inp)
        ranks = [torch.load(f"{tmp}/{name}.rank{r}.pt") for r in range(2)]
        out[name] = (one, ranks)
    return out


# outputs cut over the points (the rest are replicas: every rank's is the
# whole one-rank value)
POINT_OUTPUTS = {("normalize", "nc"), ("normalize", "vc"),
                 ("counts", "inv_pt"), ("counts", "ids"),
                 ("devoxelize", "out"), ("groupnorm", "out"),
                 ("context_group", "out"), ("context_batch", "out")}


@pytest.mark.parametrize("name", OPS)
def test_sp_op_matches_one_rank(sp_ops, name):
    one, ranks = sp_ops[name]
    assert set(ranks[0]) == set(one), name
    half = N // 2
    floor = max([float(v.abs().max()) for k, v in one.items()
                 if k.startswith("param/")] or [0.0])
    for key, want in one.items():
        if key.startswith("param/"):          # a replica's: summed
            got = ranks[0][key] + ranks[1][key]
        elif key.startswith("stat/"):         # running statistics
            got = ranks[0][key]
            assert torch.equal(got, ranks[1][key]), key
        elif (name, key) in POINT_OUTPUTS or key == "grad":
            got = torch.cat([r[key] for r in ranks], dim=1)
            assert got.shape[1] == 2 * half
        else:
            got = ranks[0][key]
            assert torch.equal(got, ranks[1][key]), key
        exact = key in ("vc", "ids", "inv_pt") or name == "global_max"
        if exact:
            assert torch.equal(got, want), (name, key)
        else:
            tol = OUT_TOL if key in ("out", "nc") else GRAD_TOL
            _close_to_max(got.numpy(), want.numpy(), tol, f"{name}/{key}",
                          floor if key.startswith("param/") else 1e-30)


def test_a_voxel_spans_the_ranks(sp_ops):
    """The cases hold voxels with points on both ranks, so the global
    counts differ from each rank's own."""
    _, ranks = sp_ops["counts"]
    ids = [r["ids"] for r in ranks]
    assert all(set(ids[0][b].tolist()) & set(ids[1][b].tolist())
               for b in range(B))
    own = [1.0 / torch.bincount(i[0].long(), minlength=tw.R ** 3)[i[0].long()]
           .float() for i in ids]
    assert not torch.equal(own[0], ranks[0]["inv_pt"][0])


def test_global_max_has_ties_across_ranks(sp_ops):
    one, ranks = sp_ops["global_max"]
    hits = [(r["grad"] != 0).sum(dim=1) for r in ranks]
    assert bool(((hits[0] > 0) & (hits[1] > 0)).any())
    assert bool((hits[0] + hits[1] > 1).any())


# ------------------------------------------------------------ loss terms

def _tiny(**kw):
    base = dict(pf_backbone="mlp", latent_dim=16, enc_width=16, enc_depth=4,
                pf_width=32, pf_depth=3, pf_emb_dim=16, lf_width=32,
                lf_depth=3, lf_emb_dim=16, warmup_steps=0, amp=False,
                has_rgb=True, cond_dim=2, pointflow_rgb=True,
                use_rgb_in_latent=True)
    base.update(kw)
    return base


TERMS = {  # name: (config, dp, sp, the metric the term logs)
    "var": (_tiny(lambda_var=0.5), 2, 1, "loss_var"),
    "cov": (_tiny(lambda_cov=0.05), 2, 1, "loss_cov"),
    "emd": (_tiny(lambda_emd=0.1), 1, 2, "loss_emd"),
    "sliced_ot": (_tiny(fm_coupling="sliced_ot"), 1, 2, "loss_point"),
    "pair": (_tiny(lambda_pair=0.2), 1, 2, "loss_pair"),
}


def _batch(b=4, n=32, seed=2):
    rng = np.random.RandomState(seed)
    return {"pts": rng.randn(b, n, 3).astype(np.float32) * 0.5,
            "rgb": rng.rand(b, n, 3).astype(np.float32),
            "cond": rng.randn(b, 2).astype(np.float32)}


@pytest.fixture(scope="module")
def loss_terms(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("terms"))
    batch = _batch()
    cases = [(name, kw, dp, sp, batch, 1, None, None)
             for name, (kw, dp, sp, _) in TERMS.items()]
    tw.run_ranks(tw.step_cases, 2, tmp, cases)
    return {name: (tw.train_steps(kw, tw.tensors(batch), 1),
                   [torch.load(f"{tmp}/{name}.rank{r}.pt")
                    for r in range(2)])
            for name, (kw, *_) in TERMS.items()}


@pytest.mark.parametrize("name", list(TERMS))
def test_loss_term_matches_one_rank(loss_terms, name):
    one, ranks = loss_terms[name]
    metric = TERMS[name][3]
    for r in ranks:
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(r["metrics"][0][k], v,
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{name}: {k}")
    assert one["metrics"][0][metric] > 0
    for k, want in one["grads"].items():
        _close_to_max(ranks[0]["grads"][k].numpy(), want.numpy(), GRAD_TOL,
                      f"{name}: grad {k}")
        assert torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k])
