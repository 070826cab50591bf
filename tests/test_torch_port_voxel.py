"""The port's voxel ops (pcfm_torch/ops/voxel.py, ops/voxel_sorted.py)
against the JAX package's: the plain gather / scatter against the TPU
kernels ``gather_windows`` / ``scatter_windows`` (interpret mode, HIGHEST
precision, as tests/test_voxel_sorted.py runs them), the op-level wrappers
against ``avg_voxelize_sorted`` / ``trilinear_devoxelize_sorted`` and
``pcfm.ops.voxel``, in fp32 on the CPU.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
against those by the ``gpu`` tests at the bottom.  JAX is imported only in a
fixture, so that on a card without JAX the ``gpu`` tests run alone:

    python -m pytest tests/test_torch_port_voxel.py -m gpu --noconftest
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch.ops import voxel as tvox  # noqa: E402
from pcfm_torch.ops import voxel_sorted as tvs  # noqa: E402

# fp32 on both sides; the windowed HIGHEST-precision dots are exact
ATOL = 1e-5


@pytest.fixture
def jx(monkeypatch):
    """The JAX package's voxel modules, with exact (HIGHEST) window tiles
    as tests/test_voxel_sorted.py pins them."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import pcfm.ops.pallas.voxel_sorted as pvs
    import pcfm.ops.voxel as jvox
    import pcfm.ops.voxel_sorted as jvs
    monkeypatch.setattr(jvs, "DOT_PRECISION", jax.lax.Precision.HIGHEST)
    return types.SimpleNamespace(jax=jax, jnp=jnp, pvs=pvs, vox=jvox,
                                 vs=jvs)


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(b=2, n=500, seed=0):
    return np.random.RandomState(seed).randn(b, n, 3).astype(np.float32)


def _sorted_ids(pts, r):
    """Voxel ids and normalised coords of ``pts`` in stage-sort order."""
    nc, vc = tvox.normalize_coords(_t(pts), r)
    ids = tvox.flatten_voxel_ids(vc, r)
    perm = torch.argsort(ids, dim=1, stable=True)
    nc = torch.gather(nc, 1, perm[..., None].expand(-1, -1, 3))
    return torch.gather(ids, 1, perm), nc


# ------------------------------------------------------------ coordinates

def test_normalize_coords_and_corners_match_jax(jx):
    pts = _points(n=400)
    for r, eps in ((8, 0.0), (16, 1e-6), (32, 1e-6)):
        nc_j, vc_j = jx.vox.normalize_coords(jx.jnp.asarray(pts), r,
                                             eps=eps)
        nc, vc = tvox.normalize_coords(_t(pts), r, eps=eps)
        np.testing.assert_allclose(nc.numpy(), np.asarray(nc_j), atol=1e-5)
        np.testing.assert_array_equal(vc.numpy(), np.asarray(vc_j))
        assert vc.dtype == torch.int32 and nc.dtype == torch.float32
        np.testing.assert_array_equal(
            tvox.flatten_voxel_ids(vc, r).numpy(),
            np.asarray(jx.vox.flatten_voxel_ids(vc_j, r)))
        # corners from the same coords: ids exact, weights to fp32
        ids8_j, w8_j = jx.vox._corner_ids_weights(jx.jnp.asarray(nc_j), r)
        ids8, w8 = tvox.corner_ids_weights(_t(np.asarray(nc_j)), r)
        np.testing.assert_array_equal(ids8.numpy(), np.asarray(ids8_j))
        np.testing.assert_allclose(w8.numpy(), np.asarray(w8_j), atol=1e-7)
    # normalize=False maps [-1, 1] to [0, R-1]
    nc_j, vc_j = jx.vox.normalize_coords(jx.jnp.asarray(pts * 0.3), 8,
                                         normalize=False)
    nc, vc = tvox.normalize_coords(_t(pts * 0.3), 8, normalize=False)
    np.testing.assert_allclose(nc.numpy(), np.asarray(nc_j), atol=1e-5)
    np.testing.assert_array_equal(vc.numpy(), np.asarray(vc_j))


def test_plain_voxel_ops_match_jax(jx):
    pts = _points(n=300, seed=1)
    feats = np.random.RandomState(2).randn(2, 300, 7).astype(np.float32)
    nc_j, vc_j = jx.vox.normalize_coords(jx.jnp.asarray(pts), 8)
    want = np.asarray(jx.vox.avg_voxelize(jx.jnp.asarray(feats), vc_j, 8))
    got = tvox.avg_voxelize(_t(feats), _t(np.asarray(vc_j)), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    grid = np.random.RandomState(3).randn(2, 8, 8, 8, 7).astype(np.float32)
    want = np.asarray(jx.vox.trilinear_devoxelize(jx.jnp.asarray(grid),
                                                  nc_j, 8))
    got = tvox.trilinear_devoxelize(_t(grid), _t(np.asarray(nc_j)), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


# ------------------------------------------------------------ the kernels'
# plain versions against the TPU kernels

@pytest.mark.parametrize("k", [1, 8])
def test_plain_gather_matches_gather_windows(jx, k):
    b, n, c, r = 2, 500, 64, 8
    ids1, nc = _sorted_ids(_points(b, n, seed=4), r)
    rng = np.random.RandomState(5)
    grid = rng.randn(b, r ** 3, c).astype(np.float32)
    if k == 8:
        ids, w = tvs.corner_data(nc, r)
        base = ids[:, 0]
        reach, groups = r + 1, (0, r * r)
    else:
        ids = ids1[:, None, :].contiguous()
        w = _t(rng.rand(b, 1, n).astype(np.float32))
        base, reach, groups = ids1, 0, (0,)
    want = np.asarray(jx.pvs.gather_windows(
        jx.jnp.asarray(grid), jx.jnp.asarray(ids.numpy()),
        jx.jnp.asarray(w.numpy()), jx.jnp.asarray(base.numpy()), r,
        jx.pvs.pick_window(r, n, reach), reach=reach,
        precision=jx.jax.lax.Precision.HIGHEST, groups=groups,
        interpret=True))
    got = tvs.voxel_gather(_t(grid), ids, w)
    assert got.dtype == torch.float32 and got.shape == (b, n, c)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(
        tvs.voxel_gather_reference(_t(grid), ids, w).numpy(), want,
        atol=ATOL)


@pytest.mark.parametrize("k", [1, 8])
def test_plain_scatter_matches_scatter_windows(jx, k):
    b, n, c, r = 2, 500, 64, 8
    ids1, nc = _sorted_ids(_points(b, n, seed=6), r)
    rng = np.random.RandomState(7)
    upd = rng.randn(b, n, c).astype(np.float32)
    if k == 8:
        ids, w = tvs.corner_data(nc, r)
        base = ids[:, 0]
        reach, groups = r + 1, (0, r * r)
    else:
        ids = ids1[:, None, :].contiguous()
        w = _t(rng.rand(b, 1, n).astype(np.float32))
        base, reach, groups = ids1, 0, (0,)
    want = np.asarray(jx.pvs.scatter_windows(
        jx.jnp.asarray(upd), jx.jnp.asarray(ids.numpy()),
        jx.jnp.asarray(w.numpy()), jx.jnp.asarray(base.numpy()), r,
        jx.pvs.pick_window(r, n, reach), reach=reach,
        precision=jx.jax.lax.Precision.HIGHEST, groups=groups,
        interpret=True))
    plan = tvs.scatter_plan(ids, r ** 3)
    got = tvs.voxel_scatter(_t(upd), w, plan)
    assert got.dtype == torch.float32 and got.shape == (b, r ** 3, c)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_scatter_plan_rows_and_counts():
    b, n, r = 2, 500, 8
    ids = torch.from_numpy(np.random.RandomState(8).randint(
        0, r ** 3, (b, 8, n)).astype(np.int32))
    plan = tvs.scatter_plan(ids, r ** 3)
    assert plan.order.dtype == plan.rowptr.dtype == torch.int32
    assert plan.rowptr.shape == (b, r ** 3 + 1)
    for bb in range(b):
        flat = ids[bb].reshape(-1).numpy()
        np.testing.assert_array_equal(plan.counts()[bb].numpy(),
                                      np.bincount(flat, minlength=r ** 3))
        order = plan.order[bb].numpy()
        # voxel order, stable within a voxel
        np.testing.assert_array_equal(flat[order], np.sort(flat,
                                                           kind="stable"))
        np.testing.assert_array_equal(order,
                                      np.argsort(flat, kind="stable"))


# ------------------------------------------------------------ the scatter's
# work split (the kernel's chunks) and its two-level sum

def _rowptr(counts):
    return torch.from_numpy(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)[None])


def test_scatter_chunks_hand_worked():
    """Runs of 0, 3, E, 10 E + 1 and E + 1 entries (E = SCATTER_CHUNK):
    only runs longer than E are cut, into ceil(c / E) chunks."""
    e = tvs.SCATTER_CHUNK
    counts = [0, 3, e, 10 * e + 1, e + 1]
    rowptr = _rowptr(counts)
    entries = sum(counts)
    chunkptr, chunk_voxel = tvs.scatter_chunks(rowptr, entries)
    assert chunkptr.tolist() == [[0, 0, 0, 0, 11, 13]]
    assert chunk_voxel.dtype == torch.int32
    assert chunk_voxel.shape == (1, tvs.max_chunks(entries)) \
        == (1, 2 * entries // e)
    assert chunk_voxel[0, :13].tolist() == [3] * 11 + [4] * 2
    assert (chunk_voxel[0, 13:] == len(counts)).all()
    plan = tvs.ScatterPlan(ids=None, order=None, rowptr=rowptr,
                           num_rows=len(counts), chunkptr=chunkptr,
                           chunk_voxel=chunk_voxel, done=None)
    start, end = tvs.chunk_entries(plan)
    beg3 = 3 + e                               # the 10 E + 1 run's start
    assert start[0, :11].tolist() == [beg3 + i * e for i in range(11)]
    assert end[0, :11].tolist() == [beg3 + (i + 1) * e for i in range(10)] \
        + [beg3 + 10 * e + 1]
    assert start[0, 11:13].tolist() == [beg3 + 10 * e + 1,
                                        beg3 + 11 * e + 1]
    assert end[0, 12].item() == entries
    assert (start[0, 13:] == 0).all() and (end[0, 13:] == 0).all()


@pytest.mark.parametrize("k", [1, 8])
def test_chunks_cover_every_entry_once_in_order(k):
    """Short runs whole, long runs by their chunks in chunk order: every
    position of ``order`` once, in order, no chunk longer than E, and no
    more chunks than ``max_chunks``."""
    e = tvs.SCATTER_CHUNK
    rng = np.random.RandomState(17)
    n, v = 400, 64
    ids = rng.randint(0, v, (3, k, n)).astype(np.int32)
    ids[1] = 7                                 # one run of K * N entries
    ids[2, :, : n // 2] = 9                    # and a long run beside short
    plan = tvs.scatter_plan(torch.from_numpy(ids), v)
    start, end = tvs.chunk_entries(plan)
    for bb in range(3):
        rp, cp = plan.rowptr[bb].tolist(), plan.chunkptr[bb].tolist()
        assert cp[-1] <= plan.chunk_voxel.shape[1]
        covered = []
        for vox in range(v):
            if rp[vox + 1] - rp[vox] <= e:
                assert cp[vox + 1] == cp[vox]
                covered += range(rp[vox], rp[vox + 1])
                continue
            for j in range(cp[vox], cp[vox + 1]):
                assert plan.chunk_voxel[bb, j] == vox
                assert 0 < end[bb, j] - start[bb, j] <= e
                covered += range(int(start[bb, j]), int(end[bb, j]))
        assert covered == list(range(k * n))


@pytest.mark.parametrize("k", [1, 8])
def test_two_level_sum_matches_plain(k):
    """The kernel's sums emulated on the CPU (each chunk in order, then the
    partials in chunk order) against ``voxel_scatter_reference``, within
    chip_smoke.py's VOXEL_TOL: 1e-5 x sum |w x| + 1e-6."""
    rng = np.random.RandomState(18)
    b, n, c, r = 3, 500, 16, 8
    ids1, nc = _sorted_ids(_points(b, n, seed=19), r)
    if k == 8:
        ids, w = tvs.corner_data(nc, r)
    else:
        ids = ids1[:, None, :].contiguous()
        w = _t(rng.rand(b, 1, n).astype(np.float32))
    ids[2] = 100                               # a skewed cloud: one run
    upd = _t(rng.randn(b, n, c).astype(np.float32))
    plan = tvs.scatter_plan(ids, r ** 3)
    assert plan.chunkptr[2, -1] > 0            # the skewed run is cut
    got = tvs.voxel_scatter_chunked_reference(upd, w, plan)
    want = tvs.voxel_scatter_reference(upd, ids, w, r ** 3)
    mag = tvs.voxel_scatter_reference(upd.abs(), ids, w.abs(), r ** 3)
    assert ((got - want).abs() <= 1e-5 * mag + 1e-6).all()


def test_corner_plan_kept_in_stage_cache():
    cache = tvs.build_stage_cache(_t(_points(n=300, seed=20)), 8)
    plan8 = tvs.corner_plan(cache)
    assert tvs.corner_plan(cache) is plan8 and cache["plan8"] is plan8
    assert plan8.ids is cache["corners"][0] and plan8.num_rows == 512
    assert plan8.chunk_voxel.shape == (2, tvs.max_chunks(8 * 300))


# ------------------------------------------------------------ op level

def _avg_case(jx, sort):
    pts = _points(seed=9)
    feats = np.random.RandomState(10).randn(2, 500, 64).astype(np.float32)
    nc_j, vc_j = jx.vox.normalize_coords(jx.jnp.asarray(pts), 8)
    ids_j = jx.vox.flatten_voxel_ids(vc_j, 8)
    if sort:
        perm = jx.jnp.argsort(ids_j, axis=1)
        take = lambda a: jx.jnp.take_along_axis(  # noqa: E731
            a, perm[..., None] if a.ndim == 3 else perm, axis=1)
        feats = np.asarray(take(jx.jnp.asarray(feats)))
        nc_j, vc_j, ids_j = take(nc_j), take(vc_j), take(ids_j)
    return feats, nc_j, vc_j, ids_j


@pytest.mark.parametrize("sort", [True, False])
def test_avg_voxelize_sorted_matches_jax(jx, sort):
    """Sorted ids (contiguous counts) and unsorted ids (JAX's
    ``contiguous=False`` route, as a coarser stage under the stage-0 sort,
    tests/test_voxel_sorted.py:93,116): the port's plan takes both."""
    feats, nc_j, vc_j, ids_j = _avg_case(jx, sort)
    want_ref = np.asarray(jx.vox.avg_voxelize(jx.jnp.asarray(feats), vc_j,
                                              8)).reshape(2, 512, 64)
    want = np.asarray(jx.vs.avg_voxelize_sorted(
        jx.jnp.asarray(feats), ids_j, 8, True, sort))
    got = tvs.avg_voxelize_sorted(_t(feats), _t(np.asarray(ids_j)), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL)
    # the stage cache's plan and inverse counts give the same grid
    cache = tvs.build_stage_cache(_t(_points(seed=9)), 8)
    assert cache["plan"].ids.shape == (2, 1, 500)
    counts = cache["plan"].counts()
    np.testing.assert_allclose(
        cache["inv_pt"].numpy(),
        1.0 / counts.gather(1, cache["vox_ids"].long()).numpy())


@pytest.mark.parametrize("sort", [True, False])
def test_devoxelize_sorted_matches_jax(jx, sort):
    _, nc_j, _, _ = _avg_case(jx, sort)
    grid = np.random.RandomState(11).randn(2, 512, 64).astype(np.float32)
    want_ref = np.asarray(jx.vox.trilinear_devoxelize(
        jx.jnp.asarray(grid.reshape(2, 8, 8, 8, 64)), nc_j, 8))
    want = np.asarray(jx.vs.trilinear_devoxelize_sorted(
        jx.jnp.asarray(grid), nc_j, 8, True))
    got = tvs.trilinear_devoxelize_sorted(_t(grid), _t(np.asarray(nc_j)), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=ATOL)


def test_edge_coords_boundary_collapse(jx):
    """Points on voxel centres and on the R-1 boundary take the frac == 0
    corner collapse (tests/test_voxel_sorted.py:135)."""
    r = 4
    nc = np.asarray([[[0.0, 0.0, 0.0], [3.0, 3.0, 3.0], [1.5, 2.0, 3.0],
                      [2.0, 2.0, 2.0]]], np.float32)
    grid = np.random.RandomState(12).randn(1, r, r, r, 64).astype(np.float32)
    want = np.asarray(jx.vox.trilinear_devoxelize(jx.jnp.asarray(grid),
                                                  jx.jnp.asarray(nc), r))
    want_s = np.asarray(jx.vs.trilinear_devoxelize_sorted(
        jx.jnp.asarray(grid.reshape(1, r ** 3, 64)), jx.jnp.asarray(nc), r,
        True))
    got = tvs.trilinear_devoxelize_sorted(_t(grid.reshape(1, r ** 3, 64)),
                                          _t(nc), r)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_s, atol=1e-6)
    ids8, w8 = tvs.corner_data(_t(nc), r)
    # the point at (3, 3, 3): every corner collapses onto its own voxel
    assert set(ids8[0, :, 1].tolist()) == {63}
    assert float(w8[0, 0, 1]) == 1.0 and not w8[0, 1:, 1].any()


def test_sort_perm_and_permute_roundtrip(jx):
    pts = _points(n=40, seed=13)
    x = np.random.RandomState(14).randn(2, 40, 5).astype(np.float32)
    perm_j, _ = jx.vs.sort_perm_by_voxel(jx.jnp.asarray(pts), 8, eps=1e-6)
    perm, inv = tvs.sort_perm_by_voxel(_t(pts), 8, eps=1e-6)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(perm_j))
    y = tvs.permute_points(_t(x), perm, inv)
    np.testing.assert_array_equal(
        y.numpy(), np.take_along_axis(x, perm.numpy()[..., None], 1))
    np.testing.assert_array_equal(
        tvs.unpermute_points(y, perm, inv).numpy(), x)


def test_wrappers_refuse_bad_operands():
    grid = torch.zeros(2, 64, 16)
    with pytest.raises(ValueError, match="K in"):
        tvs.voxel_gather(grid, torch.zeros(2, 3, 10, dtype=torch.int32),
                         torch.zeros(2, 3, 10))
    with pytest.raises(ValueError, match="weights"):
        tvs.voxel_gather(grid, torch.zeros(2, 8, 10, dtype=torch.int32),
                         torch.zeros(2, 8, 11))
    plan = tvs.scatter_plan(torch.zeros(2, 1, 10, dtype=torch.int32), 64)
    with pytest.raises(ValueError, match="B=2, N=12"):
        tvs.voxel_scatter(torch.zeros(2, 12, 16), torch.zeros(2, 1, 10),
                          plan)
    with pytest.raises(ValueError, match="no kernel"):
        tvs.voxel_gather(grid.to("meta"),
                         torch.zeros(2, 1, 10, dtype=torch.int32),
                         torch.zeros(2, 1, 10))


def test_cpu_routes_count_no_launch():
    before = dict(tvs.launches)
    ids1, nc = _sorted_ids(_points(n=50, seed=15), 4)
    tvs.avg_voxelize_sorted(torch.randn(2, 50, 8), ids1, 4)
    tvs.trilinear_devoxelize_sorted(torch.randn(2, 64, 8), nc, 4)
    assert tvs.launches == before


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_case(dev, k, n, c, dtype, r=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    pts = torch.randn(2, n, 3, generator=g)
    ids1, nc = _sorted_ids(pts.numpy(), r)
    if k == 8:
        ids, w = tvs.corner_data(nc, r)
    else:
        ids = ids1[:, None, :].contiguous()
        w = torch.rand(2, 1, n, generator=g)
    dense = torch.randn(2, max(n, r ** 3), c, generator=g)
    return (ids.to(dev), w.to(dev),
            dense[:, :r ** 3].contiguous().to(dev, dtype),
            dense[:, :n].contiguous().to(dev, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("k", [1, 8])
def test_kernels_match_plain_versions(cuda, k, c, dtype):
    ids, w, grid, upd = _card_case(cuda, k, 300, c, dtype)
    before = dict(tvs.launches)
    got = tvs.voxel_gather(grid, ids, w)
    again = tvs.voxel_gather(grid, ids, w)
    plan = tvs.scatter_plan(ids, grid.shape[1])
    sc = tvs.voxel_scatter(upd, w, plan)
    sc_again = tvs.voxel_scatter(upd, w, plan)
    torch.cuda.synchronize()
    assert tvs.launches["voxel_gather"] == before["voxel_gather"] + 2
    assert tvs.launches["voxel_scatter"] == before["voxel_scatter"] + 2
    # both sum products of the same operands in fp32: only the order of
    # the sums can differ
    torch.testing.assert_close(got, tvs.voxel_gather_reference(grid, ids, w),
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(
        sc, tvs.voxel_scatter_reference(upd, ids, w, grid.shape[1]),
        atol=1e-5, rtol=1e-5)
    assert torch.equal(got, again) and torch.equal(sc, sc_again)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take(cuda):
    ids, w, grid, upd = _card_case(cuda, 8, 300, 64, torch.float32)
    with pytest.raises(ValueError, match="C % 8"):
        tvs.voxel_gather(grid[..., :12].contiguous(), ids, w)
    with pytest.raises(TypeError, match="int32"):
        tvs.voxel_gather(grid, ids.long(), w)
    with pytest.raises(ValueError, match="contiguous"):
        tvs.voxel_scatter(upd.transpose(0, 1).contiguous().transpose(0, 1),
                          w, tvs.scatter_plan(ids, grid.shape[1]))


@pytest.mark.gpu
def test_hybrid_sample_cli_on_card_goes_through_voxel_kernels(cuda, tmp_path):
    from pcfm_torch.config import Config
    from pcfm_torch.ops import film_block as fb
    from pcfm_torch.sample import cli
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle
    cfg = Config(pf_backbone="hybrid", latent_dim=16, pf_width=128,
                 pf_depth=3, pf_emb_dim=32, lf_width=64, lf_depth=3,
                 lf_emb_dim=16, enc_width=32, has_rgb=True, cond_dim=1,
                 ctx_dim=8, ctx_emb_dim=16, ctx_stage_channels=[16, 32],
                 ctx_stage_blocks=[1, 1], ctx_stage_res=[16, 8],
                 ctx_gn_groups=4, fused_trunk="on", sample_steps=2)
    checkpoint.save(str(tmp_path), 1, ModelBundle(
        cfg, "cpu", torch.Generator().manual_seed(10)))
    for extra in ([], ["--guidance_scale", "0.5"]):
        before = fb.launches, dict(tvs.launches)
        x = cli.main(["--out_dir", str(tmp_path), "--num_samples", "2",
                      "--n_points", "300", *extra])
        # 2 Heun steps x 2 evaluations (CFG in one batch): 2 FiLM blocks,
        # and one scatter and one gather for each of the 2 PVConvs
        assert fb.launches - before[0] == 8
        for name in ("voxel_gather", "voxel_scatter"):
            assert tvs.launches[name] - before[1][name] == 8
        assert x.shape == (2, 300, 6) and np.isfinite(x).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8])
def test_kernels_skewed_one_voxel(cuda, k, dtype):
    """Every point of each cloud in one voxel: one run of K * N entries,
    many chunks whose partial rows the last one to finish sums."""
    n, c, v = 3000, 64, 512
    g = torch.Generator().manual_seed(16)
    ids = torch.full((2, k, n), 300, dtype=torch.int32, device=cuda)
    w = torch.rand(2, k, n, generator=g).to(cuda)
    upd = torch.randn(2, n, c, generator=g).to(cuda, dtype)
    grid = torch.randn(2, v, c, generator=g).to(cuda, dtype)
    plan = tvs.scatter_plan(ids, v)
    assert int(plan.chunkptr[0, -1]) == -(-k * n // tvs.SCATTER_CHUNK)
    sc, sc_again = (tvs.voxel_scatter(upd, w, plan) for _ in range(2))
    got, again = (tvs.voxel_gather(grid, ids, w) for _ in range(2))
    torch.cuda.synchronize()
    ref = tvs.voxel_scatter_reference(upd, ids, w, v)
    # VOXEL_TOL: 1e-5 x sum |w x| + 1e-6
    mag = tvs.voxel_scatter_reference(upd.abs(), ids, w.abs(), v)
    assert ((sc - ref).abs() <= 1e-5 * mag + 1e-6).all()
    torch.testing.assert_close(got, tvs.voxel_gather_reference(grid, ids, w),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(sc, sc_again) and torch.equal(got, again)
    # the plan's counters of finished chunks are left at zero
    assert not plan.done.any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_voxel_backward_runs_the_kernels(cuda, dtype):
    """On the card the voxel ops' backward is a kernel: avg-voxelize's the
    K = 1 gather, devoxelize's the K = 8 scatter over the stage cache's
    corner plan (kept there), each one launch, the gradients within the
    plain versions' (CPU) of the same inputs (fp32 sums in another order;
    bf16: both cast the fp32 gradient to bf16)."""
    r, n, c = 8, 300, 64
    g = torch.Generator().manual_seed(17)
    pts = torch.randn(2, n, 3, generator=g)
    feats = torch.randn(2, n, c, generator=g)
    grid = torch.randn(2, r ** 3, c, generator=g)
    ct1 = torch.randn(2, r ** 3, c, generator=g)
    ct8 = torch.randn(2, n, c, generator=g)
    cpu_cache = tvs.build_stage_cache(pts, r)
    grads = {}
    for dev in ("cpu", cuda):
        # the same ids and weights on both (a knife-edge point may round
        # into another voxel on the card)
        cache = {k: cpu_cache[k].to(dev) for k in ("norm_coords", "vox_ids",
                                                    "inv_pt")}
        cache["corners"] = tuple(x.to(dev) for x in cpu_cache["corners"])
        cache["plan"] = tvs.scatter_plan(cpu_cache["plan"].ids.to(dev),
                                         r ** 3)
        f = feats.to(dev, dtype).detach().requires_grad_(True)
        gr = grid.to(dev, dtype).detach().requires_grad_(True)
        a = tvs.avg_voxelize_sorted(f, cache["vox_ids"], r,
                                    plan=cache["plan"],
                                    inv_pt=cache["inv_pt"])
        d = tvs.trilinear_devoxelize_sorted(gr, cache["norm_coords"], r,
                                            cache=cache)
        before = dict(tvs.launches)
        ((a * ct1.to(dev)).sum() + (d * ct8.to(dev)).sum()).backward()
        launched = {k: tvs.launches[k] - before[k] for k in before}
        assert launched == ({"voxel_gather": 1, "voxel_scatter": 1}
                            if dev != "cpu" else dict.fromkeys(before, 0))
        assert "plan8" in cache and f.grad.dtype == dtype
        grads[dev != "cpu"] = (f.grad.float().cpu(), gr.grad.float().cpu())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in zip(grads[True], grads[False]):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
