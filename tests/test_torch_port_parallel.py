"""The port's data and point-axis parallel training (pcfm_torch.parallel)
against one rank, and its process grid against the JAX package's mesh,
on the CPU (tests/test_torch_port_parallel_jax.py holds the sharded step
against JAX's).

Ranks are processes joined over gloo (tests/torch_parallel_workers.py).
Tolerances are tests/test_parallel.py's for JAX's sharded step against
its one-device step: the loss within LOSS_RTOL, the parameters after the
steps within PARAM_RTOL and PARAM_ATOL (mlp) or PARAM_ATOL_HYBRID; the
gradients after the all-reduce within GRAD_TOL of each gradient's max
(fp32: the all-reduce adds the ranks' partial sums in another order than
one rank's sum).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from pcfm.parallel import make_mesh  # noqa: E402
from pcfm.parallel import mesh as jax_mesh  # noqa: E402
from pcfm_torch.parallel import mesh  # noqa: E402
from tests import torch_parallel_workers as tw  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL, PARAM_ATOL_HYBRID = 5e-3, 5e-5, 1e-4
GRAD_TOL = 1e-4
STEPS = 3


def tiny_cfg(**kw):
    """tests/test_parallel.py's tiny_cfg (with the ContextNet in fp32, as
    the JAX package computes it on the CPU)."""
    base = dict(pf_backbone="mlp", latent_dim=16, enc_width=16, enc_depth=4,
                pf_width=32, pf_depth=3, pf_emb_dim=16, lf_width=32,
                lf_depth=3, lf_emb_dim=16, warmup_steps=0, amp=False,
                has_rgb=True, cond_dim=2, pointflow_rgb=True,
                use_rgb_in_latent=True, ctx_dtype="fp32")
    base.update(kw)
    return base


HYBRID = dict(pf_backbone="hybrid", ctx_dim=8, ctx_emb_dim=16,
              ctx_stage_channels=[8], ctx_stage_blocks=[1],
              ctx_stage_res=[4])
MODELS = {"mlp": tiny_cfg(), "hybrid": tiny_cfg(**HYBRID)}
LAYOUTS = [(2, 1), (1, 2), (2, 2)]


def _batch(b=8, n=32, seed=1):
    rng = np.random.RandomState(seed)
    return {"pts": rng.randn(b, n, 3).astype(np.float32),
            "rgb": rng.rand(b, n, 3).astype(np.float32),
            "cond": rng.randn(b, 2).astype(np.float32)}


def _close_to_max(got, want, rel, where=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, where
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, where


# ------------------------------------------------------------ the grid

@pytest.mark.parametrize("args", [
    (8, 32, -1, 1, 8), (8, 32, 4, 2, 8), (8, 32, -1, 4, 8), (6, 30, -1, 4, 8),
    (4, 32, 8, 1, 8), (8, 20000, 2, 2, 4), (3, 7, -1, 2, 2)])
def test_auto_mesh_sizes_matches_jax(args):
    assert mesh.auto_mesh_sizes(*args) == jax_mesh.auto_mesh_sizes(*args)


class _FakeDev:
    def __init__(self, pi):
        self.process_index = pi


def _grid(dp, sp, rank):
    return mesh.ProcessGrid(dp, sp, rank, mesh.Axis(None, dp, rank // sp),
                            mesh.Axis(None, sp, rank % sp),
                            mesh.Axis(None, dp * sp, rank))


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2), (4, 2), (2, 4)])
def test_data_axis_shard_and_blocks_match_jax(dp, sp):
    """One process a device, laid out as make_mesh's reshape(dp, sp): the
    loader shard of every rank is JAX's (tests/test_parallel.py:218-266's
    grouping), and its block of a global batch is the shard JAX places on
    its device."""
    devs = np.array([[_FakeDev(d * sp + p) for p in range(sp)]
                     for d in range(dp)])
    by_proc, keys = jax_mesh._data_axis_groups(devs, ("data", "points"))
    jmesh = make_mesh(dp, sp)
    batch = _batch(b=8, n=32)
    placed = jax.device_put(batch["pts"], jax_mesh.batch_sharding(jmesh))
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for rank in range(dp * sp):
        grid = _grid(dp, sp, rank)
        assert mesh.data_axis_shard(grid) == (
            keys.index(frozenset(by_proc[rank])), len(keys))
        mine = mesh.shard_batch(batch, grid)
        np.testing.assert_array_equal(
            mine["pts"], shards[jmesh.devices[rank // sp, rank % sp]])
        np.testing.assert_array_equal(mine["cond"], batch["cond"][
            mesh.batch_block(grid, 8)])
    assert mesh.data_axis_shard(None) == (0, 1)


def test_grid_size_rule():
    assert mesh.mesh_sizes(8, -1, 2, 32) == (4, 2)
    assert mesh.mesh_sizes(4, 2, 2, 32) == (2, 2)
    for world, dp, sp, n in ((4, 3, 1, 32), (4, 1, 3, 32), (4, 1, 2, 33),
                             (4, 8, 1, 32)):
        with pytest.raises(ValueError):
            mesh.mesh_sizes(world, dp, sp, n)


# ------------------------------------------------------------ the step

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every (layout, model) case for STEPS steps: the two-rank layouts in
    one spawn, (2, 2) in another, and each on one rank."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    batch = _batch()
    out = {}
    for world in (2, 4):
        cases = [(f"{m}_{dp}{sp}", kw, dp, sp, batch, STEPS, None, None)
                 for dp, sp in LAYOUTS if dp * sp == world
                 for m, kw in MODELS.items()]
        tw.run_ranks(tw.step_cases, world, tmp, cases)
        for name, kw, dp, sp, *_ in cases:
            out[name] = [torch.load(f"{tmp}/{name}.rank{r}.pt")
                         for r in range(world)]
    ref = {m: tw.train_steps(kw, tw.tensors(batch), STEPS)
           for m, kw in MODELS.items()}
    return out, ref


CASES = [pytest.param(dp, sp, m, id=f"{m}-dp{dp}-sp{sp}")
         for dp, sp in LAYOUTS for m in MODELS]


@pytest.mark.parametrize("dp,sp,model", CASES)
def test_sharded_step_matches_one_rank(sharded, dp, sp, model):
    out, ref = sharded
    ranks, one = out[f"{model}_{dp}{sp}"], ref[model]
    for i in range(STEPS):
        for k, v in one["metrics"][i].items():
            np.testing.assert_allclose(ranks[0]["metrics"][i][k], v,
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
    assert set(ranks[0]["grads"]) == set(one["grads"])
    for k, want in one["grads"].items():
        _close_to_max(ranks[0]["grads"][k].numpy(), want.numpy(), GRAD_TOL,
                      f"grad {k}")
    atol = PARAM_ATOL if model == "mlp" else PARAM_ATOL_HYBRID
    for k, want in one["params"].items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(),
                                   want.numpy(), rtol=PARAM_RTOL, atol=atol,
                                   err_msg=k)
    for k, want in one["buffers"].items():   # the BatchNorm statistics
        np.testing.assert_allclose(ranks[0]["buffers"][k].float().numpy(),
                                   want.float().numpy(), rtol=PARAM_RTOL,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("dp,sp,model", CASES)
def test_params_stay_bitwise_equal_across_ranks(sharded, dp, sp, model):
    ranks = sharded[0][f"{model}_{dp}{sp}"]
    for r in ranks[1:]:
        for part in ("params", "buffers", "grads"):
            for k, v in ranks[0][part].items():
                assert torch.equal(r[part][k], v), (part, k)
        assert r["metrics"] == ranks[0]["metrics"]


def test_each_rank_takes_its_local_card(monkeypatch):
    """cuda:LOCAL_RANK unless the caller names a card; a local rank with no
    card is an error, not a second rank on cuda:0."""
    from pcfm_torch.parallel.distributed import cuda_device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert cuda_device("cuda") == torch.device("cuda", 1)
    assert cuda_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2"):
        cuda_device("cuda")
