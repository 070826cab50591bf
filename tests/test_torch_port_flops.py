"""The port's model-FLOP counter (pcfm_torch/utils/flops.py) against the
JAX package's (pcfm/utils/flops.py): the same train step and velocity
evaluation, counted in both, must read the same FLOPs exactly (the
hybrid's less the one-hot dots of JAX's dense voxel route, which the
port's gathers and scatters do not have); the kernels' formula hooks must
read what their plain versions' products read; ``mfu`` as the JAX one."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pcfm.ops.voxel as jvox  # noqa: E402
from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.train import state as jax_state  # noqa: E402
from pcfm.train.step import make_train_step  # noqa: E402
from pcfm.utils import flops as jflops  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.ops import chamfer  # noqa: E402
from pcfm_torch.ops import film_block as fb  # noqa: E402
from pcfm_torch.ops import voxel_sorted as tvs  # noqa: E402
from pcfm_torch.train import state, step  # noqa: E402
from pcfm_torch.train.evaluate import eval_mode  # noqa: E402
from pcfm_torch.utils import flops  # noqa: E402

B, N = 2, 64
BASE = dict(latent_dim=16, enc_width=32, enc_depth=4, pf_width=128,
            pf_depth=3, pf_emb_dim=32, lf_width=64, lf_depth=3,
            lf_emb_dim=16, amp=False, has_rgb=True, cond_dim=1,
            warmup_steps=0, batch_size=B, tr_max_sample_points=N)
# two dense stages in JAX (R^3 <= DENSE_R3_MAX): one-hot dots to subtract
HYBRID = dict(pf_backbone="hybrid", ctx_stage_channels=[16, 32],
              ctx_stage_blocks=[1, 2], ctx_stage_res=[8, 4], ctx_gn_groups=4,
              ctx_emb_dim=32, ctx_dim=16, voxel_backend="xla")


def _batch():
    rng = np.random.RandomState(0)
    return {"pts": rng.randn(B, N, 3).astype(np.float32),
            "rgb": rng.rand(B, N, 3).astype(np.float32),
            "cond": rng.rand(B, 1).astype(np.float32)}


def _jax_abstract(jcfg):
    """(bundle, state's shapes, tx) without running the initialisers:
    the count traces, it does not execute."""
    bundle = jax_state.ModelBundle(jcfg)
    tx = jax_state.make_optimizer(jcfg, 10)
    st = jax.eval_shape(lambda k: jax_state.init_state(jcfg, k, 10)[1],
                        jax.random.PRNGKey(0))
    return bundle, st, tx


def _jax_step_flops(jcfg) -> int:
    bundle, st, tx = _jax_abstract(jcfg)
    fn = make_train_step(bundle, tx, donate=False)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    return jflops.count_matmul_flops(fn, st, batch, jax.random.PRNGKey(1),
                                     jnp.float32(1.0), jnp.float32(0.1))


def _jax_nfe_flops(jcfg) -> int:
    bundle, st, _ = _jax_abstract(jcfg)
    x = jnp.zeros((B, N, jcfg.pf_point_dim))
    t, c = jnp.zeros((B,)), jnp.zeros((B, jcfg.pf_cond_dim))
    return jflops.count_matmul_flops(
        lambda p, s: bundle.apply_pf(p, s, x, t, c, None, train=False)[0],
        st.params["pf"], st.batch_stats["pf"])


def _port_step_flops(cfg) -> tuple:
    st = state.init_state(cfg, "cpu", 10, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    with flops.FlopCount() as count:
        m = step.train_step(st, batch, torch.Generator().manual_seed(0),
                            1.0, 0.1)
    return count.total, float(m["loss"])


def _port_nfe_flops(cfg) -> tuple:
    bundle = state.ModelBundle(cfg, "cpu", torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, N, cfg.pf_point_dim, generator=g)
    t, c = torch.rand(B, generator=g), torch.randn(B, cfg.pf_cond_dim,
                                                   generator=g)
    with torch.no_grad(), eval_mode(bundle.pf), flops.FlopCount() as count:
        v = bundle.pf(x, t, c)
    return count.total, v


def _one_hot_dots(jcfg, train: bool) -> int:
    """The FLOPs of JAX's dense voxel route in one hybrid call, counted by
    the JAX counter on pcfm/ops/voxel.py's own functions at each dense
    stage's shapes, once per PVConv (voxelize, then devoxelize; in a
    train step their transposes too)."""
    total = 0
    for r, c, blocks in zip(jcfg.ctx_stage_res, jcfg.ctx_stage_channels,
                            jcfg.ctx_stage_blocks):
        if r ** 3 > jvox.DENSE_R3_MAX:
            continue
        feats = jnp.zeros((B, N, c))
        grid = jnp.zeros((B, r, r, r, c))
        vox = jnp.zeros((B, N, 3), jnp.int32)
        coords = jnp.zeros((B, N, 3))

        def both(f, g):
            return (jnp.sum(jvox.avg_voxelize_dense(f, vox, r))
                    + jnp.sum(jvox.trilinear_devoxelize_dense(g, coords, r)))

        fn = jax.grad(both, argnums=(0, 1)) if train else both
        total += blocks * jflops.count_matmul_flops(fn, feats, grid)
    return total


@pytest.mark.parametrize("fused", ["off", "on"])
def test_mlp_train_step_count_equals_jax(fused):
    """The plain trunk against JAX's plain trunk, exactly; the kernel trunk
    (its plain versions on the CPU) reads the same.  JAX's count of its
    own kernel trunk drops the trunk (its counter skips ``pallas_call``)."""
    cfg = Config(**BASE, fused_trunk=fused)
    want = _jax_step_flops(JaxConfig(**BASE, fused_trunk="off"))
    got, loss = _port_step_flops(cfg)
    assert np.isfinite(loss)
    assert got == want
    if fused == "on":
        jax_fused = _jax_step_flops(JaxConfig(**BASE, fused_trunk="on"))
        trunk = (cfg.pf_depth - 1) * 6 * B * N * cfg.pf_width ** 2
        assert want - jax_fused == trunk


def test_hybrid_train_step_count_equals_jax_less_one_hot_dots():
    kw = dict(BASE, **HYBRID, fused_trunk="off")
    jcfg = JaxConfig(**kw)
    dots = _one_hot_dots(jcfg, train=True)
    # 2 B N R^3 C a voxelize and a devoxelize, each with its transpose
    assert dots == sum(4 * blocks * 2 * B * N * r ** 3 * c for r, c, blocks
                       in zip(jcfg.ctx_stage_res, jcfg.ctx_stage_channels,
                              jcfg.ctx_stage_blocks))
    got, _ = _port_step_flops(Config(**kw))
    assert got == _jax_step_flops(jcfg) - dots


@pytest.mark.parametrize("backbone", ["mlp", "hybrid"])
def test_velocity_evaluation_count_equals_jax(backbone):
    kw = dict(BASE, fused_trunk="off",
              **(HYBRID if backbone == "hybrid" else {}))
    jcfg = JaxConfig(**kw)
    dots = _one_hot_dots(jcfg, train=False) if backbone == "hybrid" else 0
    got, _ = _port_nfe_flops(Config(**kw))
    assert got == _jax_nfe_flops(jcfg) - dots > 0


def _stub_kernels(monkeypatch):
    """The FiLM kernels' launches replaced by their plain versions (run
    unseen by the counter, as a kernel is): CPU tensors take the kernel
    path, and only the formula hooks count the kernels' math.  The voxel
    kernels, which count 0, go through ``use_kernel`` to their plain
    versions, which have no product to count."""
    monkeypatch.setattr(fb, "use_kernel", lambda x, what: True)
    for name, plain in (("_launch", fb.film_block_reference_forward),
                        ("_launch_bwd", fb.film_block_reference_backward)):
        monkeypatch.setattr(getattr(fb, name), "launch", plain)


@pytest.fixture
def stubbed_kernels(monkeypatch):
    _stub_kernels(monkeypatch)


@pytest.mark.parametrize("backbone", ["mlp", "hybrid"])
def test_formula_hooks_equal_the_plain_versions(backbone):
    """The same train step and velocity evaluation, kernel trunk: counted
    through the plain versions (seen by the counter), then with the
    kernels stubbed by them (only the formulas seen): equal counts, equal
    results."""
    kw = dict(BASE, fused_trunk="on",
              **(HYBRID if backbone == "hybrid" else {}))
    plain_step, plain_loss = _port_step_flops(Config(**kw))
    plain_nfe, plain_v = _port_nfe_flops(Config(**kw))
    with pytest.MonkeyPatch.context() as mp:
        _stub_kernels(mp)
        before = fb.launches
        hooked_step, hooked_loss = _port_step_flops(Config(**kw))
        hooked_nfe, hooked_v = _port_nfe_flops(Config(**kw))
        assert fb.launches == before          # the stubs launch nothing
    assert hooked_step == plain_step and hooked_nfe == plain_nfe
    assert hooked_loss == plain_loss
    torch.testing.assert_close(hooked_v, plain_v, rtol=0, atol=0)


def test_kernel_formulas(stubbed_kernels):
    g = torch.Generator().manual_seed(0)
    bsz, n, c = 2, 5, 128
    h = torch.randn(bsz, n, c, generator=g, requires_grad=True)
    s, t = torch.randn(c, generator=g), torch.randn(c, generator=g)
    gamma, beta = torch.randn(bsz, c, generator=g), torch.randn(
        bsz, c, generator=g)
    w = torch.randn(c, c, generator=g, requires_grad=True)
    b = torch.randn(c, generator=g)
    with flops.FlopCount() as fwd:
        y = fb.film_block(h, s, t, gamma, beta, w, b)
    with flops.FlopCount() as bwd:
        y.sum().backward()
    assert fwd.total == fwd.by_op["kernels"] == 2 * bsz * n * c * c
    assert bwd.total == bwd.by_op["kernels"] == 4 * bsz * n * c * c
    # chamfer and the voxel ops are no model math: their plain versions
    # have no product to count, and their kernels carry no formula
    q = torch.randn(2, 7, 3, generator=g)
    grid = torch.randn(2, 9, 4, generator=g)
    ids = torch.randint(0, 9, (2, 8, 7), generator=g)
    wts = torch.rand(2, 8, 7, generator=g)
    with flops.FlopCount() as other:
        chamfer.chamfer_nn(q, q, [0, 1], [1, 0])
        out = tvs.voxel_gather(grid, ids, wts)
        tvs.voxel_scatter(out, wts, tvs.scatter_plan(ids, 9))
    assert other.total == 0


def test_counts_nest_and_close():
    a = torch.randn(4, 8)
    w = torch.randn(8, 3)
    with flops.FlopCount() as outer:
        a @ w
        with flops.FlopCount() as inner:
            a @ w
    a @ w                                     # after both closed
    assert inner.total == 2 * 4 * 8 * 3 and outer.total == 2 * inner.total
    assert flops.count_matmul_flops(torch.matmul, a, w) == inner.total
    assert not flops._ACTIVE


def test_mfu_matches_jax():
    for f, s in ((1.26e12, 0.011), (3e9, 2.5e-3), (989e12, 1.0)):
        assert flops.mfu(f, s) == jflops.mfu(
            f, s, peak=flops.H100_BF16_DENSE_PEAK)
        assert flops.mfu(f, s, peak=jflops.V5E_BF16_PEAK) == \
            jflops.mfu(f, s)
    assert flops.mfu(989e12, 1.0) == 1.0
    assert np.isnan(flops.mfu(100, 0.0)) and np.isnan(jflops.mfu(100, 0.0))
    assert np.isnan(flops.mfu(100, float("inf")))
