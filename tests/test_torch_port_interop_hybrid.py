"""The port's reference-checkpoint importer against the JAX package's on
reference-format ``hybrid`` checkpoints: tests/test_torch_port_interop.py's
hybrid forward-parity cases (the imported live and EMA point flows against
the mirror and the JAX package's imported run at FWD_ATOL, the fp32
ContextNet island on both sides), in a file of their own for the time of
JAX's hybrid compiles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pcfm.nn.pvconv as jpvconv  # noqa: E402
from pcfm import interop as jinterop  # noqa: E402
from pcfm_torch.train.evaluate import eval_mode  # noqa: E402
from tests.test_torch_port_interop import (  # noqa: E402
    FWD_ATOL, _hybrid_ckpt, _import, _t)


@pytest.fixture
def exact_jax_voxels(monkeypatch):
    """JAX's fp32 scatter / gather route (its dense one-hot route rounds
    the trilinear weights to bf16)."""
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)


def _hybrid_parity(tmp_path, ckpt, net_t, seed):
    _, _, cfg, bundle = _import(tmp_path, ckpt)
    assert cfg.ctx_dtype == "fp32"
    jcfg = jinterop.config_from_reference_args(ckpt["args"],
                                               cond_dim=ckpt["cond_dim"])
    assert jcfg.ctx_dtype == "fp32"
    jb, jst, _ = jinterop.state_from_reference_ckpt(ckpt, jcfg)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 30, cfg.pf_point_dim).astype(np.float32)
    t = rng.rand(2).astype(np.float32)
    c = rng.randn(2, cfg.pf_cond_dim).astype(np.float32)
    with torch.no_grad():
        want = net_t(_t(x), _t(t), _t(c)).numpy()
    jax_pf = jax.jit(lambda p_, s_, x_, t_, c_: jb.apply_pf(
        p_, s_, x_, t_, c_, None, train=False)[0])
    for module, (p, s) in ((bundle.pf, (jst.params["pf"],
                                        jst.batch_stats["pf"])),
                           (bundle.ema_pf, (jst.ema_pf["params"],
                                            jst.ema_pf["batch_stats"]))):
        with torch.no_grad(), eval_mode(module):
            got = module(_t(x), _t(t), _t(c)).numpy()
        jgot = jax_pf(p, s, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
        np.testing.assert_allclose(got, want, atol=FWD_ATOL)
        np.testing.assert_allclose(got, np.asarray(jgot), atol=FWD_ATOL)
    return cfg, bundle, jst


def test_import_hybrid_forward_parity(tmp_path, exact_jax_voxels):
    ckpt, net_t, *_ = _hybrid_ckpt(3)
    _hybrid_parity(tmp_path, ckpt, net_t, seed=5)


def test_import_hybrid_batchnorm_forward_parity(tmp_path, exact_jax_voxels):
    """ctx_norm='batch': the per-FiLM and head BatchNorms' running
    statistics are carried as they are."""
    ckpt, net_t, *_ = _hybrid_ckpt(11, norm="batch", blocks=2,
                                   with_global=False)
    key = "ctx_net.stages.0.blocks.0.film.norm.running_mean"
    assert key in ckpt["pf"]
    cfg, bundle, jst = _hybrid_parity(tmp_path, ckpt, net_t, seed=6)
    torch.testing.assert_close(bundle.pf.state_dict()[key], ckpt["pf"][key],
                               rtol=0, atol=0)
    film_bn = jst.batch_stats["pf"]["ctx_net"]["stage_0"]["block_0"][
        "film"]["norm"]["bn"]
    np.testing.assert_allclose(np.asarray(film_bn["mean"]),
                               ckpt["pf"][key].numpy(), atol=0)
