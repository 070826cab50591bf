"""The hybrid velocity with ContextNet stage widths that are not multiples
of 8, against the JAX package on the CPU.

The JAX sorted-window kernels take any channel count (their channel block
is the whole row up to C = 256), and so do the port's voxel kernels since
their slices follow C (pcfm_torch/csrc/voxel_common.cuh ``vec_for``).  On
the CPU the port runs its plain versions; the kernels at these widths are
held against those on the card (tests/test_torch_port_voxel.py, ``gpu``
cases, and chip_smoke.py).  Weights go JAX -> port through
``pcfm_torch.interop.hybrid_to_sd``, as in tests/test_torch_port_hybrid.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pcfm.nn.pvconv as jpvconv  # noqa: E402
import pcfm.ops.voxel_sorted as jvs  # noqa: E402
from pcfm import models as jm  # noqa: E402
from pcfm_torch import interop  # noqa: E402
from pcfm_torch.models import HybridMLP  # noqa: E402
from pcfm_torch.ops import voxel_sorted as tvs  # noqa: E402
from tests.test_torch_port_hybrid import (ATOL, _inputs,  # noqa: E402
                                          _moved, _t)

GEN = dict(generator=torch.Generator().manual_seed(0))


@pytest.fixture(params=["xla", "sorted"])
def backend(request, monkeypatch):
    """A JAX voxel backend with its exact (fp32) routes, as
    tests/test_torch_port_hybrid.py sets them."""
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    if request.param == "sorted":
        monkeypatch.setattr(jpvconv, "SORTED_N_MIN", 0)
        monkeypatch.setattr(jpvconv, "SORTED_R3_MIN", 0)
        monkeypatch.setattr(jvs, "DOT_PRECISION", jax.lax.Precision.HIGHEST)
    return request.param


# stage widths with C % 8 = 4 (the 8-byte bf16 slices on the card) and an
# odd one (one channel a slice); the Config's [100, 200, 200] cut to size
@pytest.mark.parametrize("channels", [(12, 20), (36, 37)])
def test_hybrid_velocity_with_odd_stage_channels_matches_jax(backend,
                                                             channels):
    kw = dict(cond_dim=5, point_dim=6, ctx_dim=8, ctx_emb_dim=16,
              stage_channels=channels, stage_blocks=(1, 1),
              stage_res=(16, 8), with_se=True, gn_groups=4, with_global=True,
              pf_width=128, pf_depth=3, pf_emb_dim=16)
    jnet = jm.HybridMLP(voxel_backend=backend, dtype=jnp.float32,
                        ctx_island_dtype=jnp.float32, fused_trunk="on", **kw)
    x, t, c = _inputs(11)
    v = jnet.init(jax.random.PRNGKey(11), jnp.asarray(x), jnp.asarray(t),
                  jnp.asarray(c), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 12)
    want = jnet.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
                      train=False)
    net = HybridMLP(dtype=torch.float32, ctx_island_dtype=torch.float32,
                    fused_trunk="on", **kw, **GEN)
    net.load_state_dict(interop.hybrid_to_sd(params, stats))
    before = dict(tvs.launches)
    with torch.no_grad():
        got = net.eval()(_t(x), _t(t), _t(c))
    assert tvs.launches == before                    # CPU: plain versions
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
