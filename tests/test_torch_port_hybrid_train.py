"""Hybrid training in the port (BatchNorm training statistics, the voxel
ops' autograd Functions, the hybrid train step and CLI) against the JAX
package, on the CPU.

Weights go JAX -> port through ``pcfm_torch.interop`` (params and
BatchNorm statistics, moved off their init values); inputs, cotangents and
the step's draws are numpy arrays handed to both frameworks.  Both JAX
voxel backends are held against the port, as in
tests/test_torch_port_hybrid.py: ``xla``, and ``sorted`` (its Pallas
kernels in interpret mode, with ``SORTED_N_MIN`` / ``SORTED_R3_MIN`` at 0
and exact HIGHEST window tiles); the dense one-hot route, which rounds the
interpolation weights to bf16, is turned off.  On the CPU the port's voxel
ops run their plain versions; their kernels are held against those on the
card (tests/test_torch_port_voxel.py ``-m gpu``, chip_smoke.py).

Tolerances: ``RTOL`` 1e-5 for what both sides compute in fp32 from the
same numbers in another summation order (BatchNorm outputs, gradients and
statistics; the voxel ops and their gradients); ``ATOL`` 5e-4 of a
gradient's largest magnitude for the modules and the step, as
tests/test_torch_port_hybrid.py holds their outputs (conv reduction order,
knife-edge voxel rounding); ``STATS_RTOL`` 1e-4 for a network's new
running variances (the fast variance E[x^2] - E[x]^2 of a layer whose
mean is several times its spread loses that many digits to cancellation,
in both frameworks' summation orders); ``BF16_REL`` where the normalize
dtype is bf16 (both sides round the same fp32 values to bf16, at most one
bf16 step apart); ``BF16_GRAD_REL`` 5e-2 of a gradient's max for the
bf16 island's training gradients with the kinks pinned (bf16 rounding of
activations and cotangents through the pyramid).

The gradients are continuous in the rounding except at the kinks: a ReLU
or leaky-ReLU input at 0, the elements that attain a max, the voxel a
point rounds into.  An input within rounding distance of a kink takes
another side in another computation and moves its channel's gradient
beyond these tolerances.  Where that happens, one side takes the other's
choices (``pcfm_torch.kinks`` in the port, ``_jax_takes`` in JAX).
"""
import contextlib
import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402

import pcfm.models.context as jctx  # noqa: E402
import pcfm.nn.pvconv as jpvconv  # noqa: E402
import pcfm.nn.se as jse  # noqa: E402
import pcfm.nn.shared_mlp as jsm  # noqa: E402
import pcfm.ops.voxel as jvox  # noqa: E402
import pcfm.ops.voxel_sorted as jvs  # noqa: E402
from pcfm import models as jm  # noqa: E402
from pcfm.interop.torch_ckpt import (config_from_reference_args,  # noqa: E402
                                     state_from_reference_ckpt)
from pcfm.nn.common import FlatBatchNorm  # noqa: E402
from pcfm.train.state import init_state as jax_init_state  # noqa: E402
from pcfm.train.step import train_step as jax_train_step  # noqa: E402
from pcfm_torch import interop, kinks  # noqa: E402
from pcfm_torch.models import ContextNet, HybridMLP  # noqa: E402
from pcfm_torch.models.context import VOXEL_EPS  # noqa: E402
from pcfm_torch.nn.common import BatchNorm  # noqa: E402
from pcfm_torch.nn.pvconv import PVConv, dead_conv_biases  # noqa: E402
from pcfm_torch.ops import film_block as fb  # noqa: E402
from pcfm_torch.ops import voxel_sorted as tvs  # noqa: E402
from pcfm_torch.train import checkpoint, cli, state, step  # noqa: E402
from pcfm_torch.train.evaluate import (make_recon_fn,  # noqa: E402
                                       make_sample_fn)
from tests.test_torch_port_hybrid import (SMALL, _inputs,  # noqa: E402
                                          _moved, _small_cfg)
from tests.test_torch_port_train import (_capturing,  # noqa: E402
                                         _close_to_max, _jax_draws)

RTOL = 1e-5
STATS_RTOL = 1e-4
ATOL = 5e-4
BF16_REL = 1e-2
BF16_GRAD_REL = 5e-2
GEN = dict(generator=torch.Generator().manual_seed(0))


@pytest.fixture(params=["xla", "sorted"])
def backend(request, monkeypatch):
    """A JAX voxel backend with its exact (fp32) routes."""
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)
    if request.param == "sorted":
        monkeypatch.setattr(jpvconv, "SORTED_N_MIN", 0)
        monkeypatch.setattr(jpvconv, "SORTED_R3_MIN", 0)
        monkeypatch.setattr(jvs, "DOT_PRECISION", jax.lax.Precision.HIGHEST)
    return request.param


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


# ------------------------------------------------------------ BatchNorm

BN_CASES = {
    # (JAX module, input dtype, normalize dtype, port's clamp_var)
    "flat fp32": ("flat", jnp.float32, jnp.float32, False),
    "flat_bf16": ("flat", jnp.bfloat16, jnp.bfloat16, False),
    "flax fp32": ("flax", jnp.float32, jnp.float32, True),
    "flax, bf16 input": ("flax", jnp.bfloat16, jnp.float32, True),
}
TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batchnorm_training_matches_flax(case):
    """The port's BatchNorm in training mode against FlatBatchNorm (the
    grid BN) and flax ``nn.BatchNorm`` (SharedMLP, BatchNorm1d): output,
    the gradients of input, scale and bias, and the new running
    statistics; the reference conv bias ``shift`` stays out of the
    arithmetic and goes into the running mean."""
    impl, in_dt, dt, clamp = BN_CASES[case]
    rng = np.random.RandomState(0)
    c, eps = 24, 1e-4 if impl == "flat" else 1e-5
    # a grid (B, R, R, R, C) for the grid BN, points (B, N, C) for the rest
    shape = (3, 5, 6, 7, c) if impl == "flat" else (3, 210, c)
    x = (rng.randn(*shape) * rng.uniform(0.5, 2.0, c)
         + rng.randn(c)).astype(np.float32)
    xj = jnp.asarray(x).astype(in_dt)
    x_in = np.asarray(xj.astype(jnp.float32))    # the rounded input
    ct = rng.randn(*x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, c).astype(np.float32)
    shift = rng.randn(c).astype(np.float32)       # a reference conv bias

    if impl == "flat":
        jbn = FlatBatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=eps, dtype=dt)
    else:
        jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                            epsilon=eps, axis=-1, dtype=dt)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(p, xx):
        y, upd = jbn.apply({"params": p, "batch_stats": stats}, xx,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * ct), (y, upd)

    (_, (y_j, upd)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, xj)

    bn = BatchNorm(c, eps=eps, clamp_var=clamp)
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0 + shift))   # the reference's mean
        bn.running_var.copy_(_t(var0))
    xt = _t(x_in, TORCH_DT[in_dt]).requires_grad_(True)
    y = bn.train()(xt, shift=_t(shift), dtype=TORCH_DT[dt])
    assert y.dtype == TORCH_DT[dt]
    (y.float() * _t(ct)).sum().backward()

    grads = {"dscale": gp["scale"], "dbias": gp["bias"]}
    if dt == jnp.bfloat16:
        # XLA sums the bf16 products of dscale / dbias in bf16 (5e-2 of
        # their max off the exact sums here): hold the port to the fp64
        # sums of the same bf16 operands instead
        grads = _bf16_param_grads(x_in, ct, eps)
    exact = dt == jnp.float32 and in_dt == jnp.float32
    for got, want, what in ((y, y_j, "y"), (xt.grad, gx, "dx"),
                            (bn.weight.grad, grads["dscale"], "dscale"),
                            (bn.bias.grad, grads["dbias"], "dbias")):
        got, want = got.detach().float().numpy(), _np(want)
        if exact:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5,
                                       err_msg=what)
        else:
            _close_to_max(got, want, BF16_REL, what)
    # the statistics are fp32 sums of the same (rounded) inputs
    new = upd["batch_stats"]
    np.testing.assert_allclose((bn.running_mean - _t(shift)).numpy(),
                               _np(new["mean"]), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), _np(new["var"]),
                               rtol=RTOL, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def _bf16_param_grads(x, ct, eps):
    """fp64 d(sum(y * ct)) / d(scale, bias) of a bf16-normalize BatchNorm
    on these inputs: the sums over rows of the bf16 operands
    (x - mean) and ct, the scale's through the bf16 multiplier."""
    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32), np.float64)
    c = x.shape[-1]
    x2 = x.reshape(-1, c).astype(np.float64)
    mean = x2.mean(0)
    var = (x2 * x2).mean(0) - mean * mean
    g = bf(ct.reshape(-1, c))
    dmul = (bf(bf(x2) - bf(mean)) * g).sum(0)
    return {"dscale": bf(dmul) / np.sqrt(var + eps), "dbias": g.sum(0)}


def test_batchnorm_eval_mode_is_unchanged_and_moves_nothing():
    bn = BatchNorm(8, eps=1e-5)
    with torch.no_grad():
        bn.running_mean.normal_(**GEN)
        bn.running_var.uniform_(0.5, 2.0, **GEN)
    x = torch.randn(4, 10, 8, **GEN)
    before = _buffers(bn)
    y = bn.eval()(x, shift=torch.full((8,), 0.25))
    mul = torch.rsqrt(before["running_var"] + 1e-5)
    torch.testing.assert_close(
        y, (x - (before["running_mean"] - 0.25)) * mul, rtol=0, atol=0)
    assert all(torch.equal(v, before[k]) for k, v in _buffers(bn).items())


# ------------------------------------------------------------ voxel ops

def _voxel_case(k, crowded, seed=1, b=2, n=300, c=16, r=8):
    """Sorted voxel ids / normalised coords of random clouds (most of the
    512 voxels empty); ``crowded``: a third of each cloud at one point, a
    voxel (and its 8 corners) with a run longer than SCATTER_CHUNK."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(b, n, 3).astype(np.float32)
    if crowded:
        pts[:, : n // 3] = pts[:, :1] * 0.1
    nc_j, vc_j = jvox.normalize_coords(jnp.asarray(pts), r)
    ids_j = jvox.flatten_voxel_ids(vc_j, r)
    perm = jnp.argsort(ids_j, axis=1)
    nc_j = jnp.take_along_axis(nc_j, perm[..., None], axis=1)
    ids_j = jnp.take_along_axis(ids_j, perm, axis=1)
    dense = rng.randn(b, n if k == 1 else r ** 3, c).astype(np.float32)
    ct = rng.randn(b, r ** 3 if k == 1 else n, c).astype(np.float32)
    return nc_j, ids_j, dense, ct


@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_voxel_functions_match_jax_grad(k, crowded, monkeypatch):
    """avg-voxelize (K = 1 forward, K = 1 gather backward) and devoxelize
    (K = 8 forward, K = 8 scatter backward) against ``jax.grad`` of the JAX
    package's sorted ops; empty voxels get 0 gradient."""
    monkeypatch.setattr(jvs, "DOT_PRECISION", jax.lax.Precision.HIGHEST)
    r = 8
    nc_j, ids_j, dense, ct = _voxel_case(k, crowded)
    if k == 1:
        def jfn(x):
            return jvs.avg_voxelize_sorted(x, ids_j, r, True)

        def tfn(x):
            return tvs.avg_voxelize_sorted(
                x, torch.from_numpy(np.array(ids_j)), r)
    else:
        def jfn(x):
            return jvs.trilinear_devoxelize_sorted(x, nc_j, r, True)

        def tfn(x):
            return tvs.trilinear_devoxelize_sorted(x, _t(np.asarray(nc_j)), r)
    out_j, vjp = jax.vjp(jfn, jnp.asarray(dense))
    (g_j,) = vjp(jnp.asarray(ct))
    x = _t(dense).requires_grad_(True)
    out = tfn(x)
    (out * _t(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(out_j), rtol=RTOL,
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), _np(g_j), rtol=RTOL,
                               atol=1e-5)
    if k == 8:     # the voxels no corner reaches get no gradient
        hit = np.zeros((2, r ** 3), bool)
        ids8, w8 = tvs.corner_data(_t(np.asarray(nc_j)), r)
        for bb in range(2):
            hit[bb, ids8[bb][w8[bb] > 0].numpy()] = True
        assert (~hit).any() and not x.grad.numpy()[~hit].any()


def test_permute_backward_is_the_inverse_gather():
    rng = np.random.RandomState(3)
    pts = rng.randn(2, 50, 3).astype(np.float32)
    x = rng.randn(2, 50, 5).astype(np.float32)
    ct = rng.randn(2, 50, 5).astype(np.float32)
    perm_j, inv_j = jvs.sort_perm_by_voxel(jnp.asarray(pts), 8, eps=1e-6)
    _, vjp = jax.vjp(lambda a: jvs.permute_points(a, perm_j, inv_j),
                     jnp.asarray(x))
    perm, inv = tvs.sort_perm_by_voxel(_t(pts), 8, eps=1e-6)
    xt = _t(x).requires_grad_(True)
    (tvs.permute_points(xt, perm, inv) * _t(ct)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  _np(vjp(jnp.asarray(ct))[0]))
    yt = _t(x).requires_grad_(True)
    (tvs.unpermute_points(yt, perm, inv) * _t(ct)).sum().backward()
    np.testing.assert_array_equal(
        yt.grad.numpy(), np.take_along_axis(ct, perm.numpy()[..., None], 1))


@pytest.mark.parametrize("op", ["avg_voxelize", "devoxelize", "permute"])
def test_voxel_functions_gradcheck_float64(op):
    """torch.autograd.gradcheck of each Function on its plain versions in
    float64 (both directions linear: the numeric Jacobian is exact)."""
    r, n = 4, 30
    g = torch.Generator().manual_seed(4)
    pts = torch.randn(2, n, 3, generator=g)
    pts[:, :10] = 0.0                        # a crowded voxel
    nc, vc = tvs.normalize_coords(pts, r)
    ids = tvs.flatten_voxel_ids(vc, r)
    perm, inv = tvs.sort_perm_by_voxel(pts, r)
    if op == "avg_voxelize":
        x = torch.randn(2, n, 3, generator=g, dtype=torch.float64)
        fn = lambda a: tvs.avg_voxelize_sorted(a, ids, r)  # noqa: E731
    elif op == "devoxelize":
        x = torch.randn(2, r ** 3, 3, generator=g, dtype=torch.float64)
        fn = lambda a: tvs.trilinear_devoxelize_sorted(a, nc, r)  # noqa
    else:
        x = torch.randn(2, n, 3, generator=g, dtype=torch.float64)
        fn = lambda a: tvs.permute_points(a, perm, inv)  # noqa: E731
    assert fn(x).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, (x.requires_grad_(True),))


# ------------------------------------------------------------ modules

def _grads_close(net, want_sd, scale_floor=1.0):
    """Every trainable parameter's .grad against the JAX gradient in port
    layout, within ATOL of its largest magnitude (at least ``scale_floor``);
    the dead conv biases (no JAX parameter) get no gradient."""
    dead = {id(b) for b, _ in dead_conv_biases(net)}
    n = 0
    for name, p in net.named_parameters():
        if id(p) in dead:
            assert p.grad is None, name
            continue
        want = want_sd[name].numpy()
        scale = max(float(np.abs(want).max()), scale_floor)
        np.testing.assert_allclose(p.grad.numpy(), want, atol=ATOL * scale,
                                   rtol=0, err_msg=name)
        n += 1
    return n


def _jax_stats(net):
    """The port's running statistics in the JAX package's convention: each
    running mean without its dead conv bias, which the port keeps in it as
    the reference does (``BatchNorm``'s ``shift``)."""
    names = {id(m): n for n, m in net.named_modules()}
    out = _buffers(net)
    for bias, bn in dead_conv_biases(net):
        key = f"{names[id(bn)]}.running_mean"
        out[key] = out[key] - bias.detach()
    return out


def _stats_close(net, want_sd):
    for name, v in _jax_stats(net).items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 1, name
        else:
            np.testing.assert_allclose(v.numpy(), want_sd[name].numpy(),
                                       rtol=STATS_RTOL, atol=1e-6,
                                       err_msg=name)


def _train_grads(net, args, ct, pins=contextlib.nullcontext()):
    """Port: one training-mode forward, d(sum(out * ct)); ``pins``: a
    ``kinks`` record or replay around the forward."""
    with pins:
        out = net.train()(*args)
    if isinstance(out, tuple):
        out = out[0]
    (out.float() * _t(ct)).sum().backward()
    return out.detach().float().numpy()


class _With:
    """A module's namespace with some names replaced (the rest is
    ``base``'s), for the JAX modules that call ``nn.relu`` / ``jnp.max``
    through a module-level name."""

    def __init__(self, base, **over):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over.get(name, getattr(self._base, name))


def _jax_takes(monkeypatch, rec, inv=None):
    """Make the JAX package's hybrid take the port's choices at the kinks
    (``rec``, a ``kinks.record`` of the port's forward): its ReLUs
    (SharedMLP, SE), leaky ReLUs (PVConv) and the global branch's max, each
    kind in call order (the port calls them in the JAX package's order).
    ``inv``: the port's entry sort, for JAX's ``xla`` route, which keeps the
    points in input order.  Returns the queues, empty once a JAX forward
    has taken every recorded choice."""
    queues = {"relu": [], "leaky_relu": [], "amax": []}
    for kind, mask in rec.sites:
        if kind in queues:
            if inv is not None and mask.dim() == 3:      # (B, N, C) points
                mask = torch.take_along_dim(mask, inv[..., None], dim=1)
            queues[kind].append(jnp.asarray(mask.numpy()))

    def take(kind, shape):
        mask = queues[kind].pop(0)
        assert mask.shape == tuple(shape), (kind, mask.shape, shape)
        return mask

    def relu(x):
        return jnp.where(take("relu", x.shape), x, jnp.zeros((), x.dtype))

    def leaky_relu(x, negative_slope=0.01):
        return jnp.where(take("leaky_relu", x.shape), x, x * negative_slope)

    def amax(x, axis=None, keepdims=False):
        mask = take("amax", x.shape)
        top = jnp.where(mask, x.astype(jnp.float32), 0.0).sum(axis,
                                                             keepdims=keepdims)
        return (top / mask.sum(axis, keepdims=keepdims)).astype(x.dtype)

    for mod in (jsm, jse):
        monkeypatch.setattr(mod, "nn", _With(fnn, relu=relu))
    monkeypatch.setattr(jpvconv, "nn", _With(fnn, leaky_relu=leaky_relu))
    monkeypatch.setattr(jctx, "jnp", _With(jnp, max=amax))
    return queues


def test_pvconv_training_grads_match_jax(backend):
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 300, 8).astype(np.float32)
    coords = rng.randn(2, 300, 3).astype(np.float32)
    ct = rng.randn(2, 300, 16).astype(np.float32)
    jnet = jpvconv.PVConv(out_channels=16, kernel_size=3, resolution=16,
                          with_se=True, eps=1e-6, voxel_backend=backend)
    v = jnet.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                  jnp.asarray(coords), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 6)

    def f(p, x):
        (y, _), upd = jnet.apply({"params": p, "batch_stats": stats}, x,
                                 jnp.asarray(coords), train=True,
                                 mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (y_j, new_s)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(feats))
    net = PVConv(8, 16, 3, 16, True, True, 1e-6, **GEN)
    net.load_state_dict(interop.pvconv_to_sd(params, stats))
    x = _t(feats).requires_grad_(True)
    y = _train_grads(net, (x, _t(coords)), ct)
    np.testing.assert_allclose(y, _np(y_j), atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), _np(gx), atol=ATOL)
    assert _grads_close(net, interop.pvconv_to_sd(gp, new_s)) == \
        len(jax.tree_util.tree_leaves(gp))
    _stats_close(net, interop.pvconv_to_sd(params, new_s))


CTX_KW = dict(in_point_dim=6, emb_dim=16, ctx_dim=8, stage_channels=(16, 32),
              stage_blocks=(2, 1), stage_res=(16, 8), with_se=True,
              gn_groups=4, with_global=True, t_gate_tau=0.4)


# JAX's sorted route with BatchNorm norms: jitted, its input gradient
# misses the absolute ATOL at one element where that gradient is tens of
# times larger than elsewhere (XLA's fused rounding; the parameters'
# gradients agree within ATOL of their max), and eager, it takes another
# side than the port at a ReLU input within rounding distance of 0.  That
# case runs eager, taking the port's choices at the kinks (``_jax_takes``)
@pytest.mark.parametrize("backend,norm,eager_pinned",
                         [("xla", "group", False), ("sorted", "group", False),
                          ("xla", "batch", False), ("sorted", "batch", True)],
                         indirect=["backend"])
def test_context_net_training_grads_match_jax(backend, norm, eager_pinned,
                                              monkeypatch):
    kw = dict(CTX_KW, cond_dim=5, norm_type=norm)
    x, t, c = _inputs(7)
    ct = np.random.RandomState(8).randn(2, 300, 8).astype(np.float32)
    jnet = jm.ContextNet(voxel_backend=backend, **kw)
    v = jnet.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(t),
                  jnp.asarray(c), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 9)
    net = ContextNet(**kw, **GEN)
    net.load_state_dict(interop.context_net_to_sd(params, stats))
    xt = _t(x).requires_grad_(True)
    rec = kinks.Kinks()
    y = _train_grads(net, (xt, _t(t), _t(c)), ct, kinks.record(rec))
    if eager_pinned:    # the sorted route sorts the points as the port does
        left = _jax_takes(monkeypatch, rec)

    def f(p, xx):
        y, upd = jnet.apply({"params": p, "batch_stats": stats}, xx,
                            jnp.asarray(t), jnp.asarray(c), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    grad = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)
    (_, (y_j, new_s)), (gp, gx) = (grad if eager_pinned else jax.jit(grad))(
        params, jnp.asarray(x))
    if eager_pinned:
        assert not any(left.values())
    np.testing.assert_allclose(y, _np(y_j), atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), _np(gx), atol=ATOL)
    assert _grads_close(net, interop.context_net_to_sd(gp, new_s)) == \
        len(jax.tree_util.tree_leaves(gp))
    _stats_close(net, interop.context_net_to_sd(params, new_s))


def test_hybrid_mlp_training_grads_match_jax(backend):
    kw = dict(cond_dim=5, point_dim=6, **SMALL)
    x, t, c = _inputs(10)
    rng = np.random.RandomState(11)
    ct = rng.randn(2, 300, 6).astype(np.float32)
    mask = np.array([[1.0], [0.0]], np.float32)   # row 0 dropped
    jnet = jm.HybridMLP(voxel_backend=backend, fused_trunk="on", **kw)
    v = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(t),
                  jnp.asarray(c), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 12)

    def f(p):
        y, upd = jnet.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(x), jnp.asarray(t), jnp.asarray(c),
                            cond_drop_mask=jnp.asarray(mask), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * ct), (y, upd["batch_stats"])

    (_, (y_j, new_s)), gp = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    net = HybridMLP(fused_trunk="on", **kw, **GEN)
    net.load_state_dict(interop.hybrid_to_sd(params, stats))
    y = _train_grads(net, (_t(x), _t(t), _t(c), _t(mask)), ct)
    np.testing.assert_allclose(y, _np(y_j), atol=ATOL)
    assert _grads_close(net, interop.hybrid_to_sd(gp, new_s)) == \
        len(jax.tree_util.tree_leaves(gp))
    _stats_close(net, interop.hybrid_to_sd(params, new_s))


def test_hybrid_bf16_training_grads_match_jax(monkeypatch):
    """The bf16 island's training gradients (HybridMLP with the ContextNet
    and the head in bf16) against the JAX package's, both taking the port's
    fp32 choices at the kinks (ReLU masks, the global max): the port's bf16
    against JAX's fp32 within BF16_GRAD_REL of each gradient's max (bf16
    rounding alone), and against JAX's bf16 too but for the grid
    BatchNorms' scale and bias, whose gradients XLA sums in bf16 (the port
    sums in fp32; JAX's are then further from its own fp32).  Without
    the pins the port's bf16 gradients miss JAX's fp32 ones by more than
    the bound: the gap between the precisions is at the kinks."""
    monkeypatch.setattr(jpvconv, "DENSE_R3_MAX", 0)     # the exact route
    kw = dict(cond_dim=5, point_dim=6, **SMALL)
    x, t, c = _inputs(10)
    ct = np.random.RandomState(11).randn(2, 300, 6).astype(np.float32)
    jnet = {dt: jm.HybridMLP(voxel_backend="xla", fused_trunk="on", dtype=dt,
                             ctx_island_dtype=dt, **kw)
            for dt in (jnp.float32, jnp.bfloat16)}
    v = jnet[jnp.float32].init(jax.random.PRNGKey(3), jnp.asarray(x),
                               jnp.asarray(t), jnp.asarray(c), train=False)
    params, stats = _moved(v["params"], v["batch_stats"], 12)
    sd = interop.hybrid_to_sd(params, stats)
    args = (_t(x), _t(t), _t(c))

    def port(dtype, pins):
        net = HybridMLP(fused_trunk="on", dtype=dtype, ctx_island_dtype=dtype,
                        **kw, **GEN)
        net.load_state_dict(sd)
        _train_grads(net, args, ct, pins)
        return {k: p.grad.float().numpy() for k, p in net.named_parameters()
                if p.grad is not None}

    rec = kinks.Kinks()
    g32 = port(torch.float32, kinks.record(rec))
    g16 = port(torch.bfloat16, kinks.replay(rec))
    g16_free = port(torch.bfloat16, contextlib.nullcontext())
    _, inv = tvs.sort_perm_by_voxel(args[0][..., :3], SMALL["stage_res"][0],
                                    eps=1e-6)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        left = _jax_takes(monkeypatch, rec, inv)

        def f(p):
            y = jnet[dt].apply({"params": p, "batch_stats": stats},
                               jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(c), train=True,
                               mutable=["batch_stats"])[0]
            return jnp.sum(y.astype(jnp.float32) * ct)

        gp = jax.jit(jax.grad(f))(params)
        assert not any(left.values())
        want[dt] = {k: v.numpy() for k, v in interop.hybrid_to_sd(
            jax.device_get(gp), stats).items() if k in g32}

    grid_bn = {f"{k}.{w}" for k, m in HybridMLP(**kw, **GEN).named_modules()
               if isinstance(m, BatchNorm) and k.endswith(
                   ("voxel_layers.1", "voxel_layers.4"))
               for w in ("weight", "bias")}
    assert len(want[jnp.float32]) == len(g32) and grid_bn <= set(g32)
    for k, w32 in want[jnp.float32].items():
        _close_to_max(g32[k], w32, ATOL, f"fp32 {k}")
        _close_to_max(g16[k], w32, BF16_GRAD_REL, f"bf16 vs JAX fp32 {k}")
        if k not in grid_bn:
            _close_to_max(g16[k], want[jnp.bfloat16][k], BF16_GRAD_REL,
                          f"bf16 vs JAX bf16 {k}")
    assert max(np.abs(g16_free[k] - w).max() / np.abs(w).max()
               for k, w in want[jnp.float32].items()) > BF16_GRAD_REL


# ------------------------------------------------------------ train step

def _reference_ckpt(js, rng, conv_bias: bool) -> dict:
    """A reference-format checkpoint dict of a JAX hybrid state (live and
    EMA); with ``conv_bias`` every dead conv bias is non-zero and its
    BatchNorm's running mean carries it (the reference's convention), as in
    a checkpoint of the reference trainer."""
    pf = interop.hybrid_to_sd(js["pf"], js["pf_stats"])
    ema = interop.hybrid_to_sd(js["ema_pf"], js["ema_pf_stats"])
    if conv_bias:
        probe = HybridMLP(cond_dim=1, point_dim=6, **SMALL, **GEN)
        names = {id(p): n for n, p in probe.named_parameters()}
        mods = {id(m): n for n, m in probe.named_modules()}
        for bias, bn in dead_conv_biases(probe):
            b_name, m_name = names[id(bias)], mods[id(bn)]
            for sd in (pf, ema):
                b = torch.from_numpy(
                    rng.randn(*sd[b_name].shape).astype(np.float32)) * 0.3
                sd[b_name] = b
                sd[f"{m_name}.running_mean"] = \
                    sd[f"{m_name}.running_mean"] + b
    lf = interop.latent_net_to_sd(js["lf"])
    return {"encoder": interop.shape_encoder_to_sd(js["enc"]), "pf": pf,
            "lf": lf, "ema_pf": ema, "ema_lf": lf, "global_step": 0,
            "epoch": 0}


def _jax_state_numpy(jcfg, seed):
    _, st, _ = jax_init_state(jcfg, jax.random.PRNGKey(seed), total_steps=1)
    params = jax.device_get(st.params)
    pf_s = jax.device_get(st.batch_stats["pf"])
    pf, pf_s2 = _moved(params["pf"], pf_s, seed)
    ema, ema_s = _moved(params["pf"], pf_s, seed + 1)
    lf, _ = _moved(params["lf"], {}, seed + 2)
    enc, _ = _moved(params["enc"], {}, seed + 3)
    return {"enc": enc, "pf": pf, "pf_stats": pf_s2, "ema_pf": ema,
            "ema_pf_stats": ema_s, "lf": lf}


@pytest.mark.parametrize("backend,conv_bias,n,pinned", [
    pytest.param("sorted", False, 300, False, id="sorted-False"),
    pytest.param("xla", True, 300, False, id="xla-True"),
    pytest.param("xla", True, 200, True, id="xla-True-200-pinned")],
    indirect=["backend"])
def test_hybrid_train_step_matches_jax(backend, conv_bias, n, pinned,
                                       tmp_path, monkeypatch):
    """One hybrid train step against pcfm.train.step.train_step with the
    same draws, both states from one reference checkpoint (the JAX one
    through its importer, the port's through ``restore_tolerant``):
    losses, grad norm, every gradient, the updated params, the new BN
    statistics and the EMA with its statistics.  ``conv_bias``: the
    checkpoint's dead conv biases are non-zero (the conv-bias trap).
    ``pinned``: JAX takes the port's choices at the kinks (``_jax_takes``,
    the encoder's max pool aside), so that the check holds at any size: at
    200 points a ReLU input within rounding distance of 0 takes another
    side in jitted JAX than in the port."""
    total = 20
    cfg, jcfg = _small_cfg(voxel_backend=backend, warmup_steps=0,
                           grad_clip_norm=1.0, epochs=total, cfg_drop_p=0.5,
                           lambda_zreg=0.1)
    rng = np.random.RandomState(13)
    ck = _reference_ckpt(_jax_state_numpy(jcfg, 14), rng, conv_bias)
    jb, jst, tx = state_from_reference_ckpt(ck, jcfg)
    cap = _capturing(tx)
    jst = jst.replace(opt_state=cap.init(jst.params))
    path = str(tmp_path / "ref.pt")
    torch.save(ck, path)
    st = state.init_state(cfg, "cpu", total, torch.Generator().manual_seed(0))
    with contextlib.redirect_stdout(io.StringIO()):
        checkpoint.restore_tolerant(path, st)
    dead = dead_conv_biases(st.bundle.pf)
    biases = [b.detach().clone() for b, _ in dead]
    assert len(dead) == 10 and all(bool(b.any()) == conv_bias
                                   for b in biases)
    assert not {id(b) for b, _ in dead} & {id(p) for p in st.trainable()}

    bsz, drop_p, color_on = 2, 0.5, 1.0
    batch = {"pts": rng.randn(bsz, n, 3).astype(np.float32) * 0.5,
             "rgb": rng.rand(bsz, n, 3).astype(np.float32),
             "cond": rng.rand(bsz, 1).astype(np.float32)}
    key = jax.random.PRNGKey(16)
    draws = _jax_draws(cfg, key, bsz, n, drop_p)
    assert 0 < float(draws["drop"].sum()) < bsz     # both CFG branches
    rec = kinks.Kinks()
    with kinks.record(rec) if pinned else contextlib.nullcontext():
        m = step.train_step(st, {k: _t(v) for k, v in batch.items()}, None,
                            color_on, drop_p, draws=draws)
    if pinned:
        assert rec.sites[0][0] == "amax"            # the encoder's pool
        rec.sites = rec.sites[1:]
        # JAX's xla route keeps the points in input order: the port's
        # entry sort of x_t maps its masks back
        x_t, _ = step.fm_interpolate(draws["t"], _t(np.concatenate(
            [batch["pts"], batch["rgb"]], -1)), draws["x0"])
        _, inv = tvs.sort_perm_by_voxel(x_t[..., :3], cfg.ctx_stage_res[0],
                                        eps=VOXEL_EPS)
        left = _jax_takes(monkeypatch, rec, inv)
    new_j, m_j = jax.jit(lambda s_, b_, k_: jax_train_step(
        jb, cap, s_, b_, k_, jnp.float32(color_on), jnp.float32(drop_p)))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    if pinned:
        assert not any(left.values())
    for k in ("loss", "loss_point", "loss_latent", "loss_pos", "loss_col",
              "loss_zreg"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=RTOL)

    pf = st.bundle.pf
    gn = float(m["grad_norm"])
    clip = cfg.grad_clip_norm / max(gn, cfg.grad_clip_norm)
    g_j = jax.device_get(new_j.opt_state.grads)
    want = interop.hybrid_to_sd(g_j["pf"], new_j.batch_stats["pf"])
    for name, p in pf.named_parameters():
        if p.grad is not None:   # .grad holds the clipped gradient
            _close_to_max(p.grad.numpy() / clip, want[name].numpy(), ATOL,
                          f"grad pf/{name}")
    for g, conv in (("enc", interop.shape_encoder_to_sd),
                    ("lf", interop.latent_net_to_sd)):
        sd = conv(g_j[g])
        for name, p in getattr(st.bundle, g).named_parameters():
            _close_to_max(p.grad.numpy() / clip, sd[name].numpy(), ATOL,
                          f"grad {g}/{name}")

    # Adam's first update is ~lr * g / |g|: an element whose gradient sits
    # at rounding level may flip, so most elements to 1e-3 lr, all to 2 lr
    lr = cfg.lr_pf
    new_sd = interop.hybrid_to_sd(jax.device_get(new_j.params["pf"]),
                                  jax.device_get(new_j.batch_stats["pf"]))
    dead_ids = {id(b) for b, _ in dead}     # no JAX parameter: held below
    diffs = torch.cat([(p.detach() - new_sd[name]).abs().flatten()
                       for name, p in pf.named_parameters()
                       if id(p) not in dead_ids])
    assert float((diffs <= 1e-3 * lr).float().mean()) >= 0.999
    assert float(diffs.max()) <= 2 * lr
    assert all(torch.equal(b, b0)                  # no decay moved them
               for (b, _), b0 in zip(dead, biases))
    # the running statistics moved once, by the JAX recurrence
    _stats_close(pf, new_sd)
    ema_sd = interop.hybrid_to_sd(
        jax.device_get(new_j.ema_pf["params"]),
        jax.device_get(new_j.ema_pf["batch_stats"]))
    ema = st.bundle.ema_pf
    got = dict(ema.state_dict(), **_jax_stats(ema))
    names = {id(p): n for n, p in ema.named_parameters()}
    dead_names = {names[id(b)] for b, _ in dead_conv_biases(ema)}
    for name, w in ema_sd.items():
        if name.endswith("num_batches_tracked") or name in dead_names:
            continue
        tol = 2e-3 * lr if not name.endswith(("running_mean",
                                              "running_var")) else 1e-6
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=tol,
                                   rtol=RTOL, err_msg=f"ema {name}")


def test_ema_update_averages_the_running_statistics():
    cfg, _ = _small_cfg()
    st = state.init_state(cfg, "cpu", 10, torch.Generator().manual_seed(1))
    live, shadow = st.bundle.pf, st.bundle.ema_pf
    with torch.no_grad():
        for m in (live, shadow):
            for v in m.buffers():
                if v.is_floating_point():
                    v.uniform_(0.5, 1.5, **GEN)
    s0, l0 = shadow.state_dict(), live.state_dict()
    s0 = {k: v.clone() for k, v in s0.items()}
    state.ema_update(shadow, live, 0.9)
    for k, v in shadow.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, s0[k] * 0.9 + l0[k] * 0.1)
        elif k.endswith("num_batches_tracked"):
            assert torch.equal(v, s0[k])


def test_hybrid_optimizer_has_the_jax_parameters():
    cfg, jcfg = _small_cfg()
    st = state.init_state(cfg, "cpu", 10, torch.Generator().manual_seed(2))
    _, jst, _ = jax_init_state(jcfg, jax.random.PRNGKey(0), total_steps=10)
    for group in st.opt.param_groups:
        n_jax = len(jax.tree_util.tree_leaves(jst.params[group["name"]]))
        assert len(group["params"]) == n_jax, group["name"]
    assert st.bundle.pf.training


# ------------------------------------------------------------ eval mode

def test_sampling_leaves_the_running_statistics_untouched():
    """Sampling and reconstruction run the live and EMA hybrids in eval
    mode, whatever mode they are in, and restore it: no running statistic
    moves."""
    cfg, _ = _small_cfg(sample_steps=2, latent_sample_steps=1)
    st = state.init_state(cfg, "cpu", 10, torch.Generator().manual_seed(3))
    bundle = st.bundle
    assert bundle.pf.training and bundle.ema_pf.training
    before = {k: _buffers(m) for k, m in bundle.modules().items()}
    g = torch.Generator().manual_seed(4)
    pts, rgb = torch.randn(2, 120, 3, generator=g), torch.rand(2, 120, 3)
    cond = torch.rand(2, 1, generator=g)
    for use_ema in (True, False):
        make_sample_fn(bundle, use_ema=use_ema)(cond, g, 2, 120)
        make_recon_fn(bundle, use_ema=use_ema)(pts, rgb, cond, g)
    for k, m in bundle.modules().items():
        assert m.training, k
        for name, v in _buffers(m).items():
            assert torch.equal(v, before[k][name]), f"{k}/{name}"


# ------------------------------------------------------------ the CLI

HYB_ARGV = ["--pf_backbone", "hybrid", "--dataset_type", "synthetic",
            "--batch_size", "16", "--tr_max_sample_points", "64",
            "--te_max_sample_points", "64", "--latent_dim", "16",
            "--enc_width", "32", "--pf_width", "128", "--pf_depth", "3",
            "--pf_emb_dim", "16", "--lf_width", "32", "--lf_depth", "3",
            "--lf_emb_dim", "16", "--ctx_dim", "8", "--ctx_emb_dim", "16",
            "--ctx_stage_channels", "16", "32", "--ctx_stage_blocks", "1",
            "1", "--ctx_stage_res", "16", "8", "--ctx_gn_groups", "4",
            "--warmup_steps", "2", "--sample_steps", "2",
            "--vis_count", "1", "--num_workers", "0", "--fused_trunk", "on",
            "--save_every", "1", "--device", "cpu"]


def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    return out, buf.getvalue()


def test_hybrid_train_cli_runs_resumes_and_loads_into_jax(tmp_path):
    out_dir = str(tmp_path / "run")
    argv = HYB_ARGV + ["--out_dir", out_dir]
    before = fb.launches, fb.bwd_launches, dict(tvs.launches)
    out, log = _run_cli(argv + ["--epochs", "1"])
    assert out["epochs_run"] == 1 and np.isfinite(out["loss"])
    out, log = _run_cli(argv + ["--epochs", "2"])
    assert "Resume from epoch 1" in log and "RESET" not in log
    assert out["epochs_run"] == 1 and np.isfinite(out["loss"])
    assert "Ep2: lp=" in log and "[Val ep0002] random-z CD" in log
    assert (fb.launches, fb.bwd_launches, tvs.launches) == before  # CPU
    out, log = _run_cli(argv + ["--epochs", "2"])
    assert out == {"epochs_run": 0} and "Nothing to do" in log

    ck = torch.load(os.path.join(checkpoint.ckpt_dir(out_dir),
                                 "hybrid_ep0002.pt"), weights_only=True)
    assert ck["global_step"] == 8 and ck["epoch"] == 2   # 64 / 16 a epoch
    bn = "ctx_net.stages.0.blocks.0.pvconv.voxel_layers.1"
    assert int(ck["pf"][f"{bn}.num_batches_tracked"]) == 8
    assert not ck["pf"]["ctx_net.stages.0.proj.layers.0.bias"].any()
    jcfg = config_from_reference_args(ck["args"], cond_dim=ck["cond_dim"])
    assert jcfg.pf_backbone == "hybrid"
    _, jst, _ = state_from_reference_ckpt(ck, jcfg)
    for key, p, s in (("pf", jst.params["pf"], jst.batch_stats["pf"]),
                      ("ema_pf", jst.ema_pf["params"],
                       jst.ema_pf["batch_stats"])):
        for name, v in interop.hybrid_to_sd(jax.device_get(p),
                                            jax.device_get(s)).items():
            if not name.endswith("num_batches_tracked"):
                torch.testing.assert_close(v, ck[key][name], rtol=0, atol=0,
                                           msg=f"{key}/{name}")
    assert int(jst.step) == 8
