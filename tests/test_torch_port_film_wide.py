"""The FiLM block at the widths of its wide paths (forward C > 1024,
backward C > 512, up to ``MAX_C`` = 2048), against the JAX package's kernel
(pcfm/ops/pallas/film_block.py, interpret mode) on the CPU, and the CUDA
kernels against their plain versions on the card.

On the CPU the wrapper runs its plain version at every width.  JAX comes
in through fixtures, so that on a card without JAX the ``gpu`` tests run
alone (``--noconftest``: tests/conftest.py sets up JAX):

    python -m pytest tests/test_torch_port_film_wide.py -m gpu --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch.ops import film_block as fb  # noqa: E402

_NAMES = ("h", "s", "t", "gamma", "beta", "w", "b")


def _inputs(seed, b=2, n=300, c=640):
    """numpy inputs in the JAX layout (w is (in, out))."""
    rng = np.random.RandomState(seed)
    f = np.float32
    return dict(h=(0.7 * rng.randn(b, n, c)).astype(f),
                s=(1.0 + 0.1 * rng.randn(c)).astype(f),
                t=(0.1 * rng.randn(c)).astype(f),
                gamma=(0.2 * rng.randn(b, c)).astype(f),
                beta=(0.2 * rng.randn(b, c)).astype(f),
                w=(rng.randn(c, c) / np.sqrt(c)).astype(f),
                b=(0.1 * rng.randn(c)).astype(f))


def _port_args(a, device="cpu", dtype=torch.float32):
    """Port argument order; w goes over to the torch Linear (out, in)."""
    t = {k: torch.from_numpy(v).to(device) for k, v in a.items()}
    t["w"] = t["w"].T.contiguous()
    for k in ("h", "gamma", "beta"):
        t[k] = t[k].to(dtype)
    return [t[k] for k in _NAMES]


def _grad_close(got, want, rel, where=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, where
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0,
                               err_msg=where)


@pytest.fixture
def jax_fb():
    """(jax, jnp, the JAX package's film_block module)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from pcfm.ops.pallas import film_block
    return jax, jnp, film_block


@pytest.mark.parametrize("c", [640, 1024])
@pytest.mark.parametrize("n", [77, 300])
def test_plain_forward_and_backward_match_jax_kernel(jax_fb, c, n):
    # y and the seven gradients of the port's Function (its plain versions
    # on the CPU) against the JAX kernel and jax.grad through its
    # custom_vjp, both in interpret mode: within 1e-4 of each one's max
    jax, jnp, jfb = jax_fb
    a = _inputs(c + n, n=n, c=c)
    dy = np.random.RandomState(n).randn(2, n, c).astype(np.float32)
    jargs = [jnp.asarray(a[k]) for k in _NAMES]
    want_y = np.asarray(jfb.film_block(*jargs, True))
    want = jax.grad(lambda *x: jnp.sum(jfb.film_block(*x, True) * dy),
                    argnums=tuple(range(7)))(*jargs)
    args = [x.requires_grad_(True) for x in _port_args(a)]
    before = (fb.launches, fb.bwd_launches)
    y = fb.film_block(*args)
    got = torch.autograd.grad(y, args, torch.from_numpy(dy))
    assert (fb.launches, fb.bwd_launches) == before   # CPU: plain versions
    _grad_close(y.detach().numpy(), want_y, 1e-4, "y")
    for name, g, w in zip(_NAMES, got, want):
        w = np.asarray(w)
        if name == "w":                               # JAX (in, out)
            w = w.T
        _grad_close(g.numpy(), w, 1e-4, name)


def test_velocity_net_fused_at_width_640_matches_jax(jax_fb):
    # the port's VelocityNet with the fused trunk at pf_width 640 (a width
    # only the backward's wide path takes on the card) against JAX's, with
    # JAX's weights carried over by interop: the velocity and the
    # gradients of its sum with respect to every parameter
    jax, jnp, _ = jax_fb
    from pcfm import models as jm
    from pcfm_torch import interop
    from pcfm_torch.models import VelocityNet
    kw = dict(cond_dim=3, width=640, depth=3, emb_dim=32, point_dim=6,
              fused_trunk="on", film_every=1)
    jnet = jm.VelocityNet(**kw)
    rng = np.random.RandomState(3)
    params = jnet.init(jax.random.PRNGKey(3), jnp.zeros((2, 8, 6)),
                       jnp.zeros((2,)), jnp.zeros((2, 3)))["params"]
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p, np.float32)
        + 0.05 * rng.randn(*np.shape(p)).astype(np.float32), params)
    net = VelocityNet(**kw, generator=torch.Generator().manual_seed(0))
    net.load_state_dict(interop.velocity_net_to_sd(params))
    x = rng.randn(2, 64, 6).astype(np.float32)
    t = rng.rand(2).astype(np.float32)
    c = rng.randn(2, 3).astype(np.float32)

    def jax_sum(p):
        return jnp.sum(jnet.apply({"params": p}, jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(c)))
    want_v = np.asarray(jnet.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(t), jnp.asarray(c)))
    want_g = interop.velocity_net_to_sd(jax.grad(jax_sum)(params))
    v = net(*(torch.from_numpy(a) for a in (x, t, c)))
    _grad_close(v.detach().numpy(), want_v, 1e-4, "velocity")
    grads = dict(zip([k for k, _ in net.named_parameters()],
                     torch.autograd.grad(v.sum(), list(net.parameters()))))
    assert set(grads) == set(want_g)
    for name, g in grads.items():
        _grad_close(g.numpy(), want_g[name].numpy(), 1e-4, name)


@pytest.mark.parametrize("c", [1024, 2048])
def test_rows_packed_index_is_a_permutation_at_wide_widths(c):
    # the wide paths' A operands (packed silu(f), packed dy) are in this
    # byte order: every (b, n, k) lands in one place, the rows past N and
    # nothing else left over
    bsz, n = 2, 65
    idx = fb.rows_packed_index(bsz, n, c).reshape(-1)
    tiles = bsz * 2
    assert torch.equal(torch.unique(idx), torch.sort(idx).values)
    assert int(idx.max()) < tiles * 64 * c
    x = torch.randn(bsz, n, c, generator=torch.Generator().manual_seed(c))
    packed = fb.pack_rows_reference(x)
    assert torch.equal(packed[idx].view(bsz, n, c), x.bfloat16())
    assert int((packed != 0).sum()) == int((x.bfloat16() != 0).sum())


@pytest.mark.parametrize("b,n,k,want", [
    # C = 2048: 32 regions of 64 rows x 64 columns (4096 values) a tile;
    # tile = b * ceil(N / 64) + n // 64, r = n % 64 (N = 65: 2 tiles a
    # cloud); chunk (k % 64) // 8 ^ r % 8
    (0, 0, 0, 0),
    (0, 1, 2047, 31 * 4096 + 64 + (7 ^ 1) * 8 + 7),
    (0, 64, 1000, 1 * 64 * 2048 + 15 * 4096 + ((40 // 8) ^ 0) * 8 + 0),
    (1, 10, 1100, 2 * 64 * 2048 + 17 * 4096 + 10 * 64
     + ((12 // 8) ^ 2) * 8 + 4)])
def test_rows_packed_index_matches_swizzle_formula_at_2048(b, n, k, want):
    assert int(fb.rows_packed_index(2, 65, 2048)[b, n, k]) == want


def test_kernel_limit_is_named():
    # the wrappers refuse a width above MAX_C (2048) before any launch
    assert fb.MAX_C == fb.MAX_C_BWD == 2048
    assert fb.NARROW_C == 1024 and fb.NARROW_C_BWD == 512
    h, s, t, gamma, beta, w, b = _port_args(_inputs(1, b=1, n=4, c=2176))
    args = {"h": h, "s": s, "t": t, "gamma": gamma, "beta": beta, "w": w,
            "b": b}
    with pytest.raises(ValueError, match=r"C <= 2048 \(MAX_C\)"):
        fb._check_operands(h, args, fb.MAX_C)
    with pytest.raises(ValueError, match=r"C <= 2048 \(MAX_C\)"):
        fb._check_operands(h, dict(args, dy=h), fb.MAX_C_BWD)
    # at the limit the checks pass
    h, s, t, gamma, beta, w, b = _port_args(_inputs(1, b=1, n=4, c=2048))
    fb._check_operands(h, {"h": h, "s": s, "t": t, "gamma": gamma,
                           "beta": beta, "w": w, "b": b}, fb.MAX_C)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bwd_case(cuda, dtype, b, n, c, seed):
    """The backward's arguments on the card: dy, h, s, t, gamma, beta, w,
    mean, rstd (the forward kernel's statistics)."""
    h, s, t, gamma, beta, w, bias = _port_args(
        _inputs(seed, b=b, n=n, c=c), cuda, dtype)
    dy = torch.from_numpy(np.random.RandomState(seed + 1).randn(b, n, c)
                          .astype(np.float32)).to(cuda, dtype)
    _, mean, rstd = fb.film_block_forward(h, s, t, gamma, beta, w, bias)
    return dy, h, s, t, gamma, beta, w, mean, rstd


@pytest.mark.gpu
@pytest.mark.parametrize("c", [640, 1024, 1152, 2048])
@pytest.mark.parametrize("b,n", [(1, 1), (2, 65), (3, 129), (2, 300)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-2),
                                       (torch.bfloat16, 6e-2)])
def test_kernel_forward_matches_plain_version(cuda, dtype, tol, b, n, c):
    # C > 1024 takes the wide path (prologue, streamed product); the
    # product is bf16 x bf16 -> fp32, the plain version's fp32; one call of
    # the entry point, two bitwise equal
    args = _port_args(_inputs(5, b=b, n=n, c=c), cuda, dtype)
    before = fb.launches
    y, mean, rstd = fb.film_block_forward(*args)
    again = fb.film_block_forward(*args)
    torch.cuda.synchronize()
    assert fb.launches == before + 2
    want, mean_r, rstd_r = fb.film_block_reference_forward(*args)
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mean, mean_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, atol=1e-4, rtol=1e-4)
    for x, x2 in zip((y, mean, rstd), again):
        assert torch.equal(x, x2)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [640, 1024, 1152, 2048])
@pytest.mark.parametrize("b,n", [(1, 1), (2, 65), (3, 129), (2, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_version(cuda, dtype, b, n, c):
    # C > 512 takes the wide path (dy pack, streamed dp, wide rows kernel);
    # all seven gradients within 2e-2 of each one's max, two calls bitwise
    # equal
    args = _bwd_case(cuda, dtype, b, n, c, 20)
    before = fb.bwd_launches
    got = fb.film_block_backward(*args)
    again = fb.film_block_backward(*args)
    torch.cuda.synchronize()
    assert fb.bwd_launches == before + 2
    want = fb.film_block_reference_backward(*args)
    for name, g, g2, w in zip(_NAMES, got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, g2), name
        _grad_close(g.float().cpu(), w.float().cpu(), 2e-2, name)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [640, 2048])
def test_kernel_backward_fp32_takes_dy_in_fp32(cuda, c):
    # W = 0, so df = dy: every gradient but dW (a bf16 product) follows
    # from dy alone, within 1e-4 of its max
    dy, h, s, t, gamma, beta, w, mean, rstd = _bwd_case(
        cuda, torch.float32, 2, 300, c, 22)
    args = (dy, h, s, t, gamma, beta, torch.zeros_like(w), mean, rstd)
    got = fb.film_block_backward(*args)
    torch.cuda.synchronize()
    want = fb.film_block_reference_backward(*args)
    for name, g, ref in zip(_NAMES, got, want):
        if name != "w":
            _grad_close(g.cpu(), ref.cpu(), 1e-4, name)


@pytest.mark.gpu
def test_kernel_refuses_above_max_c(cuda):
    args = _port_args(_inputs(1, b=1, n=4, c=2176), cuda)
    with pytest.raises(ValueError, match=r"C <= 2048 \(MAX_C\)"):
        fb.film_block_forward(*args)
