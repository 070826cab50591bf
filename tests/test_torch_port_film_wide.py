"""The FiLM block at the widths of its wide paths (forward C > 1024 up to
``MAX_C_BF16`` = 4608 / ``MAX_C_F32`` = 4352, backward C > 512 up to
``MAX_C_BWD`` = 2688: the JAX kernel's limits), against the JAX package's kernel
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


@pytest.mark.parametrize("n,c", [(77, 640), (77, 1024), (300, 640),
                                 (300, 1024), (77, 2688)])
def test_plain_forward_and_backward_match_jax_kernel(jax_fb, c, n):
    # y and the seven gradients of the port's Function (its plain versions
    # on the CPU) against the JAX kernel and jax.grad through its
    # custom_vjp, both in interpret mode: within 1e-4 of each one's max;
    # C = 2688 is the backward kernel's widest, in both dtypes
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


def _velocity_net_matches_jax(jax_fb, width, depth, n):
    """The port's VelocityNet with the fused trunk at ``width`` against
    JAX's, with JAX's weights carried over by interop, on (2, n) points:
    the velocity and the gradients of its sum with respect to every
    parameter, within 1e-4 of each one's max."""
    jax, jnp, _ = jax_fb
    from pcfm import models as jm
    from pcfm_torch import interop
    from pcfm_torch.models import VelocityNet
    kw = dict(cond_dim=3, width=width, depth=depth, emb_dim=32, point_dim=6,
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
    x = rng.randn(2, n, 6).astype(np.float32)
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


def test_velocity_net_fused_at_width_640_matches_jax(jax_fb):
    # pf_width 640: a width only the backward's wide path takes on the card
    _velocity_net_matches_jax(jax_fb, 640, 3, 64)


def test_velocity_net_fused_at_width_2688_matches_jax(jax_fb):
    # pf_width 2688, the backward's widest (an 11-CTA cluster on the
    # card): one FiLM block on a few points
    _velocity_net_matches_jax(jax_fb, 2688, 2, 16)


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


# the wide backward's cluster split: CTAs of a cluster at each width,
# ceil(C / 256)
_CLUSTER_CTAS = {640: 3, 768: 3, 1024: 4, 1152: 5, 1536: 6, 2048: 8,
                 2176: 9, 2304: 9, 2432: 10, 2560: 10, 2688: 11}


@pytest.mark.parametrize("c", sorted(_CLUSTER_CTAS))
def test_cluster_split_covers_the_columns_in_rank_order(c):
    # the ranks' column ranges follow each other from 0 to C in 128-column
    # chunks, at most CLUSTER_MAX_CHUNKS a CTA, balanced to one chunk, in
    # clusters of at most 8 (the portable size) up to C = 2048 and at most
    # 11 above (Hopper allows non-portable clusters of up to 16)
    split = fb.cluster_split(c)
    assert len(split) == _CLUSTER_CTAS[c] <= (8 if c <= 2048 else 11)
    assert split[0][0] == 0 and split[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
    widths = [k1 - k0 for k0, k1 in split]
    assert all(w % fb.N_TILE == 0 and
               0 < w <= fb.CLUSTER_MAX_CHUNKS * fb.N_TILE for w in widths)
    assert max(widths) - min(widths) <= fb.N_TILE


def test_cluster_split_at_640_and_its_limits():
    # 5 chunks over 3 CTAs: rank q takes chunks [5 q / 3, 5 (q + 1) / 3)
    assert fb.cluster_split(640) == [(0, 128), (128, 384), (384, 640)]
    assert fb.cluster_split(2048) == [(k, k + 256) for k in range(0, 2048,
                                                                  256)]
    # 21 chunks over 11 CTAs: rank 0 takes one, every other rank two
    assert fb.cluster_split(2688) == [(0, 128)] + [
        (k, k + 256) for k in range(128, 2688, 256)]
    for c in (512, 2816, 700):      # the register path, above MAX_C, odd
        with pytest.raises(ValueError, match="cluster_split"):
            fb.cluster_split(c)


# the backward's plan up to 2048: the dW split of about 132 blocks, one
# row chunk: (nb, output tiles, slices) at (8, 20000, C)
_PLAN_UP_TO_2048 = {640: (1, 25, 5), 1024: (2, 32, 4), 1152: (1, 81, 1),
                    2048: (2, 128, 1)}


@pytest.mark.parametrize("c", sorted(_PLAN_UP_TO_2048))
def test_bwd_plan_keeps_the_split_up_to_2048(c):
    # C <= 2048 keeps its launches: the rows pass in one chunk, the dW
    # pass's 128 x 128 tiles where C % 256 != 0, about 132 blocks
    plan = fb.bwd_plan(8, 20000, c)
    nb, out_tiles, slices = _PLAN_UP_TO_2048[c]
    assert (plan["chunks"], plan["dw_nb"], plan["dw_out_tiles"],
            plan["dw_slices"]) == (1, nb, out_tiles, slices)
    assert plan["cluster_ctas"] == _CLUSTER_CTAS[c]


def test_bwd_plan_takes_full_width_dw_tiles_at_2688():
    # 21 x 11 output tiles of 128 x 256 (the last column tile stores 128
    # columns), one block a tile and row chunk, where one slice of 128 x
    # 128 tiles took 441; the rows pass in 6 chunks beside the dW pass
    assert fb.bwd_plan(8, 20000, 2688) == {
        "cluster_ctas": 11, "chunks": 6, "dw_nb": 2, "dw_out_tiles": 231,
        "dw_slices": 1, "dw_blocks": 231}


@pytest.mark.parametrize("c", [2176, 2304, 2432, 2560, 2688])
@pytest.mark.parametrize("b,n", [(8, 20000), (3, 5000), (8, 2000), (2, 300),
                                 (1, 1)])
def test_bwd_plan_above_2048_chunks_whole_pairs(b, n, c):
    # above 2048: at most BWD_CHUNKS chunks of whole pairs of row tiles (so
    # one chunk at (1, 1)), 128 x 256 dW tiles at every C in one slice,
    # each chunk adding to the chunks before it
    plan = fb.bwd_plan(b, n, c)
    pairs = -(-(b * -(-n // 64)) // 2)
    assert plan["chunks"] == min(fb.BWD_CHUNKS, pairs) >= 1
    assert plan["cluster_ctas"] == _CLUSTER_CTAS[c]
    assert (plan["dw_nb"], plan["dw_slices"]) == (2, 1)
    assert plan["dw_out_tiles"] == plan["dw_blocks"] == \
        (c // 128) * -(-c // 256)


# the wide forward's persistent product: one CTA an SM of an H100 SXM (132)
# or PCIe (114)
_H100_SMS = 132


def _fwd_grid(b, n, c):
    """(pairs of 64-row tiles, chunks of 256 columns, the last of 128 where
    C % 256 != 0) of the wide forward's product at (b, n, c)."""
    return -(-b * -(-n // 64) // 2), -(-c // 256)


@pytest.mark.parametrize("ctas", [132, 114])
@pytest.mark.parametrize("b,n,c", [(8, 20000, 4608), (8, 20000, 2048),
                                   (3, 2000, 2560), (1, 1, 2176),
                                   (2, 129, 4352), (5, 700, 1152)])
def test_fwd_raster_takes_every_tile_once(b, n, c, ctas):
    # every (pair, chunk) output tile is taken exactly once, and the CTAs'
    # counts of tiles differ by at most one
    pairs, chunks = _fwd_grid(b, n, c)
    got = fb.fwd_raster(pairs, chunks, ctas)
    assert len(got) == ctas
    taken = sorted(t for cta in got for t in cta)
    assert taken == [(p, q) for p in range(pairs) for q in range(chunks)]
    counts = [len(cta) for cta in got]
    assert max(counts) - min(counts) <= 1


def test_fwd_raster_unequal_counts_at_3x2000x2560():
    # the gpu case below: 48 pairs x 10 chunks = 480 tiles over 132 CTAs,
    # so the CTAs take 3 or 4 tiles
    pairs, chunks = _fwd_grid(3, 2000, 2560)
    counts = [len(cta) for cta in fb.fwd_raster(pairs, chunks, _H100_SMS)]
    assert pairs * chunks == 480 and sorted(set(counts)) == [3, 4]


def test_fwd_raster_keeps_a_band_of_w_in_l2_at_4608():
    # at (8, 20000, 4608) bf16 on 132 SMs: every wave (the w-th tile of
    # each CTA, at work at once) outside the last band takes at most 9 of
    # W's 18 chunks of 256 columns (2.36 MB each): that band of W beside a
    # band's A (FWD_BAND_PAIRS pairs of 128 rows) stays under the H100's
    # 50 MB L2; the earlier chunk-fastest grid took all 18 in every wave
    c = 4608
    pairs, chunks = _fwd_grid(8, 20000, c)
    got = fb.fwd_raster(pairs, chunks, _H100_SMS)
    last_band = (pairs - 1) // fb.FWD_BAND_PAIRS * fb.FWD_BAND_PAIRS
    waves = 0
    for w in range(max(len(cta) for cta in got)):
        wave = [cta[w] for cta in got if len(cta) > w]
        if any(p >= last_band for p, _ in wave):
            continue
        waves += 1
        band = len({q for _, q in wave})
        assert band <= 9, w
        assert band * 256 * c * 2 + fb.FWD_BAND_PAIRS * 128 * c * 2 < 50e6
    assert waves > 150


def _cluster_dh(dy, h, s, t, gamma, beta, w, mean, rstd):
    """dh as the backward's cluster kernel sums it, in plain torch (fp32
    math): each CTA's partial row sums of dxhat and dxhat * xhat over its
    columns (``fb.cluster_split``), added in rank order, then over C."""
    c = h.shape[-1]
    g = gamma[:, None, :]
    xhat = (h - mean) * rstd
    f = (xhat * s + t) * (1.0 + g) + beta[:, None, :]
    sig = torch.sigmoid(f)
    df = dy + sig * (1.0 + f * (1.0 - sig)) * (dy @ w)
    dxhat = df * (1.0 + g) * s
    m1 = m2 = torch.zeros_like(mean)
    for k0, k1 in fb.cluster_split(c):
        m1 = m1 + dxhat[..., k0:k1].sum(dim=-1, keepdim=True)
        m2 = m2 + (dxhat * xhat)[..., k0:k1].sum(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 / c - xhat * (m2 / c))


@pytest.mark.parametrize("n", [70, 129])
@pytest.mark.parametrize("c", [640, 1024, 1152, 2048, 2176, 2432, 2688])
def test_cluster_dh_matches_reference_and_jax(jax_fb, c, n):
    # dh from the cluster kernel's partial row sums (each rank's columns,
    # added in rank order) against the plain backward's dh and against
    # jax.vjp of the JAX kernel's plain reference, within 1e-4 of its max
    jax, jnp, jfb = jax_fb
    a = _inputs(c + n, n=n, c=c)
    dy = np.random.RandomState(c).randn(2, n, c).astype(np.float32)
    h, s, t, gamma, beta, w, b = _port_args(a)
    _, mean, rstd = fb.film_block_reference_forward(h, s, t, gamma, beta, w,
                                                    b)
    dyt = torch.from_numpy(dy)
    got = _cluster_dh(dyt, h, s, t, gamma, beta, w, mean, rstd)
    want = fb.film_block_reference_backward(dyt, h, s, t, gamma, beta, w,
                                            mean, rstd)[0]
    _grad_close(got.numpy(), want.numpy(), 1e-4, "dh vs plain")
    jargs = [jnp.asarray(a[k]) for k in _NAMES]
    _, vjp = jax.vjp(lambda x: jfb.film_block_reference(x, *jargs[1:]),
                     jargs[0])
    _grad_close(got.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]), 1e-4,
                "dh vs JAX")


def _limit_args(c, dtype, backward=False):
    """Zero operands at width c for the wrappers' checks (no arithmetic)."""
    f32 = torch.float32
    args = {"h": torch.zeros(1, 4, c, dtype=dtype),
            "s": torch.zeros(c), "t": torch.zeros(c),
            "gamma": torch.zeros(1, c, dtype=dtype),
            "beta": torch.zeros(1, c, dtype=dtype),
            "w": torch.zeros(c, c, dtype=f32)}
    if backward:
        args.update(dy=args["h"], mean=torch.zeros(1, 4, 1),
                    rstd=torch.zeros(1, 4, 1))
    else:
        args["b"] = torch.zeros(c)
    return args


def test_kernel_limit_is_named():
    # the wrappers refuse a width above each direction's limit before any
    # launch: the forward's MAX_C_BF16 = 4608 for bf16 h and MAX_C_F32 =
    # 4352 for fp32 and the backward's MAX_C_BWD = 2688 in both dtypes (the
    # JAX kernel's); each message names its limit and the dtype
    assert (fb.MAX_C_BF16, fb.MAX_C_F32, fb.MAX_C_BWD) == (4608, 4352, 2688)
    assert fb.NARROW_C == 1024 and fb.NARROW_C_BWD == 512
    for dtype, name, limit in ((torch.bfloat16, "bfloat16", 4608),
                               (torch.float32, "float32", 4352)):
        assert fb.kernel_max_c(dtype) == (limit, "MAX_C_" + (
            "BF16" if dtype == torch.bfloat16 else "F32"))
        assert fb.kernel_max_c(dtype, backward=True) == (2688, "MAX_C_BWD")
        args = _limit_args(limit + 128, dtype)
        with pytest.raises(ValueError, match=rf"C <= {limit} \(MAX_C_"
                                             rf"(BF16|F32)\) for {name} h"):
            fb._check_operands(args["h"], args)
        args = _limit_args(2816, dtype, backward=True)
        with pytest.raises(ValueError, match=rf"C <= 2688 \(MAX_C_BWD\) "
                                             rf"for {name} h"):
            fb._check_operands(args["h"], args, backward=True)
        # at each limit the checks pass
        args = _limit_args(limit, dtype)
        fb._check_operands(args["h"], args)
        args = _limit_args(2688, dtype, backward=True)
        fb._check_operands(args["h"], args, backward=True)


@pytest.mark.parametrize("c,dtype", [(4608, "bfloat16"), (4352, "float32")])
def test_plain_forward_matches_jax_kernel_at_the_forward_limit(jax_fb, c,
                                                               dtype):
    # the widest C the forward kernel takes in each dtype, the JAX
    # kernel's own limit: the port's plain forward (what the card's kernel
    # is held against) against the JAX kernel in interpret mode, B = 1 and
    # a few rows; y within 1e-4 of its max (fp32) or within one bf16
    # rounding of it (bf16: both round the same fp32 sums to bf16)
    jax, jnp, jfb = jax_fb
    a = _inputs(c, b=1, n=9, c=c)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jargs = [jnp.asarray(a[k]) for k in _NAMES]
    for i in (0, 3, 4):                               # h, gamma, beta
        jargs[i] = jargs[i].astype(jdt)
    want = np.asarray(jfb.film_block(*jargs, True).astype(jnp.float32))
    got = fb.film_block(*_port_args(a, dtype=tdt))
    assert got.dtype == tdt and got.shape == (1, 9, c)
    _grad_close(got.float().numpy(), want,
                1e-4 if dtype == "float32" else 2 ** -7, "y")


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
@pytest.mark.parametrize("c", [640, 1024, 1152, 2048, 2176, 2304, 2432,
                               2560, 2688])
@pytest.mark.parametrize("b,n", [(1, 1), (2, 65), (3, 129), (2, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_version(cuda, dtype, b, n, c):
    # C > 512 takes the wide path (dy pack, cluster kernel, dW pass), with
    # a non-portable cluster of 9 / 10 / 11 CTAs above 2048, where the
    # rows pass runs in chunks beside the dW pass (128 x 256 tiles, the
    # last column tile of 128 at C % 256 != 0), and up to 2048 the dW
    # pass's 128-column tiles where C % 256 != 0; all seven gradients
    # within 2e-2 of each one's max, two calls bitwise equal
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
@pytest.mark.parametrize("c,dtype,n", [(1024, torch.bfloat16, 2000),
                                       (2688, torch.bfloat16, 2000),
                                       (2688, torch.float32, 2000),
                                       (2432, torch.bfloat16, 2000),
                                       (2560, torch.bfloat16, 5000)])
def test_kernel_backward_twice_is_bitwise_equal(cuda, c, dtype, n):
    # the cluster kernel adds the ranks' row sums in rank order and the
    # tile sums in a fixed order, and above 2048 each row chunk's dW adds
    # to the chunks before it in order: two launches give the same bits,
    # with 4 CTAs a cluster and with 10 or 11 in 6 chunks beside the dW
    # pass, whose persistent clusters take the pairs in any order
    args = _bwd_case(cuda, dtype, 8, n, c, 23)
    got = fb.film_block_backward(*args)
    again = fb.film_block_backward(*args)
    torch.cuda.synchronize()
    for name, g, g2 in zip(_NAMES, got, again):
        assert torch.equal(g, g2), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_backward_clusters_fit_and_workspace_holds_no_dp(cuda,
                                                                dtype):
    # every wide width's cluster fits on the card, and the workspace (fp32
    # floats) holds packed p and dy (bf16: one float an element of the
    # tiles' rows) and small sums, but no fp32 dp, which alone would be
    # another float an element
    lib = fb._lib()
    for c in _CLUSTER_CTAS:
        assert fb.bwd_max_clusters(c, dtype == torch.bfloat16,
                                   cuda.index or 0) >= 1
    for b, n in [(8, 20000), (3, 5000)]:
        for c in _CLUSTER_CTAS:
            elems = b * -(-n // 64) * 64 * c
            got = lib.pcfm_film_block_bwd_workspace(b, n, c)
            assert elems <= got < 1.5 * elems, (b, n, c, got / elems)


@pytest.mark.gpu
def test_kernel_backward_plan_matches_its_mirror(cuda):
    # the C entry point's plan (chunks, dW tiles and slices) is bwd_plan's
    for b, n in [(8, 20000), (3, 5000), (8, 2000), (2, 300), (1, 1)]:
        for c in (512, 640, 1152, 2048, 2176, 2304, 2432, 2560, 2688):
            assert fb.bwd_plan_of_kernel(b, n, c) == fb.bwd_plan(b, n, c), \
                (b, n, c)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [640, 2048, 2688])
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
    # the forward stops at 4736 (bf16) and 4480 (fp32), the backward at
    # 2816, each by its named limit and before any launch
    for dtype, c, name in ((torch.bfloat16, 4736, r"4608 \(MAX_C_BF16\)"),
                           (torch.float32, 4480, r"4352 \(MAX_C_F32\)")):
        args = [x.to(cuda) for x in _limit_args(c, dtype).values()]
        before = fb.launches
        with pytest.raises(ValueError, match="C <= " + name):
            fb.film_block_forward(*args)
        assert fb.launches == before
    a = {k: x.to(cuda) for k, x in _limit_args(2816, torch.bfloat16,
                                                 backward=True).items()}
    before = fb.bwd_launches
    with pytest.raises(ValueError, match=r"C <= 2688 \(MAX_C_BWD\)"):
        fb.film_block_backward(*(a[k] for k in (
            "dy", "h", "s", "t", "gamma", "beta", "w", "mean", "rstd")))
    assert fb.bwd_launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("c,dtype", [(2176, torch.bfloat16),
                                     (2560, torch.bfloat16),
                                     (4608, torch.bfloat16),
                                     (2176, torch.float32),
                                     (4352, torch.float32)])
@pytest.mark.parametrize("b,n", [(1, 1), (2, 129), (1, 300)])
def test_kernel_forward_matches_plain_version_above_2048(cuda, c, dtype, b,
                                                        n):
    # the wide forward above the backward's widths: the statistics kernel
    # at the dtype's widest row, the product with a last chunk of 128
    # columns (2176) or of 256; within the phase-2 tolerances of its plain
    # version, two calls bitwise equal
    tol = 3e-2 if dtype == torch.float32 else 6e-2
    args = _port_args(_inputs(7, b=b, n=n, c=c), cuda, dtype)
    y, mean, rstd = fb.film_block_forward(*args)
    again = fb.film_block_forward(*args)
    torch.cuda.synchronize()
    want, mean_r, rstd_r = fb.film_block_reference_forward(*args)
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mean, mean_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, atol=1e-4, rtol=1e-4)
    for x, x2 in zip((y, mean, rstd), again):
        assert torch.equal(x, x2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_forward_with_unequal_persistent_tiles(cuda, dtype):
    # (3, 2000, 2560): 480 output tiles over the card's persistent CTAs,
    # which take unequal numbers of them (3 or 4 on 132 SMs); against the
    # plain version within the phase-2 tolerances, two calls bitwise equal
    tol = 3e-2 if dtype == torch.float32 else 6e-2
    args = _port_args(_inputs(9, b=3, n=2000, c=2560), cuda, dtype)
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
def test_function_above_max_c_bwd_runs_forward_and_refuses_backward(cuda):
    # the autograd Function at C = 2816: the forward kernel runs, the
    # backward stops by its named limit (no plain-version fallback)
    args = [x.requires_grad_(True) for x in _port_args(
        _inputs(8, b=1, n=70, c=2816), cuda, torch.bfloat16)]
    before = fb.launches, fb.bwd_launches
    y = fb.film_block(*args)
    assert fb.launches == before[0] + 1
    with pytest.raises(ValueError, match=r"C <= 2688 \(MAX_C_BWD\)"):
        y.float().sum().backward()
    assert fb.bwd_launches == before[1]
