"""The port's fused FiLM block (pcfm_torch/ops/film_block.py) against the
JAX package's kernel (pcfm/ops/pallas/film_block.py, interpret mode).

On the CPU the wrapper runs its plain-torch version; the CUDA kernel is
held against that plain version by the ``gpu`` tests.  The module imports
JAX only through a fixture, so that on a card without JAX the ``gpu``
tests run alone (``--noconftest``: tests/conftest.py sets up JAX):

    python -m pytest tests/test_torch_port_film_block.py -m gpu --noconftest
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch.ops import film_block as fb  # noqa: E402

# fp32 on both sides; measured 1.4e-6 at (2, 300, 128)
ATOL = 1e-5


def _inputs(seed, b=2, n=300, c=128):
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
    return [t[k] for k in ("h", "s", "t", "gamma", "beta", "w", "b")]


@pytest.fixture
def jax_fb():
    """(jnp, the JAX package's film_block module)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pcfm.ops.pallas import film_block
    return jnp, film_block


@pytest.mark.parametrize("n", [300, 256, 77])
def test_reference_matches_jax_kernel(jax_fb, n):
    jnp, jax_fb = jax_fb
    a = _inputs(0, n=n)
    want = np.asarray(jax_fb.film_block(
        *[jnp.asarray(a[k]) for k in ("h", "s", "t", "gamma", "beta", "w",
                                      "b")], True))
    got = fb.film_block(*_port_args(a)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_stats_match_jax_kernel(jax_fb):
    jnp, jax_fb = jax_fb
    a = _inputs(1, n=200, c=256)
    args = [jnp.asarray(a[k]) for k in ("h", "s", "t", "gamma", "beta", "w",
                                        "b")]
    y_j, (_, mean_j, rstd_j) = jax_fb._film_fwd_impl(*args, True)
    y, mean, rstd = fb.film_block_forward(*_port_args(a))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j)[:, :200],
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(rstd_j)[:, :200],
                               rtol=1e-5)


def test_cpu_call_runs_plain_version_and_counts_no_launch():
    args = _port_args(_inputs(2, n=40))
    before = fb.launches
    y = fb.film_block(*args)
    assert fb.launches == before
    torch.testing.assert_close(y, fb.film_block_reference(*args), rtol=0,
                               atol=0)


def test_cpu_bf16_keeps_dtype():
    y = fb.film_block(*_port_args(_inputs(3, n=33), dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 33, 128)


@pytest.mark.parametrize("bad", ["c", "w", "gamma", "rank"])
def test_shape_checks(bad):
    a = _inputs(4, n=16)
    args = _port_args(a)
    if bad == "c":
        args = _port_args(_inputs(4, n=16, c=96))
    elif bad == "w":
        args[5] = args[5][:, :64]
    elif bad == "gamma":
        args[3] = args[3][:1]
    else:
        args[0] = args[0][0]
    with pytest.raises(ValueError):
        fb.film_block(*args)


@pytest.mark.parametrize("c", [128, 256, 512, 1024])
def test_pack_w_reference_is_a_permutation(c):
    # every W entry lands in one place of the packed buffer, and reading it
    # back there gives w.bfloat16() bitwise
    w = torch.from_numpy(np.random.RandomState(c).randn(c, c)
                         .astype(np.float32))
    packed = fb.pack_w_reference(w)
    idx = fb.packed_index(c).reshape(-1)
    assert packed.dtype == torch.bfloat16 and packed.shape == (c * c,)
    assert torch.equal(torch.sort(idx).values, torch.arange(c * c))
    assert torch.equal(packed[idx].view(c, c), w.bfloat16())
    assert torch.equal(fb.pack_w(w), packed)          # CPU: plain version


@pytest.mark.parametrize("n,k,want", [
    (0, 0, 0), (0, 8, 8), (1, 0, 72), (1, 8, 64), (7, 63, 7 * 64 + 7),
    (8, 0, 8 * 64),
    # C = 256: k tile 1 of output tile 0 is stage 1
    (9, 64, (1 * 128 + 9) * 64 + 1 * 8),
    # output tile 1, k tile 1: stage 1 * 4 + 1; chunk 1 ^ (130 % 8)
    (130, 72, (5 * 128 + 2) * 64 + 3 * 8),
    (255, 255, (7 * 128 + 127) * 64 + (7 ^ 7) * 8 + 7)])
def test_pack_w_matches_swizzle_formula(n, k, want):
    # offset = (stage * 128 + n % 128) * 64 + ((k % 64) // 8 ^ n % 8) * 8
    #          + k % 8, stage = (n // 128) * (C // 64) + k // 64; C = 256
    assert int(fb.packed_index(256)[n, k]) == want
    w = torch.zeros(256, 256)
    w[n, k] = 1.5
    packed = fb.pack_w_reference(w)
    assert float(packed[want]) == 1.5 and int((packed != 0).sum()) == 1


@pytest.mark.parametrize("c", [128, 256, 512])
def test_pack_wt_reference_is_a_permutation(c):
    # the backward's Wᵀ tiles: every W entry lands once, and reading the
    # packed buffer back through the formula gives w.bfloat16() bitwise
    w = torch.from_numpy(np.random.RandomState(c + 1).randn(c, c)
                         .astype(np.float32))
    packed = fb.pack_wt_reference(w)
    idx = fb.packed_t_index(c).reshape(-1)
    assert packed.dtype == torch.bfloat16 and packed.shape == (c * c,)
    assert torch.equal(torch.sort(idx).values, torch.arange(c * c))
    assert torch.equal(packed[idx].view(c, c), w.bfloat16())


@pytest.mark.parametrize("c,o,i,want", [
    (128, 0, 0, 0), (128, 8, 0, 8), (128, 0, 1, 72), (128, 8, 1, 64),
    # k (= o) tile 1 of input tile 0 is stage 1
    (128, 64, 0, 1 * 128 * 64),
    # C = 256: input tile 1, k tile 0: stage 1 * 4; chunk 1 ^ (130 % 8)
    (256, 9, 130, (4 * 128 + 2) * 64 + 3 * 8 + 1),
    (256, 255, 0, (3 * 128 + 0) * 64 + 7 * 8 + 7),
    # C = 512: stage 2 * 8 + 1; chunk (36 // 8) ^ (44 % 8) = 0
    (512, 100, 300, (17 * 128 + 44) * 64 + 0 + 4),
    (512, 511, 511, (31 * 128 + 127) * 64 + (7 ^ 7) * 8 + 7)])
def test_pack_wt_matches_swizzle_formula(c, o, i, want):
    # W[o, i] is row i, column o of Wᵀ: offset = (stage * 128 + i % 128)
    # * 64 + ((o % 64) // 8 ^ i % 8) * 8 + o % 8, stage = (i // 128) *
    # (C // 64) + o // 64
    assert int(fb.packed_t_index(c)[o, i]) == want
    w = torch.zeros(c, c)
    w[o, i] = 1.5
    packed = fb.pack_wt_reference(w)
    assert float(packed[want]) == 1.5 and int((packed != 0).sum()) == 1


@pytest.mark.parametrize("c", [128, 256, 512])
def test_pack_rows_reference_is_a_permutation_with_zero_rows(c):
    # the dW pass's packed dy and p: (2, 65, C) takes 2 tiles a cloud; the
    # 63 rows past N of each cloud's last tile are zeros
    x = torch.from_numpy(np.random.RandomState(c + 2).randn(2, 65, c)
                         .astype(np.float32)) + 10.0       # never zero
    packed = fb.pack_rows_reference(x)
    idx = fb.rows_packed_index(2, 65, c).reshape(-1)
    assert packed.shape == (2 * 2 * 64 * c,)
    assert int(idx.unique().numel()) == idx.numel() == 2 * 65 * c
    assert torch.equal(packed[idx].view(2, 65, c), x.bfloat16())
    assert int((packed != 0).sum()) == 2 * 65 * c


@pytest.mark.parametrize("c,b,n,k,want", [
    (c, *case) for c in (128, 256, 512) for case in [
        (0, 0, 0, 0), (0, 0, 8, 8), (0, 1, 0, 72), (0, 1, 8, 64),
        (0, 0, 64, 64 * 64),                       # column region 1
        (1, 64, 9, 3 * 64 * c + 8 + 1),            # cloud 1, tile 1: tile 3
        # last column of row 63: region C / 64 - 1, chunk 7 ^ 7
        (0, 63, c - 1, (c // 64 - 1) * 64 * 64 + 63 * 64 + 7)]])
def test_rows_packed_index_matches_swizzle_formula(c, b, n, k, want):
    # offset = tile * 64 * C + (k // 64) * 64 * 64 + r * 64
    #          + ((k % 64) // 8 ^ r % 8) * 8 + k % 8,
    # tile = b * ceil(N / 64) + n // 64, r = n % 64; here N = 65
    assert int(fb.rows_packed_index(2, 65, c)[b, n, k]) == want
    x = torch.zeros(2, 65, c)
    x[b, n, k] = 2.5
    packed = fb.pack_rows_reference(x)
    assert float(packed[want]) == 2.5 and int((packed != 0).sum()) == 1


@pytest.mark.parametrize("bad", ["strided", "bf16", "shape"])
def test_kernel_checks_refuse_bad_w(bad):
    # what the forward kernel's wrapper checks before a launch: W (C, C),
    # fp32, contiguous (the checks are the same on any device)
    h, s, t, gamma, beta, w, b = _port_args(_inputs(13, n=16))
    args = {"h": h, "s": s, "t": t, "gamma": gamma, "beta": beta, "w": w,
            "b": b}
    if bad == "strided":
        args["w"] = w.T
        with pytest.raises(ValueError, match="contiguous"):
            fb._check_operands(h, args, fb.MAX_C)
    elif bad == "bf16":
        args["w"] = w.bfloat16()
        with pytest.raises(TypeError, match="w must be"):
            fb._check_operands(h, args, fb.MAX_C)
    else:
        with pytest.raises(ValueError, match="w must be"):
            fb.film_block(h, s, t, gamma, beta, w[:, :64].contiguous(), b)
        with pytest.raises(ValueError, match=r"\(C, C\)"):
            fb.pack_w(w[:, :64])


_NAMES = ("h", "s", "t", "gamma", "beta", "w", "b")


def _grad_close(got, want, rel, where=""):
    """|got - want| <= rel * max|want|, elementwise."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, where
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, atol=rel, rtol=0,
                               err_msg=where)


@pytest.mark.parametrize("n", [256, 200])
def test_backward_matches_jax_grad(jax_fb, n):
    # the port's autograd Function (plain backward on the CPU) against
    # jax.grad through the Pallas kernel's custom_vjp (interpret mode)
    jnp, jax_fb = jax_fb
    import jax
    a = _inputs(7, n=n, c=256)
    dy = np.random.RandomState(8).randn(2, n, 256).astype(np.float32)
    want = jax.grad(
        lambda *x: jnp.sum(jax_fb.film_block(*x, True) * dy),
        argnums=tuple(range(7)))(*[jnp.asarray(a[k]) for k in _NAMES])
    args = [x.requires_grad_(True) for x in _port_args(a)]
    before = fb.bwd_launches
    got = torch.autograd.grad(fb.film_block(*args), args,
                              torch.from_numpy(dy))
    assert fb.bwd_launches == before                  # CPU: plain version
    for name, g, w in zip(_NAMES, got, want):
        w = np.asarray(w)
        if name == "w":                               # JAX (in, out)
            w = w.T
        _grad_close(g.numpy(), w, 1e-4, name)


def test_reference_backward_matches_autograd():
    a = _inputs(9, n=123, c=256)
    args = [x.requires_grad_(True) for x in _port_args(a)]
    dy = torch.from_numpy(
        np.random.RandomState(10).randn(2, 123, 256).astype(np.float32))
    want = torch.autograd.grad(fb.film_block_reference(*args), args, dy)
    with torch.no_grad():
        _, mean, rstd = fb.film_block_reference_forward(*args)
        got = fb.film_block_reference_backward(dy, *args[:6], mean, rstd)
    for name, g, w in zip(_NAMES, got, want):
        _grad_close(g, w, 1e-5, name)


def test_backward_keeps_jax_dtypes():
    # dh in h's dtype, dgamma / dbeta in gamma's, the weights' grads fp32
    args = [x.requires_grad_(True)
            for x in _port_args(_inputs(11, n=40), dtype=torch.bfloat16)]
    y = fb.film_block(*args)
    grads = torch.autograd.grad(y.float().square().sum(), args)
    assert [g.dtype for g in grads] == [x.dtype for x in args]
    assert grads[0].dtype == torch.bfloat16 and grads[5].dtype == \
        torch.float32
    assert all(torch.isfinite(g.float()).all() for g in grads)


def test_backward_takes_strided_dy():
    # autograd may hand the Function a non-contiguous dy (here: a transposed
    # view); the result must equal the contiguous one's
    args = [x.requires_grad_(True) for x in _port_args(_inputs(12, n=64))]
    y = fb.film_block(*args)
    dy = torch.randn(2, 128, 64).transpose(1, 2)
    assert not dy.is_contiguous()
    got = torch.autograd.grad(y, args, dy)
    want = torch.autograd.grad(fb.film_block(*args), args, dy.contiguous())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _fake_nvcc(tmp_path, monkeypatch, script):
    """Point the builder at a stand-in nvcc and a private build dir."""
    from pcfm_torch.ops import build
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "LIB_PATH", str(tmp_path / "build" / "lib.so"))
    return build


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    build = _fake_nvcc(tmp_path, monkeypatch,
                       'echo "film_block.cu(3): error: boom" >&2; exit 2\n')
    with pytest.raises(RuntimeError, match="boom"):
        build.build()
    assert not (tmp_path / "build" / "lib.so").exists()


def test_build_rebuilds_only_when_stale(tmp_path, monkeypatch):
    # the stand-in writes its -o argument, like nvcc
    build = _fake_nvcc(tmp_path, monkeypatch, """
while [ "$1" != "-o" ]; do shift; done
echo lib > "$2"
echo "ptxas info: Used 1 registers"
""")
    assert build.sources() and all(s.endswith(".cu")
                                   for s in build.sources())
    first = build.build()
    assert first["built"] and "registers" in first["log"]
    assert not build.is_stale() and not build.build()["built"]
    lib = tmp_path / "build" / "lib.so"
    old = max(os.path.getmtime(s) for s in build.sources()) - 10
    os.utime(lib, (old, old))                      # a source is newer
    assert build.is_stale() and build.build()["built"]


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("c", [128, 256, 512, 1024])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 300, 1000])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-2),
                                       (torch.bfloat16, 6e-2)])
def test_kernel_matches_plain_version(cuda, dtype, tol, n, c, b):
    # the kernel's product is bf16 x bf16 -> fp32 (the TPU kernel's DEFAULT
    # precision); the plain version multiplies in fp32. N covers one row,
    # the 64- and 128-row tiles' edges and a ragged last tile; C = 1024
    # takes the one-warpgroup (64-row) variant
    args = _port_args(_inputs(5, b=b, n=n, c=c), cuda, dtype)
    before = fb.launches
    y, mean, rstd = fb.film_block_forward(*args)
    torch.cuda.synchronize()
    assert fb.launches == before + 1
    want, mean_r, rstd_r = fb.film_block_reference_forward(*args)
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(mean, mean_r, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_r, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [128, 256, 512, 1024])
def test_kernel_pack_w_matches_reference(cuda, c):
    w = torch.randn(c, c, generator=torch.Generator().manual_seed(c))
    got = fb.pack_w(w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), fb.pack_w_reference(w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_two_launches_bitwise_equal(cuda, dtype):
    args = _port_args(_inputs(14, b=3, n=1000, c=512), cuda, dtype)
    first = fb.film_block_forward(*args)
    second = fb.film_block_forward(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n", [(torch.float32, 300),
                                     (torch.bfloat16, 1000)])
def test_kernel_backward_matches_plain_and_refuses_mixed_dtypes(cuda, dtype,
                                                                n):
    # gradients go through the backward kernel (one launch) and match the
    # plain backward within bf16-product error relative to each one's max
    args = [x.requires_grad_(True)
            for x in _port_args(_inputs(6, n=n, c=256), cuda, dtype)]
    dy = torch.randn(2, n, 256, device=cuda).to(dtype)
    y = fb.film_block(*args)
    before = fb.bwd_launches
    got = torch.autograd.grad(y, args, dy)
    torch.cuda.synchronize()
    assert fb.bwd_launches == before + 1
    with torch.no_grad():
        _, mean, rstd = fb.film_block_forward(*args)
        want = fb.film_block_reference_backward(dy, *args[:6], mean, rstd)
    for name, g, w in zip(_NAMES, got, want):
        assert g.dtype == w.dtype, name
        _grad_close(g.float().cpu(), w.float().cpu(), 2e-2, name)
    with pytest.raises(TypeError):
        fb.film_block(*args[:3], args[3].detach().double(), *args[4:])


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
@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("c", [128, 256, 384, 512])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 128, 129, 300, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_version(cuda, dtype, n, c, b):
    # one launch; all seven gradients within 2e-2 of each one's max (bf16
    # products, fp32 sums in another order); two launches bitwise equal.
    # N covers one row, the 64-row tiles' edges and ragged last tiles; C
    # odd multiples of 128 leave one warpgroup without a chunk
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
@pytest.mark.parametrize("c", [128, 384, 512])
def test_kernel_backward_fp32_takes_dy_in_fp32(cuda, c):
    # W = 0, so df = dy: every gradient but dW (a bf16 product) follows
    # from dy alone. dy rounded to bf16 would miss by ~1e-3 of a gradient's
    # max; fp32 sums in another order stay far inside 1e-4
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
def test_sample_cli_on_card_goes_through_kernel(cuda, tmp_path):
    from pcfm_torch.config import Config
    from pcfm_torch.sample import cli
    from pcfm_torch.train import checkpoint
    from pcfm_torch.train.state import ModelBundle
    cfg = Config(latent_dim=16, pf_width=128, pf_depth=3, pf_emb_dim=32,
                 lf_width=64, lf_depth=3, lf_emb_dim=16, enc_width=32,
                 has_rgb=True, cond_dim=2, fused_trunk="on", sample_steps=2)
    checkpoint.save(str(tmp_path), 1, ModelBundle(
        cfg, "cpu", torch.Generator().manual_seed(10)))
    for extra in ([], ["--guidance_scale", "0.5"]):
        before = fb.launches
        x = cli.main(["--out_dir", str(tmp_path), "--num_samples", "2",
                      "--n_points", "300", *extra])
        # 2 FiLM blocks x 2 Heun steps x 2 evaluations, CFG in one batch
        assert fb.launches - before == 8
        assert x.shape == (2, 300, 6) and np.isfinite(x).all()


@pytest.mark.gpu
def test_train_step_on_card_goes_through_both_kernels(cuda):
    from pcfm_torch.config import Config
    from pcfm_torch.train import state, step
    cfg = Config(latent_dim=16, enc_width=32, pf_width=128, pf_depth=3,
                 pf_emb_dim=32, lf_width=64, lf_depth=3, lf_emb_dim=16,
                 has_rgb=True, cond_dim=1, fused_trunk="on")
    st = state.init_state(cfg, cuda, 10, torch.Generator().manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"pts": torch.randn(2, 300, 3, device=cuda),
             "rgb": torch.rand(2, 300, 3, device=cuda),
             "cond": torch.rand(2, 1, device=cuda)}
    fwd, bwd = fb.launches, fb.bwd_launches
    m = step.train_step(st, batch, gen, 1.0, 0.1)
    torch.cuda.synchronize()
    # pf_depth 3: two fused FiLM blocks, one forward and one backward each
    assert (fb.launches - fwd, fb.bwd_launches - bwd) == (2, 2)
    assert all(torch.isfinite(v) for v in m.values())
