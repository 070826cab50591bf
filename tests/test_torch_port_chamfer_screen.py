"""The chamfer kernel's screen and its margin (pcfm_torch/csrc/chamfer_nn.cu),
emulated on the CPU.

The kernel scores every (query, target) pair with a screen s ~ |a~ - b~|^2,
where x~ is x minus the pair's first target point rounded to TF32, on the
tensor cores, and checks in the difference form every share of targets
(one lane's 8 of a group of 32) whose least screen is at most a threshold
T(U), U a proven upper bound on the query's nearest distance.  Here:

  * ``threshold`` / ``upper`` / ``margin_at`` mirror the source's T, Ub and
    M constant for constant, in float32; the constants are read from the
    source, so that the two cannot drift apart;
  * the screen is emulated in numpy: TF32 inputs (round to nearest, ties
    away, 10 mantissa bits), the source's K-vectors, exact products, an
    fp32 sum; the tensor cores' accumulation is then charged with the error
    the source allows for it (n 2^-23 of the terms' magnitudes, n terms a
    k-step), against the query;
  * the nearest target, and every target tied with it, must pass T at its
    own distance, and the emulated search (every share whose least screen
    passes the final threshold, checked in difference form) must return
    ``chamfer_nn_reference``'s (dist, idx) bitwise;

on random clouds, clouds shifted by 1e2 and 1e4, an integer lattice with
exact ties, duplicated targets, clouds sorted along one axis, and D = 1, 3,
6, 8.  The kernel itself is held against the plain version on the card
(tests/test_torch_port_eval.py, ``-m gpu``, and chip_smoke.py phase 14).
"""
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pcfm_torch.ops import chamfer  # noqa: E402

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcfm_torch", "csrc", "chamfer_nn.cu")
GROUP = 32                 # targets a group; a lane's share is 8 of them
SEEDS = 256
f32 = np.float32


def _constants() -> dict:
    """The source's ``constexpr float`` constants, evaluated in order."""
    text = open(SOURCE).read()
    out = {}
    for name, expr in re.findall(r"constexpr float (\w+) = ([^;]+);", text):
        py = re.sub(r"(0x[0-9a-fA-F.]+p[-+]?\d+)f", lambda m: repr(
            float.fromhex(m.group(1))), expr)
        py = re.sub(r"(\d+\.\d*)f\b", r"\1", py)
        out[name] = eval(py, {}, dict(out))  # noqa: S307 (source literals)
    return out


C = _constants()
K = {k: f32(v) for k, v in C.items()}


def tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, 10 bits."""
    bits = np.asarray(x, f32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(f32)


def split(x):
    hi = tf32(x)
    return hi, tf32(f32(x) - hi)


def fma_norm(x):
    """sum_d x_d^2 by fmaf in d order (the products of TF32 values exact)."""
    acc = np.zeros(x.shape[:-1], f32)
    for d in range(x.shape[-1]):
        acc = f32(acc.astype(np.float64) + x[..., d].astype(np.float64) ** 2)
    return acc


def threshold(u, an):
    """T(U), as chamfer_nn.cu computes it."""
    u, an = f32(u), f32(an)
    r = (np.sqrt(u * K["A_UP"]) + f32(2) * K["W_ERR"] * an) * K["R_W"]
    x = r * r * K["A_UP"]
    return x + K["KAPPA"] * K["A_UP"] * (f32(2) * an + r) * (f32(2) * an + r) \
        + K["GUARD"] * x


def upper(s, ahat, an):
    """Ub(s), as chamfer_nn.cu computes it."""
    s, ahat, an = f32(s), f32(ahat), f32(an)
    r2 = (s + ahat * K["UB_A"]) * K["UB_D"]
    q = np.sqrt(np.maximum(r2, f32(0))) * (f32(1) + K["W_ERR"]) \
        + f32(2) * K["W_ERR"] * an
    return q * q * K["A_UP"]


def margin_at(smin, ahat, an):
    tf = threshold(upper(smin, ahat, an), an)
    return (tf - f32(smin)) + K["GUARD"] * (np.abs(f32(smin)) + tf)


def screen(a, b):
    """The kernel's screen of queries a (n, D) against targets b (m, D),
    with the fp32 sum exact before its one rounding: (s (n, m), the terms'
    magnitudes (n, m), ahat (n,))."""
    c = b[0]
    at, bt = tf32(f32(a - c)), tf32(f32(b - c))
    ahat, nb = fma_norm(at), fma_norm(bt)
    (ahi, alo), (nhi, nlo) = split(ahat), split(nb)
    at64, bt64 = at.astype(np.float64), bt.astype(np.float64)
    dots = -2.0 * at64 @ bt64.T                      # every product exact
    tail_a = ahi.astype(np.float64) + alo
    tail_b = nhi.astype(np.float64) + nlo
    s = f32(dots + tail_a[:, None] + tail_b[None, :])
    mags = 2.0 * np.abs(at64) @ np.abs(bt64).T \
        + (np.abs(ahi) + np.abs(alo))[:, None] \
        + (np.abs(nhi) + np.abs(nlo))[None, :]
    return s, mags, ahat


def hw_error(mags, d):
    """What the source allows the tensor cores' accumulation: n 2^-23 of
    the terms' magnitudes, n = 9 terms (8 products and the accumulator) a
    k-step of 8, K = D + 4."""
    steps = (d + 4 + 7) // 8
    return f32(9 * steps * 2.0 ** -23 * mags)


def shares(s):
    """Least screen of every lane's share: targets j with j // 32 = group
    and (j % 8) // 2 = lane, (n, groups, 4); padding screens +inf."""
    n, m = s.shape
    pad = -m % GROUP
    s = np.concatenate([s, np.full((n, pad), np.inf, f32)], 1)
    return s.reshape(n, -1, 4, 4, 2).min(axis=(2, 4))


def reference_d2(q, t):
    """chamfer_nn_reference's distances for one chunk of every pair,
    computed as it computes them (so equal bitwise)."""
    diff = q[:, :, None, :] - t[:, None, :, :]
    return (diff * diff).sum(-1)


def emulate(a, b):
    """The two-stage search for clouds a (P, n, D) and b (P, m, D), pairs
    p -> p: (dist, idx, candidate shares per query) and, per pair, the
    screen data.  U is the final bound the kernel reaches: the seeds'
    difference form, then the least screen."""
    qa, tb = torch.from_numpy(a), torch.from_numpy(b)
    d2 = reference_d2(qa, tb).numpy()                  # (P, n, m)
    dist, idx, cands, per = [], [], [], []
    for p in range(a.shape[0]):
        s, mags, ahat = screen(a[p], b[p])
        an = np.sqrt(ahat * K["A_UP"])
        m = b.shape[1]
        ns = max(1, min(SEEDS, m // 64))
        seeds = (np.arange(ns, dtype=np.int64) * m) // ns
        useed = d2[p][:, seeds].min(1)
        t_seed = threshold(useed, an)
        smin = np.minimum(t_seed, s.min(1))
        t_final = threshold(upper(smin, ahat, an), an)
        sh = shares(s)                                  # (n, G, 4)
        passing = sh <= t_final[:, None, None]
        cols = np.arange(m)
        share_of = (cols // GROUP) * 4 + (cols % 8) // 2
        checked = passing.reshape(len(a[p]), -1)[:, share_of]   # (n, m)
        dd = np.where(checked, d2[p], np.inf)
        i = dd.argmin(1)                                # lowest index of min
        dist.append(d2[p][np.arange(len(i)), i])
        idx.append(i)
        cands.append(passing.reshape(len(a[p]), -1).sum(1))
        per.append((s, mags, ahat, an, d2[p]))
    return (np.stack(dist), np.stack(idx).astype(np.int32), np.stack(cands),
            per)


def _rng(seed):
    return np.random.RandomState(seed)


def _sorted(x):
    return np.take_along_axis(x, np.argsort(x[..., :1], axis=1), axis=1)


CASES = {
    "random_d1": lambda r: (r.randn(2, 300, 1), r.randn(2, 400, 1)),
    "random_d3": lambda r: (r.randn(2, 300, 3), r.randn(2, 400, 3)),
    "random_d6": lambda r: (r.randn(2, 300, 6), r.randn(2, 400, 6)),
    "random_d8": lambda r: (r.randn(2, 300, 8), r.randn(2, 400, 8)),
    "shift_1e2": lambda r: (r.randn(2, 300, 3) + 1e2, r.randn(2, 400, 3) + 1e2),
    "shift_1e4": lambda r: (r.randn(2, 300, 3) + 1e4, r.randn(2, 400, 3) + 1e4),
    "lattice": lambda r: (r.randint(0, 6, (2, 300, 3)),
                          r.randint(0, 6, (2, 400, 3))),
    "duplicated": lambda r: (r.randn(2, 300, 3),
                             np.concatenate([r.randn(2, 200, 3)] * 2, 1)),
    "sorted": lambda r: (_sorted(r.randn(2, 300, 3)),
                         _sorted(r.randn(2, 400, 3))),
    "sorted_d8": lambda r: (_sorted(r.randn(2, 300, 8)),
                            _sorted(r.randn(2, 333, 8))),
}


def _case(name):
    a, b = CASES[name](_rng(sum(map(ord, name))))
    return np.ascontiguousarray(a, f32), np.ascontiguousarray(b, f32)


def test_constants_are_the_sources():
    assert C["KAPPA"] == chamfer.SCREEN_KAPPA == 2.0 ** -17
    assert C["GUARD"] == 2.0 ** -20
    assert C["W_ERR"] == 2.0 ** -11 + 2.0 ** -17
    for name, v in C.items():        # each exact in fp32, as the source
        assert float(f32(v)) == v, name
    # W covers the fp32 subtraction and the TF32 rounding together:
    # |tf32(fl(x)) - x| <= W |tf32(fl(x))|
    u, v = 2.0 ** -24, 2.0 ** -11
    assert (u / (1 - u) + v) / (1 - v) <= C["W_ERR"]
    # the source's accumulation allowance, with the norms' splits, is
    # inside KAPPA for two k-steps
    assert 18 * 2.0 ** -23 * (1 + 2.0 ** -10) + 2.0 ** -21 < C["KAPPA"]


def test_tf32_rounds_to_nearest_ties_away():
    x = _rng(1).randn(4096).astype(f32) * f32(1e3)
    np.testing.assert_array_equal(chamfer._tf32(torch.from_numpy(x)).numpy(),
                                  tf32(x))          # the module's, the same
    one = f32(1.0)
    ulp = f32(2.0 ** -10)
    assert tf32(one + ulp / 2) == one + ulp            # a tie: away
    assert tf32(-(one + ulp / 2)) == -(one + ulp)
    assert tf32(one + ulp / 2 - f32(2.0 ** -23)) == one
    x = _rng(0).randn(1000).astype(f32)
    err = np.abs(tf32(x).astype(np.float64) - x) / np.abs(x)
    assert err.max() <= 2.0 ** -11
    assert np.all((tf32(x).view(np.uint32) & 0x1FFF) == 0)


@pytest.mark.parametrize("name", list(CASES))
def test_nearest_target_passes_its_threshold(name):
    a, b = _case(name)
    ref_d, ref_i = chamfer.chamfer_nn_reference(
        torch.from_numpy(a), torch.from_numpy(b), [0, 1], [0, 1])
    _, _, _, per = emulate(a, b)
    d = a.shape[-1]
    for p, (s, mags, ahat, an, d2) in enumerate(per):
        best = ref_d[p].numpy()
        t = threshold(best, an)                      # T at the winner's own
        tied = d2 == best[:, None]                   # the winner and its ties
        assert tied[np.arange(len(best)), ref_i[p].numpy()].all()
        charged = s + hw_error(mags, d)              # the worst accumulation
        assert np.all(np.where(tied, charged <= t[:, None], True)), name


@pytest.mark.parametrize("name", list(CASES))
def test_upper_bounds_every_screened_target(name):
    a, b = _case(name)
    _, _, _, per = emulate(a, b)
    d = a.shape[-1]
    for s, mags, ahat, an, d2 in per:
        ub = upper(s - hw_error(mags, d), ahat[:, None], an[:, None])
        assert np.all(d2 <= ub), name


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_search_equals_the_plain_version_bitwise(name):
    a, b = _case(name)
    ref_d, ref_i = chamfer.chamfer_nn_reference(
        torch.from_numpy(a), torch.from_numpy(b), [0, 1], [0, 1])
    dist, idx, cands, _ = emulate(a, b)
    np.testing.assert_array_equal(dist, ref_d.numpy())
    np.testing.assert_array_equal(idx, ref_i.numpy())
    if name.startswith("random") or name.startswith("shift"):
        # the screen does its work: a few of the 4 x 13 shares checked
        assert cands.mean() <= 4.0, (name, cands.mean())


def test_ties_go_to_the_lowest_index():
    a, b = _case("duplicated")
    _, idx, _, _ = emulate(a, b)
    assert idx.max() < 200
    lat_a, lat_b = _case("lattice")
    _, idx, _, per = emulate(lat_a, lat_b)
    for p, (_, _, _, _, d2) in enumerate(per):
        first = (d2 == d2.min(1, keepdims=True)).argmax(1)
        np.testing.assert_array_equal(idx[p], first)


@pytest.mark.parametrize("ahat_max", [1.0, 50.0, 5e3])
def test_margin_grows_with_the_screen(ahat_max):
    """T(Ub(s')) <= s' + M(s) for s' <= s: the source's refresh rule, for
    queries near the centre and far from it."""
    r = _rng(int(ahat_max))
    ahat = f32(r.uniform(0, ahat_max, 200))
    an = np.sqrt(ahat * K["A_UP"])
    hi = f32(r.uniform(0, 5, 200))
    lo = f32(hi * r.uniform(0, 1, 200)) - f32(8 * 2.0 ** -17) * ahat
    m = margin_at(hi, ahat, an)
    assert np.all(threshold(upper(lo, ahat, an), an) <= f32(lo + m))
    assert np.all(m > 0)


def test_threshold_is_finite_and_non_negative():
    an = f32([0.0, 1.0, 30.0])
    for u in (0.0, 1e-30, 3e-3, 1.0, 1e4):
        t = threshold(f32(u), an)
        assert np.all(np.isfinite(t)) and np.all(t >= 0)
    assert math.isinf(float(threshold(f32(np.inf), f32(1.0))))


@pytest.mark.parametrize("shift", [0.0, 1e4])
def test_screen_reference_is_the_emulated_screen(shift):
    """The plain version of the screen agrees with the emulation up to the
    emulation's own fp32 rounding."""
    r = _rng(5)
    a = (r.randn(64, 3) + shift).astype(f32)
    b = (r.randn(80, 3) + shift).astype(f32)
    exact, scale = chamfer.screen_reference(torch.from_numpy(a),
                                            torch.from_numpy(b))
    s, _, _ = screen(a, b)
    err = np.abs(s - exact.numpy()) / scale.numpy()
    assert err.max() <= 2.0 ** -21
