"""The port's native host-IO library (pcfm_torch/native) against the JAX
package's (pcfm/native), bit for bit, and the port's ASCII PLY reader
through it."""
import numpy as np
import pytest

import pcfm.data.ply as jax_ply
from pcfm.native import get_lib as jax_get_lib
from pcfm.native import parse_ascii_rows as jax_parse
from pcfm.native import subsample_gather as jax_gather
from pcfm_torch import native
from pcfm_torch.data.ply import load_ply, save_point_cloud_ply_rgb
from pcfm_torch.native import build as nb


@pytest.fixture(scope="module")
def libs():
    if jax_get_lib() is None:
        pytest.skip("g++ unavailable: the JAX package's library is the "
                    "reference")
    assert native.available(), "the port's native library did not build"


def _rows(rng, n: int, ncols: int) -> np.ndarray:
    """Values over many magnitudes, as a PLY writer prints them."""
    return (rng.randn(n, ncols)
            * 10.0 ** rng.uniform(-4, 3, (n, ncols))).astype(np.float32)


@pytest.mark.parametrize("n,ncols", [(1, 3), (500, 6), (5000, 6),
                                     (20000, 3)])
def test_parse_ascii_rows_equals_jax(libs, n, ncols):
    rng = np.random.RandomState(n)
    body = "\n".join(" ".join(f"{v:.6f}" for v in row)
                     for row in _rows(rng, n, ncols)).encode()
    got = native.parse_ascii_rows(body, ncols, n)
    want = jax_parse(body, ncols, n)
    assert got.dtype == np.float32 and got.shape == (n, ncols)
    assert np.array_equal(got, want)
    # fewer rows than asked: the rows there are; a malformed column: 0
    assert np.array_equal(native.parse_ascii_rows(body, ncols, n + 7), want)
    bad = b"1 2 x\n4 5 6\n"
    assert np.array_equal(native.parse_ascii_rows(bad, 3, 2),
                          jax_parse(bad, 3, 2))


@pytest.mark.parametrize("n,c,k", [(1000, 3, 5000), (30000, 3, 20000),
                                   (30000, 6, 100000)])
def test_subsample_gather_equals_jax(libs, n, c, k):
    rng = np.random.RandomState(k)
    src = rng.randn(n, c).astype(np.float32)
    idx = rng.randint(0, n, size=k).astype(np.int64)
    got = native.subsample_gather(src, idx)
    assert np.array_equal(got, jax_gather(src, idx))
    assert np.array_equal(got, src[idx])


def test_subsample_gather_rejects_out_of_range(libs):
    src = np.zeros((4, 3), np.float32)
    for idx in ([0, 4], [-1]):
        with pytest.raises(IndexError):
            native.subsample_gather(src, np.asarray(idx, np.int64))


@pytest.mark.parametrize("n", [1, 3000, 30000])
def test_ascii_ply_round_trip_through_native(libs, tmp_path, monkeypatch, n):
    rng = np.random.RandomState(n)
    xyz = _rows(rng, n, 3)
    rgb = rng.rand(n, 3).astype(np.float32)
    path = str(tmp_path / "cloud.ply")
    save_point_cloud_ply_rgb(xyz, rgb, path)
    before = nb.parses
    got_xyz, got_rgb = load_ply(path)
    assert nb.parses == before + 1                  # the native path ran
    want_xyz, want_rgb = jax_ply.load_ply(path)
    assert np.array_equal(got_xyz, want_xyz)
    assert np.array_equal(got_rgb, want_rgb)
    assert np.array_equal(got_rgb,
                          (np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8))
    # the numpy path (no library) reads the same bits
    monkeypatch.setattr(nb, "get_lib", lambda: None)
    np_xyz, np_rgb = load_ply(path)
    assert nb.parses == before + 1
    assert np.array_equal(np_xyz, got_xyz) and np.array_equal(np_rgb, got_rgb)
    assert not native.available()


def test_build_lands_in_the_build_dir():
    assert nb.LIB_PATH.endswith("pcfm_torch/_build/libpcfm_io.so")
    assert nb.build() == nb.LIB_PATH
