"""The port's PLY -> H5 packer (pcfm_torch/data/pack_h5.py) against the
JAX package's on one PLY tree: equal shards and val split, and the port's
PartNetH5Dataset over them gives JAX's items."""
import json

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from pcfm.data.h5_dataset import PartNetH5Dataset as JaxPartNet  # noqa: E402
from pcfm.data.pack_h5 import pack_ply_to_h5 as jax_pack  # noqa: E402
from pcfm_torch.data import pack_ply_to_h5  # noqa: E402
from pcfm_torch.data.h5_dataset import PartNetH5Dataset  # noqa: E402
from pcfm_torch.data.pack_h5 import main as pack_main  # noqa: E402
from pcfm_torch.data.ply import (save_point_cloud_ply,  # noqa: E402
                                 save_point_cloud_ply_rgb)
from pcfm_torch.data.synthetic import hinge_shape  # noqa: E402


def _write_tree(root, models: int, poses: int, rgb: bool = True,
                ragged: bool = False):
    """make_dataset.py's layout: {model}/pose_XXX/{pointcloud.ply,
    angles.json}, joint counts varying by model."""
    rng = np.random.RandomState(0)
    for m in range(models):
        for p in range(poses):
            d = root / f"model_{m}" / f"pose_{p:03d}"
            d.mkdir(parents=True)
            n = 96 + (7 * (m + p) if ragged else 0)
            angles = [0.3 + 0.2 * p] * (1 + m % 3)
            xyz, col = hinge_shape(rng, n, angles[0])
            if rgb:
                save_point_cloud_ply_rgb(xyz, col, str(d / "pointcloud.ply"))
            else:
                save_point_cloud_ply(xyz, str(d / "pointcloud.ply"))
            if (m, p) != (0, 1):           # one pose without angles.json
                (d / "angles.json").write_text(json.dumps(
                    {"angles": angles}))


def _shards(root):
    out = {}
    for path in sorted(root.rglob("shard-*.h5")):
        with h5py.File(path, "r") as f:
            out[str(path.relative_to(root))] = {k: f[k][()] for k in f}
    return out


@pytest.mark.parametrize("rgb,ragged,n_points,val", [
    (True, False, None, 0.0), (True, True, 64, 0.25), (False, True, 128,
                                                        0.15)])
def test_shards_equal_jax(tmp_path, rgb, ragged, n_points, val):
    _write_tree(tmp_path / "raw", models=5, poses=4, rgb=rgb, ragged=ragged)
    kw = dict(split="train", n_points=n_points, shard_size=6,
              val_fraction=val, seed=3, verbose=False)
    got = pack_ply_to_h5(str(tmp_path / "raw"), str(tmp_path / "port"), **kw)
    want = jax_pack(str(tmp_path / "raw"), str(tmp_path / "jax"), **kw)
    assert [p.replace("/port/", "/") for p in got] == \
        [p.replace("/jax/", "/") for p in want]
    a, b = _shards(tmp_path / "port"), _shards(tmp_path / "jax")
    assert a.keys() == b.keys() and a
    assert any(k.startswith("test/") for k in a) == (val > 0)
    for name in a:
        assert a[name].keys() == b[name].keys(), name
        assert ("rgb" in a[name]) == rgb
        for key in a[name]:
            x, y = a[name][key], b[name][key]
            assert x.dtype == y.dtype and x.shape == y.shape, (name, key)
            if key == "anno_id":
                assert x.tolist() == y.tolist()
            else:
                assert np.array_equal(x, y, equal_nan=True), (name, key)


def test_datasets_over_the_shards_equal_jax(tmp_path):
    _write_tree(tmp_path / "raw", models=4, poses=3)
    pack_main(["--in_dir", str(tmp_path / "raw"), "--out_dir",
               str(tmp_path / "h5"), "--n_points", "80", "--shard_size", "5",
               "--val_fraction", "0.25", "--seed", "1"])
    for split in ("train", "test"):
        kw = dict(split=split, tr_sample_size=48, te_sample_size=40,
                  cond_dim_override=None, expand_stats=True)
        port = PartNetH5Dataset(str(tmp_path / "h5"), **kw)
        jax = JaxPartNet(str(tmp_path / "h5"), **kw)
        assert len(port) == len(jax) > 0
        assert port.cond_dim == jax.cond_dim
        for i in range(len(port)):
            a = port.get(i, np.random.RandomState(i))
            b = jax.get(i, np.random.RandomState(i))
            assert a.keys() == b.keys() and "anno_id" in a
            for k in a:
                assert np.array_equal(a[k], b[k]), (split, i, k)


def test_pack_refuses_an_empty_tree(tmp_path):
    with pytest.raises(FileNotFoundError, match="pose_"):
        pack_ply_to_h5(str(tmp_path), str(tmp_path / "h5"), verbose=False)
