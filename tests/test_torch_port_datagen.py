"""The port's dataset generation (pcfm_torch/datagen) against the JAX
package's (pcfm/datagen): every public function of ``datagen.core`` on the
same seeds, bit for bit; the CLI's options; the simulation backend; and the
CLI's whole output tree (posed PLYs, angles, joints, GLBs) byte for byte."""
import argparse
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import pcfm.datagen as jdg
import pcfm.datagen.core as jcore
from pcfm.datagen import cli as jcli
from pcfm.datagen import simulate as jsim
from pcfm_torch import datagen as tdg
from pcfm_torch.datagen import cli as tcli
from pcfm_torch.datagen import core as tcore
from pcfm_torch.datagen import simulate as tsim

ROOT = Path(__file__).resolve().parent.parent


def _same(a, b):
    """Equal values and types, recursively (arrays bit for bit)."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


def _pieces(mod, seed: int):
    """Mesh pieces covering every colour source: texture + UV over two
    materials, face colours, vertex colours, Kd only, and none."""
    rng = np.random.RandomState(seed)

    def mesh(nv, nf):
        return (rng.randn(nv, 3), rng.randint(0, nv, (nf, 3)))

    img = rng.randint(0, 256, (9, 7, 4)).astype(np.uint8)
    v, f = mesh(12, 20)
    textured = mod.MeshPiece(
        vertices=v, faces=f, uv=rng.rand(12, 2) * 1.5,
        materials=[mod.Material(image=img),
                   mod.Material(rgba=np.array([10, 200, 30, 255],
                                              np.uint8))],
        face_materials=rng.randint(0, 2, 20))
    v, f = mesh(8, 10)
    faces = mod.MeshPiece(vertices=v, faces=f,
                          face_colors=rng.randint(0, 256, (10, 4)).astype(
                              np.uint8))
    v, f = mesh(8, 10)
    verts = mod.MeshPiece(vertices=v, faces=f,
                          vertex_colors=rng.randint(0, 256, (8, 4)).astype(
                              np.uint8))
    v, f = mesh(6, 6)
    kd = mod.MeshPiece(vertices=v, faces=f,
                       materials=[mod.Material(rgba=np.array(
                           [1, 2, 3, 255], np.uint8)), mod.Material()],
                       face_materials=np.array([0, 1, 0, 1, 0, 1]))
    v, f = mesh(5, 4)
    gray = mod.MeshPiece(vertices=v, faces=f)
    return [textured, faces, verts, kd, gray]


def test_public_names_equal_jax():
    assert tdg.__all__ == jdg.__all__
    for name in ("GenConfig", "find_joints", "settle_multi_joints",
                 "world_mesh_pieces", "process_one_combo",
                 "process_one_model", "export_glb", "joint_type_name"):
        assert hasattr(tsim, name), name


def test_csv_rows_and_combos_equal_jax(tmp_path):
    index = tmp_path / "index.csv"
    index.write_text("\ufeffmodel_id,anno_id,urdf_relpath,model_cat\n"
                     "m1,,a/b.urdf,Box\nm2,7,c/d.urdf,Scissors\n"
                     "m3,,,\n")
    rows = tcore.read_index_csv(index)
    _same(rows, jcore.read_index_csv(index))
    for row in rows + [{}, {"id": "x"}, {"meta.anno_id": "z"}]:
        _same(tcore.row_get_category(row), jcore.row_get_category(row))
        _same(tcore.choose_anno_id(row), jcore.choose_anno_id(row))
        for cats in (None, [], ["box"], [" Scissors ", "Box"]):
            _same(tcore.include_row_by_cats(row, cats),
                  jcore.include_row_by_cats(row, cats))
    for spec in ("", "joint_0:3, joint_1:x, bad, joint_2:-1,j:2"):
        _same(tcore.parse_steps_override(spec),
              jcore.parse_steps_override(spec))
    joints = [{"name": "joint_0", "lower": -1.0, "upper": 1.0},
              {"name": "joint_1", "lower": 0.0, "upper": 0.5},
              {"name": "j", "lower": 0.2, "upper": 0.9}]
    over = tcore.parse_steps_override("joint_1:3,j:2")
    grids = tcore.build_per_joint_grids(joints, 5, over)
    _same(grids, jcore.build_per_joint_grids(joints, 5, over))
    for num, seed, unique in ((7, 0, True), (50, 3, True), (6, 1, False)):
        _same(tcore.random_combinations(grids, num, seed, unique=unique),
              jcore.random_combinations(grids, num, seed, unique=unique))
    _same(tcore.random_combinations([], 3, 0),
          jcore.random_combinations([], 3, 0))


@pytest.mark.parametrize("seed", [0, 1])
def test_sampling_and_colours_equal_jax(seed):
    tp, jp = _pieces(tcore, seed), _pieces(jcore, seed)
    for a, b in zip(tp, jp):
        _same(a.face_areas, b.face_areas)
        _same(tcore.face_rgba_from_materials(a),
              jcore.face_rgba_from_materials(b))
        _same(tcore.bake_piece_colors(a), jcore.bake_piece_colors(b))
        T = np.random.RandomState(seed).randn(4, 4)
        _same(tcore.apply_transform(a, T).vertices,
              jcore.apply_transform(b, T).vertices)
        for n in (0, 1, 37):
            _same(tcore.sample_surface(a, n, np.random.RandomState(n)),
                  jcore.sample_surface(b, n, np.random.RandomState(n)))
        for method in ("random", "fps", "even"):
            _same(tcore.sample_piece_points_with_color(
                      a, 23, method=method, oversample=3,
                      rng=np.random.RandomState(seed)),
                  jcore.sample_piece_points_with_color(
                      b, 23, method=method, oversample=3,
                      rng=np.random.RandomState(seed)))
    _same(tcore.sample_model_points_colored(
              tp, 301, method="fps", oversample=2,
              rng=np.random.RandomState(5)),
          jcore.sample_model_points_colored(
              jp, 301, method="fps", oversample=2,
              rng=np.random.RandomState(5)))
    _same(tcore.sample_model_points_colored([], 10),
          jcore.sample_model_points_colored([], 10))
    rng = np.random.RandomState(seed)
    tris, pts = rng.randn(40, 3, 3), rng.randn(40, 3)
    _same(tcore.barycentric_weights(tris, pts),
          jcore.barycentric_weights(tris, pts))
    cloud = rng.randn(200, 3)
    _same(tcore.fps_downsample(cloud, 17, np.random.RandomState(2)),
          jcore.fps_downsample(cloud, 17, np.random.RandomState(2)))
    _same(tcore.fps_downsample(cloud, 300, np.random.RandomState(2)),
          jcore.fps_downsample(cloud, 300, np.random.RandomState(2)))
    for areas, total in (([1.0, 2.0, 0.0, 3.5], 1000), ([0.1], 7),
                         (rng.rand(9), 4096)):
        _same(tcore.allocate_points(areas, total),
              jcore.allocate_points(areas, total))
    for col in (None, [0.2, 0.4], [0.1, 0.5, 1.0], [300, 20, 5, 128],
                np.array([0.5, 0.5, 0.5, 0.25])):
        _same(tcore.material_color_to_rgba255(col),
              jcore.material_color_to_rgba255(col))


def _parser_options(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.choices,
                                      a.nargs, a.const, a.required)
            for a in parser._actions if a.option_strings}


def test_cli_options_equal_jax():
    assert _parser_options(tcli.build_parser()) == \
        _parser_options(jcli.build_parser())


def test_simulate_backend_and_config_equal_jax(capsys, monkeypatch):
    """Without pybullet both packages take their built-in kinematic
    backend, with the same notice."""
    from pcfm_torch.datagen.bullet_kin import KinematicsClient
    assert tsim.GenConfig().__dict__ == jsim.GenConfig().__dict__
    try:
        import pybullet
    except ImportError:
        pybullet = None
    monkeypatch.setattr(tsim, "_KIN_NOTICE_SHOWN", False)
    monkeypatch.setattr(jsim, "_KIN_NOTICE_SHOWN", False)
    p, jp = tsim._require_pybullet(), jsim._require_pybullet()
    if pybullet is not None:
        assert p is jp is pybullet
        return
    assert isinstance(p, KinematicsClient)
    assert type(jp).__module__ == "pcfm.datagen.bullet_kin"
    err = capsys.readouterr().err.splitlines()
    assert err[0] == err[1].replace("pcfm.datagen", "pcfm_torch.datagen")


def _assets(tmp_path) -> Path:
    spec = importlib.util.spec_from_file_location(
        "make_articulated_assets",
        ROOT / "scripts" / "make_articulated_assets.py")
    maa = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maa)
    assets = tmp_path / "assets"
    assert maa.main(["--out", str(assets), "--per-cat", "1",
                     "--seed", "3"]) == 0
    return assets


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("extra", [
    ["--ply-ascii", "--point-sampling", "random"],
    ["--no-glb", "--point-sampling", "fps", "--fps-oversample", "2",
     "--group-by-cat", "--steps-per", "joint_0:2", "--workers", "2"]])
def test_cli_writes_jax_tree(tmp_path, extra):
    assets = _assets(tmp_path)
    argv = ["--index", str(assets / "index.csv"), "--dataset-dir",
            str(assets), "--joint-types", "revolute,prismatic", "--steps",
            "3", "--num-combos", "3", "--points", "200", "--seed", "1",
            *extra]
    assert tcli.main(argv + ["--out-dir", str(tmp_path / "port")]) == 0
    assert jcli.main(argv + ["--out-dir", str(tmp_path / "jax")]) == 0
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port.keys() == jax.keys()
    assert sum(k.endswith("pointcloud.ply") for k in port) >= 8
    assert any(k.endswith("mesh.glb") for k in port) == \
        ("--no-glb" not in extra)
    for name in port:
        assert port[name] == jax[name], name


def test_cli_without_rows_fails_as_jax(tmp_path, capsys):
    index = tmp_path / "index.csv"
    index.write_text("model_id,model_cat\nm1,Box\n")
    argv = ["--index", str(index), "--dataset-dir", str(tmp_path),
            "--filter-cats", "Chair", "--out-dir", str(tmp_path / "o")]
    assert tcli.main(argv) == jcli.main(argv) == 1
