"""Offline dataset generation — pybullet simulation shell.

The pybullet/trimesh-dependent half of the reference
`dataset/make_dataset.py`: URDF loading, joint discovery (type + name-regex
filter with limit fixups and one-shot regex relaxation), position-control
settling, world-space visual mesh assembly, and the per-model /
per-combo driver with ProcessPoolExecutor fan-out.

pybullet and trimesh are imported lazily; every public entry raises a clear
error when they are unavailable (they are NOT required by the training /
eval stack — only by offline data generation).

The port's copy of ``pcfm/datagen/simulate.py``: it imports nothing of ``pcfm``.
"""
from __future__ import annotations

import json
import math
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from pcfm_torch.data.ply import save_point_cloud_ply_rgb
from pcfm_torch.datagen.core import (Material, MeshPiece, bake_piece_colors,
                               build_per_joint_grids, choose_anno_id,
                               material_color_to_rgba255,
                               parse_steps_override, random_combinations,
                               row_get_category, sample_model_points_colored)


@dataclass
class GenConfig:
    points_per_pose: int = 4096
    vel_epsilon: float = 1e-3
    pos_tolerance: float = 1e-4
    stable_hold_steps: int = 30
    max_settle_steps: int = 2400
    physics_timestep: float = 1.0 / 240.0
    motor_force: float = 50.0
    ply_ascii: bool = True
    glb_export: bool = True
    point_sampling: str = "random"   # random | fps | even
    fps_oversample: int = 8


_KIN_NOTICE_SHOWN = False


def _require_pybullet():
    """Real pybullet when installed; otherwise the built-in pure-numpy
    kinematic backend (pcfm_torch/datagen/bullet_kin.py). The generation
    workload runs with gravity off under position control
    (make_dataset.py:588-603 connects DIRECT, setGravity(0,0,0)), so
    kinematics + a settling servo reproduce its semantics exactly."""
    try:
        import pybullet as p  # noqa: F401
        return p
    except ImportError:
        global _KIN_NOTICE_SHOWN
        if not _KIN_NOTICE_SHOWN:
            print("[datagen] pybullet not installed — using the built-in "
                  "kinematic backend (pcfm_torch.datagen.bullet_kin)",
                  file=sys.stderr)
            _KIN_NOTICE_SHOWN = True
        from pcfm_torch.datagen.bullet_kin import client
        return client()


def joint_type_name(p, jtype: int) -> str:
    return {p.JOINT_REVOLUTE: "revolute", p.JOINT_PRISMATIC: "prismatic",
            p.JOINT_PLANAR: "planar",
            p.JOINT_FIXED: "fixed"}.get(jtype, f"type_{jtype}")


def find_joints(p, body_id: int, allow_types: List[str],
                name_regex: Optional[str]) -> List[Dict]:
    """Joint discovery with limit fixups + one-shot regex relaxation
    (make_dataset.py:423-451)."""
    allow = {t.strip().lower() for t in allow_types}
    pattern = re.compile(name_regex) if name_regex else None

    def scan(use_pattern: bool):
        out = []
        for j in range(p.getNumJoints(body_id)):
            info = p.getJointInfo(body_id, j)
            jtype = info[2]
            name = info[1].decode("utf-8", "ignore")
            tname = joint_type_name(p, jtype).lower()
            if tname not in allow:
                continue
            if use_pattern and pattern and not pattern.fullmatch(name):
                continue
            lower, upper = float(info[8]), float(info[9])
            if not (math.isfinite(lower) and math.isfinite(upper)) \
                    or lower >= upper:
                if jtype == p.JOINT_REVOLUTE:
                    lower, upper = -math.pi, math.pi
                elif jtype == p.JOINT_PRISMATIC:
                    lower, upper = -0.5, 0.5
                else:
                    continue
            out.append({"index": j, "name": name, "type": tname,
                        "lower": lower, "upper": upper})
        return out

    out = scan(use_pattern=True)
    if pattern and not out:
        out = scan(use_pattern=False)
    return out


def settle_multi_joints(p, body_id: int, joint_indices: List[int],
                        targets: List[float], cfg: GenConfig):
    """Position-control to targets until pos/vel stable
    (make_dataset.py:480-497)."""
    for j in range(p.getNumJoints(body_id)):
        p.setJointMotorControl2(body_id, j, controlMode=p.VELOCITY_CONTROL,
                                force=0.0)
    for j, tgt in zip(joint_indices, targets):
        p.setJointMotorControl2(body_id, j, controlMode=p.POSITION_CONTROL,
                                targetPosition=float(tgt),
                                force=cfg.motor_force)
    stable = 0
    for _ in range(cfg.max_settle_steps):
        p.stepSimulation()
        ok = True
        for j, tgt in zip(joint_indices, targets):
            pos, vel, *_ = p.getJointState(body_id, j)
            if abs(pos - tgt) > cfg.pos_tolerance \
                    or abs(vel) > cfg.vel_epsilon:
                ok = False
                break
        if ok:
            stable += 1
            if stable >= cfg.stable_hold_steps:
                break
        else:
            stable = 0


def _pose_to_matrix(p, pos, orn) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = np.array(p.getMatrixFromQuaternion(orn),
                         np.float64).reshape(3, 3)
    T[:3, 3] = np.asarray(pos, np.float64)
    return T


def _trimesh_to_piece(mesh) -> Optional[MeshPiece]:
    """Convert a trimesh.Trimesh into our MeshPiece, extracting the color
    sources in the reference's priority order."""
    v = np.asarray(mesh.vertices, np.float64)
    f = np.asarray(mesh.faces, np.int64)
    if len(f) == 0:
        return None
    piece = MeshPiece(vertices=v, faces=f)
    vis = getattr(mesh, "visual", None)
    if vis is None:
        return piece
    if getattr(vis, "kind", "") == "texture":
        uv = getattr(vis, "uv", None)
        if uv is not None:
            piece.uv = np.asarray(uv, np.float64)
        # material LIST + per-face material index (mixed materials,
        # make_dataset.py:318-346)
        mats = getattr(vis, "material", None)
        mat_list = (list(mats) if isinstance(mats, (list, tuple, np.ndarray))
                    else ([mats] if mats is not None else []))
        materials: List[Material] = []
        for mtl in mat_list:
            img = None
            try:
                pil = getattr(mtl, "image", None)
                if pil is not None:
                    img = np.asarray(pil.convert("RGBA"))
            except Exception:
                img = None
            kd = None
            for attr in ("main_color", "diffuse", "Kd", "ambient", "Ka"):
                kd = getattr(mtl, attr, None) if mtl is not None else None
                if kd is not None:
                    break
            materials.append(Material(image=img,
                                      rgba=material_color_to_rgba255(kd)))
        if materials:
            piece.materials = materials
            fm = getattr(vis, "face_materials", None)
            if fm is not None and len(fm) == len(f):
                piece.face_materials = np.asarray(fm, np.int64)
    else:
        fc = getattr(vis, "face_colors", None)
        if fc is not None and len(fc) == len(f):
            piece.face_colors = np.asarray(fc, np.uint8)
        vc = getattr(vis, "vertex_colors", None)
        if vc is not None and len(vc) == len(v):
            piece.vertex_colors = np.asarray(vc, np.uint8)
    return piece


def export_glb(pieces: List[MeshPiece], path: Path) -> bool:
    """Write the assembled world mesh as ``mesh.glb``
    (make_dataset.py:534-564).  Appearance is baked to per-face colors
    (the reference's glb_bake branch) because MeshPiece stores decoded
    arrays, not live trimesh materials.  Without trimesh the built-in
    writer (pcfm_torch/datagen/glb.py) produces the GLB directly."""
    try:
        import trimesh
    except ImportError:
        from pcfm_torch.datagen.glb import write_glb
        return write_glb(pieces, path)
    meshes = []
    for piece in pieces:
        if piece.is_empty:
            continue
        m = trimesh.Trimesh(vertices=piece.vertices, faces=piece.faces,
                            process=False)
        fc = bake_piece_colors(piece)
        if fc is not None:
            m.visual = trimesh.visual.ColorVisuals(mesh=m, face_colors=fc)
        meshes.append(m)
    if not meshes:
        return False
    trimesh.Scene(meshes).export(str(path))
    return True


def world_mesh_pieces(p, body_id: int, urdf_dir: Path) -> List[MeshPiece]:
    """Visual shapes -> world-transformed MeshPieces
    (make_dataset.py:515-532)."""
    from pcfm_torch.datagen.meshio import load_mesh_pieces
    pieces: List[MeshPiece] = []
    link_T = {}
    bpos, born = p.getBasePositionAndOrientation(body_id)
    link_T[-1] = _pose_to_matrix(p, bpos, born)
    for li in range(p.getNumJoints(body_id)):
        st = p.getLinkState(body_id, li, computeForwardKinematics=1)
        pos, orn = (st[4], st[5]) if len(st) >= 6 and st[4] is not None \
            else (st[0], st[1])
        link_T[li] = _pose_to_matrix(p, pos, orn)
    for shape in (p.getVisualShapeData(body_id) or []):
        link_idx = shape[1]
        mesh_file = shape[4].decode("utf-8", "ignore") \
            if isinstance(shape[4], bytes) else str(shape[4])
        local_T = _pose_to_matrix(p, shape[5], shape[6])
        if not mesh_file:
            continue
        path = Path(mesh_file)
        if not path.is_absolute():
            path = urdf_dir / mesh_file
        if not path.exists():
            continue
        scale = np.asarray(shape[3], np.float64)
        for piece in load_mesh_pieces(path):
            T = link_T.get(link_idx, np.eye(4)) @ local_T
            vtx = piece.vertices * scale
            piece.vertices = vtx @ T[:3, :3].T + T[:3, 3]
            pieces.append(piece)
    return pieces


def process_one_combo(p, body_id: int, urdf_dir: Path,
                      joint_indices: List[int], joint_targets: List[float],
                      pose_dir: Path, cfg: GenConfig,
                      rng: np.random.RandomState) -> bool:
    settle_multi_joints(p, body_id, joint_indices, joint_targets, cfg)
    if p.getNumJoints(body_id) > 0:
        p.getLinkState(body_id, 0, computeForwardKinematics=1)
    pieces = world_mesh_pieces(p, body_id, urdf_dir)
    if not pieces:
        return False
    pose_dir.mkdir(parents=True, exist_ok=True)

    if cfg.glb_export:
        try:
            export_glb(pieces, pose_dir / "mesh.glb")
        except Exception as e:
            print(f"[WARN] mesh.glb export failed: {e}", file=sys.stderr)

    pts, rgb = sample_model_points_colored(
        pieces, cfg.points_per_pose, method=cfg.point_sampling,
        oversample=cfg.fps_oversample, rng=rng)
    if pts.shape[0] == 0:
        return False
    save_point_cloud_ply_rgb(pts.astype(np.float32), rgb,
                             str(pose_dir / "pointcloud.ply"))
    with (pose_dir / "angles.json").open("w", encoding="utf-8") as f:
        json.dump({"angles": [float(x) for x in joint_targets]}, f,
                  ensure_ascii=False, indent=2)
    return True


def process_one_model(row: Dict[str, str], args, cfg: GenConfig,
                      out_root: Path) -> Tuple[str, int, int]:
    p = _require_pybullet()
    urdf_rel = row.get("urdf_relpath") or ""
    if not urdf_rel:
        return row.get("model_id", "?"), 0, 0
    urdf_path = (Path(args.dataset_dir) / urdf_rel).resolve()
    if not urdf_path.exists():
        print(f"[WARN] URDF missing: {urdf_path}", file=sys.stderr)
        return row.get("model_id", "?"), 0, 1

    anno_id = choose_anno_id(row)
    category = row_get_category(row)
    if args.group_by_cat and category:
        out_dir = out_root / category / anno_id
    else:
        out_dir = out_root / anno_id
    out_dir.mkdir(parents=True, exist_ok=True)

    if p.isConnected():
        p.resetSimulation()
    else:
        p.connect(p.DIRECT)
    p.setTimeStep(cfg.physics_timestep)
    p.setGravity(0, 0, 0)
    p.setAdditionalSearchPath(str(args.dataset_dir))
    urdf_dir = urdf_path.parent
    p.setAdditionalSearchPath(str(urdf_dir))

    try:
        body_id = p.loadURDF(str(urdf_path), useFixedBase=True,
                             flags=p.URDF_USE_INERTIA_FROM_FILE)
    except Exception as e:
        print(f"[WARN] loadURDF failed: {urdf_path}: {e}", file=sys.stderr)
        return anno_id, 0, 1

    joints = find_joints(p, body_id,
                         [t.strip() for t in args.joint_types.split(",")],
                         args.joint_regex)
    with (out_dir / "joint.json").open("w", encoding="utf-8") as f:
        json.dump({"anno_id": anno_id, "category": category,
                   "joints": joints}, f, ensure_ascii=False, indent=2)

    rng = np.random.RandomState(args.seed)
    ok = fail = 0
    if args.init_only or not joints:
        combos = [[]]
        joint_idx: List[int] = []
    else:
        grids = build_per_joint_grids(
            joints, args.steps, parse_steps_override(args.steps_per))
        combos = random_combinations(grids, args.num_combos, args.seed,
                                     unique=not args.allow_duplicate_combos)
        joint_idx = [j["index"] for j in joints]

    for ci, targets in enumerate(combos):
        pose_dir = out_dir / f"pose_{ci:03d}"
        try:
            if process_one_combo(p, body_id, urdf_dir, joint_idx,
                                 list(targets), pose_dir, cfg, rng):
                ok += 1
            else:
                fail += 1
        except Exception as e:
            print(f"[WARN] combo {ci} failed: {e}", file=sys.stderr)
            fail += 1
    return anno_id, ok, fail
