"""Dependency-light mesh loading for offline data generation.

The reference loads visual meshes with ``trimesh.load`` (make_dataset.py:
515-532). trimesh isn't available in every environment, so
``load_mesh_pieces`` tries trimesh first and falls back to this module's
own loaders:

  * Wavefront OBJ (the PartNet-Mobility visual format): v/vt/f with
    polygon fan-triangulation, usemtl/mtllib material groups, MTL ``Kd``
    colors and ``map_Kd`` textures (decoded via PIL when present).
    Vertices are rebuilt per unique (v, vt) pair so the per-vertex ``uv``
    of MeshPiece matches the reference's texture-UV sampling path
    (make_dataset.py:256-346 priority: texture-UV -> face/vertex colors
    -> MTL Kd -> gray).
  * ASCII/binary PLY triangle meshes with optional per-vertex colors
    (via the existing pcfm PLY reader).

Returns ``List[MeshPiece]`` directly — no intermediate scene graph.

The port's copy of ``pcfm/datagen/meshio.py``: it imports nothing of ``pcfm``.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from pcfm_torch.datagen.core import (Material, MeshPiece,
                               material_color_to_rgba255)


def _load_image(path: Path) -> Optional[np.ndarray]:
    try:
        from PIL import Image
        return np.asarray(Image.open(str(path)).convert("RGBA"))
    except Exception:
        return None


def parse_mtl(path: Path) -> Dict[str, Material]:
    """MTL -> {name: Material} (Kd color + map_Kd texture)."""
    mats: Dict[str, Material] = {}
    if not path.exists():
        return mats
    cur: Optional[str] = None
    kd: Dict[str, list] = {}
    tex: Dict[str, Path] = {}
    for raw in path.read_text(errors="ignore").splitlines():
        parts = raw.strip().split()
        if not parts:
            continue
        if parts[0] == "newmtl" and len(parts) > 1:
            cur = parts[1]
        elif parts[0] == "Kd" and cur and len(parts) >= 4:
            kd[cur] = [float(x) for x in parts[1:4]]
        elif parts[0] == "map_Kd" and cur and len(parts) > 1:
            tex[cur] = path.parent / " ".join(parts[1:])
    for name in set(kd) | set(tex):
        img = _load_image(tex[name]) if name in tex else None
        mats[name] = Material(
            image=img, rgba=material_color_to_rgba255(kd.get(name)))
    return mats


def load_obj(path: Path) -> List[MeshPiece]:
    """OBJ -> one MeshPiece (materials list + per-face material index)."""
    vs: List[Tuple[float, float, float]] = []
    vts: List[Tuple[float, float]] = []
    faces: List[Tuple[int, int, int]] = []       # indices into rebuilt verts
    face_mat: List[int] = []
    mats: Dict[str, Material] = {}
    mat_order: List[str] = []
    cur_mat = -1
    # rebuild vertices per unique (v_idx, vt_idx) so uv is per-vertex
    remap: Dict[Tuple[int, int], int] = {}
    out_v: List[Tuple[float, float, float]] = []
    out_uv: List[Tuple[float, float]] = []

    def corner(tok: str) -> int:
        sp = tok.split("/")
        vi = int(sp[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = 0
        if len(sp) > 1 and sp[1]:
            t = int(sp[1])
            ti = t if t > 0 else len(vts) + t + 1
        key = (vi, ti)
        if key not in remap:
            remap[key] = len(out_v)
            out_v.append(vs[vi])
            out_uv.append(vts[ti - 1] if ti > 0 and ti <= len(vts)
                          else (0.0, 0.0))
        return remap[key]

    for raw in path.read_text(errors="ignore").splitlines():
        parts = raw.strip().split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "v" and len(parts) >= 4:
            vs.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "vt" and len(parts) >= 3:
            vts.append((float(parts[1]), float(parts[2])))
        elif tag == "mtllib" and len(parts) > 1:
            mats.update(parse_mtl(path.parent / " ".join(parts[1:])))
        elif tag == "usemtl" and len(parts) > 1:
            name = parts[1]
            if name not in mat_order:
                mat_order.append(name)
            cur_mat = mat_order.index(name)
        elif tag == "f" and len(parts) >= 4:
            idx = [corner(t) for t in parts[1:]]
            for k in range(1, len(idx) - 1):       # fan triangulation
                faces.append((idx[0], idx[k], idx[k + 1]))
                face_mat.append(cur_mat)

    if not faces:
        return []
    piece = MeshPiece(vertices=np.asarray(out_v, np.float64),
                      faces=np.asarray(faces, np.int64))
    if vts:
        piece.uv = np.asarray(out_uv, np.float64)
    if mat_order:
        piece.materials = [mats.get(n, Material()) for n in mat_order]
        fm = np.asarray(face_mat, np.int64)
        piece.face_materials = np.where(fm < 0, 0, fm)
    return [piece]


def load_mesh_pieces(path: Path) -> List[MeshPiece]:
    """trimesh when available, else the built-in OBJ loader (the
    PartNet-Mobility visual format; PLY meshes with face lists are not
    used by the reference's URDFs)."""
    try:
        import trimesh
        from pcfm_torch.datagen.simulate import _trimesh_to_piece
        loaded = trimesh.load(str(path), force="mesh", process=False)
        meshes = loaded.dump() if hasattr(loaded, "dump") else [loaded]
        return [p for m in meshes if (p := _trimesh_to_piece(m)) is not None]
    except ImportError:
        pass
    except Exception:
        return []
    if path.suffix.lower() == ".obj":
        return load_obj(path)
    return []
