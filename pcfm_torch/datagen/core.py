"""Offline dataset generation — pure-numpy core.

Re-design of the reference `dataset/make_dataset.py` (851 LoC): everything
that does NOT need pybullet/trimesh lives here and is unit-testable —
CSV index handling, pose grids and random joint combinations, triangle
surface sampling, barycentric interpolation, FPS downsampling, the
color-priority resolution (texture-UV -> face colors -> vertex colors ->
material Kd -> gray fallback), and area-weighted point allocation across
mesh pieces.  The pybullet simulation shell is in ``simulate.py``.

Meshes are represented by a plain ``MeshPiece`` (vertices/faces + optional
uv/texture/face/vertex colors) instead of trimesh objects, so the whole
sampling path runs on any mesh source.

The port's copy of ``pcfm/datagen/core.py``: it imports nothing of ``pcfm``.
"""
from __future__ import annotations

import csv
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

GRAY = np.array([180, 180, 180], dtype=np.uint8)


# ---------------- CSV index ----------------

def read_index_csv(index_csv) -> List[Dict[str, str]]:
    rows = []
    with open(index_csv, "r", encoding="utf-8-sig", newline="") as f:
        for r in csv.DictReader(f):
            rows.append(r)
    return rows


def row_get_category(row: Dict[str, str]) -> str:
    for key in ("model_cat", "model.category", "category", "meta.model_cat"):
        v = row.get(key) or ""
        if v:
            return str(v).strip()
    return ""


def include_row_by_cats(row: Dict[str, str],
                        cats: Optional[List[str]]) -> bool:
    if not cats:
        return True
    return row_get_category(row).lower() in {c.strip().lower() for c in cats}


def choose_anno_id(row: Dict[str, str]) -> str:
    cand = [row.get("anno_id") or row.get("meta.anno_id"),
            row.get("model_id")]
    md = row.get("model_dir")
    if md:
        cand.append(Path(md).name)
    ur = row.get("urdf_relpath")
    if ur:
        cand.append(Path(ur).parts[0] if Path(ur).parts else None)
    cand.append(row.get("id"))
    for c in cand:
        if c and str(c).strip():
            return str(c).strip()
    return "unknown"


# ---------------- pose grids & combos ----------------

def build_per_joint_grids(joints: List[Dict], steps: int,
                          steps_override: Dict[str, int]) -> List[np.ndarray]:
    return [np.linspace(float(j["lower"]), float(j["upper"]),
                        int(steps_override.get(j["name"], steps)),
                        dtype=float)
            for j in joints]


def random_combinations(grids: List[np.ndarray], num: int, seed: int,
                        unique: bool = True,
                        max_tries_factor: int = 20) -> List[List[float]]:
    """Unique random picks from the cartesian grid (seeded)."""
    rng = random.Random(seed)
    if not grids:
        return []
    total = 1
    for g in grids:
        total *= len(g)
    if not unique:
        return [[rng.choice(list(g)) for g in grids] for _ in range(num)]
    target = min(num, total)
    seen = set()
    picks: List[List[float]] = []
    tries = 0
    while len(picks) < target and tries < max_tries_factor * target:
        key = tuple(rng.randrange(len(g)) for g in grids)
        if key not in seen:
            seen.add(key)
            picks.append([grids[i][k] for i, k in enumerate(key)])
        tries += 1
    return picks


def parse_steps_override(mapping: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    if not mapping:
        return out
    for part in [s.strip() for s in mapping.split(",") if s.strip()]:
        if ":" not in part:
            continue
        name, val = part.split(":", 1)
        try:
            v = int(val.strip())
            if v > 0:
                out[name.strip()] = v
        except ValueError:
            pass
    return out


# ---------------- mesh representation ----------------

@dataclass
class Material:
    """One material: an optional texture image and/or a Kd color
    (make_dataset.py:206-221 ``_material_color_to_rgba255``)."""
    image: Optional[np.ndarray] = None        # (H, W, >=3) uint8
    rgba: Optional[np.ndarray] = None         # (4,) uint8 (Kd)


def material_color_to_rgba255(col) -> Optional[np.ndarray]:
    """Kd/main_color-like value -> uint8 RGBA (make_dataset.py:206-221)."""
    if col is None:
        return None
    col = np.array(col, dtype=np.float32).reshape(-1)
    if col.size < 3:
        return None
    if col.max() <= 1.0 + 1e-6:
        col = col * 255.0
    col = np.clip(col, 0, 255)
    if col.size == 3:
        col = np.append(col, 255.0)
    return col[:4].astype(np.uint8)


@dataclass
class MeshPiece:
    vertices: np.ndarray                      # (V, 3) float
    faces: np.ndarray                         # (F, 3) int
    uv: Optional[np.ndarray] = None           # (V, 2) float
    texture: Optional[np.ndarray] = None      # (H, W, >=3) uint8
    face_colors: Optional[np.ndarray] = None  # (F, >=3) uint8
    vertex_colors: Optional[np.ndarray] = None  # (V, >=3) uint8
    material_rgba: Optional[np.ndarray] = None  # (4,) uint8 (Kd)
    # multi-material support (make_dataset.py:318-380): a material list and
    # a per-face material index; when set these take priority over the
    # single texture/material_rgba fields (which remain as the
    # single-material shorthand)
    materials: Optional[List[Material]] = None
    face_materials: Optional[np.ndarray] = None  # (F,) int

    @property
    def triangles(self) -> np.ndarray:
        return self.vertices[self.faces]

    @property
    def face_areas(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=-1)

    @property
    def area(self) -> float:
        return float(self.face_areas.sum())

    @property
    def is_empty(self) -> bool:
        return len(self.faces) == 0


def _piece_materials(piece: MeshPiece):
    """Normalize the material representation: returns (materials,
    face_materials) where materials is a non-empty list and face_materials a
    (F,) int index, or (None, None) when the piece has no material info.
    The single-material shorthand (texture / material_rgba) becomes a
    one-element list with all faces on index 0 (the reference's default
    ``face_mats = zeros`` — make_dataset.py:324-327)."""
    if piece.materials:
        fm = piece.face_materials
        if fm is None or len(fm) != len(piece.faces):
            fm = np.zeros(len(piece.faces), np.int64)
        else:
            fm = np.asarray(fm, np.int64)
        return list(piece.materials), fm
    if piece.texture is not None or piece.material_rgba is not None:
        mat = Material(image=piece.texture, rgba=piece.material_rgba)
        return [mat], np.zeros(len(piece.faces), np.int64)
    return None, None


def face_rgba_from_materials(piece: MeshPiece) -> Optional[np.ndarray]:
    """Per-face RGBA from MTL Kd via materials + face_materials, for meshes
    using multiple materials without textures (make_dataset.py:223-254)."""
    mats, face_mats = _piece_materials(piece)
    if mats is None:
        return None
    cache = [m.rgba for m in mats]
    if all(c is None for c in cache):
        return None
    fc = np.tile(np.array([180, 180, 180, 255], np.uint8),
                 (len(piece.faces), 1))
    for midx, rgba in enumerate(cache):
        if rgba is None:
            continue
        mask = face_mats == midx
        if np.any(mask):
            fc[mask] = np.asarray(rgba, np.uint8)[:4]
    return fc


def apply_transform(piece: MeshPiece, T: np.ndarray) -> MeshPiece:
    v = piece.vertices @ T[:3, :3].T + T[:3, 3]
    out = MeshPiece(**{**piece.__dict__})
    out.vertices = v.astype(np.float64)
    return out


# ---------------- surface sampling ----------------

def barycentric_weights(triangles: np.ndarray,
                        points: np.ndarray) -> np.ndarray:
    """Per-point barycentric coords wrt their triangle (make_dataset.py:257)."""
    v0 = triangles[:, 1] - triangles[:, 0]
    v1 = triangles[:, 2] - triangles[:, 0]
    v2 = points - triangles[:, 0]
    d00 = np.einsum("ij,ij->i", v0, v0)
    d01 = np.einsum("ij,ij->i", v0, v1)
    d11 = np.einsum("ij,ij->i", v1, v1)
    d20 = np.einsum("ij,ij->i", v2, v0)
    d21 = np.einsum("ij,ij->i", v2, v1)
    denom = d00 * d11 - d01 * d01 + 1e-18
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return np.column_stack([1.0 - v - w, v, w])


def sample_surface(piece: MeshPiece, n: int,
                   rng: np.random.RandomState) -> Tuple[np.ndarray, np.ndarray]:
    """Area-uniform surface sampling -> (points (n,3), face indices (n,))."""
    areas = piece.face_areas
    total = areas.sum()
    if total <= 0 or n <= 0:
        return np.zeros((0, 3)), np.zeros((0,), np.int64)
    probs = areas / total
    fidx = rng.choice(len(areas), size=n, p=probs)
    tris = piece.triangles[fidx]
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    pts = ((1 - r1) * tris[:, 0] + r1 * (1 - r2) * tris[:, 1]
           + r1 * r2 * tris[:, 2])
    return pts, fidx


def fps_downsample(points: np.ndarray, k: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """Numpy FPS (make_dataset.py:272-283): random start, greedy argmax."""
    n = len(points)
    if k >= n:
        return np.arange(n, dtype=np.int64)
    idx = np.empty(k, dtype=np.int64)
    far = int(rng.randint(0, n))
    d2 = np.full(n, np.inf)
    for i in range(k):
        idx[i] = far
        d2 = np.minimum(d2, np.sum((points - points[far]) ** 2, axis=1))
        far = int(np.argmax(d2))
    return idx


def sample_piece_points_with_color(piece: MeshPiece, n: int,
                                   method: str = "random",
                                   oversample: int = 8,
                                   rng: Optional[np.random.RandomState] = None
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample n points + colors from one piece.

    Color priority (make_dataset.py:292-393):
      A) UV present: each point's FACE MATERIAL — texture lookup when that
         material has an image, else its Kd (mixed materials supported)
      B) face_colors, then vertex_colors (barycentric blend)
      C) per-face Kd via materials + face_materials (no-UV meshes)
      D) gray (180,180,180)
    """
    rng = rng or np.random.RandomState(0)
    if n <= 0 or piece.is_empty:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)

    if method.lower() == "random":
        pts, fidx = sample_surface(piece, n, rng)
    else:  # fps / even: oversample then FPS
        m = max(1, int(n * max(2, oversample)))
        dense, fdense = sample_surface(piece, m, rng)
        sel = fps_downsample(dense, n, rng)
        pts, fidx = dense[sel], fdense[sel]

    rgb = np.tile(GRAY, (pts.shape[0], 1))
    mats, face_mats = _piece_materials(piece)

    # A) texture/Kd per face material (make_dataset.py:318-360)
    if piece.uv is not None and mats is not None:
        faces = piece.faces[fidx]
        tris = piece.vertices[faces]
        wts = barycentric_weights(tris, pts)
        uv_face = piece.uv[faces]                       # (n, 3, 2)
        uv_pts = (uv_face * wts[..., None]).sum(axis=1)
        u = np.mod(uv_pts[:, 0], 1.0)
        v = np.mod(uv_pts[:, 1], 1.0)
        fm_pts = face_mats[fidx]
        for midx in np.unique(fm_pts):
            mask = fm_pts == midx
            mat = mats[midx] if midx < len(mats) else None
            if mat is not None and mat.image is not None:
                img = mat.image
                h, w = img.shape[:2]
                x = (u[mask] * (w - 1)).astype(np.int32)
                y = ((1.0 - v[mask]) * (h - 1)).astype(np.int32)
                rgb[mask] = img[y, x, :3].astype(np.uint8)
            elif mat is not None and mat.rgba is not None:
                rgb[mask] = np.asarray(mat.rgba, np.uint8)[:3]

    unresolved = np.all(rgb == GRAY, axis=1)

    # B) face colors
    if unresolved.any() and piece.face_colors is not None \
            and len(piece.face_colors) == len(piece.faces):
        rgb[unresolved] = piece.face_colors[fidx[unresolved], :3]
        unresolved = np.all(rgb == GRAY, axis=1)

    # B2) vertex colors (barycentric)
    if unresolved.any() and piece.vertex_colors is not None \
            and len(piece.vertex_colors) == len(piece.vertices):
        faces = piece.faces[fidx[unresolved]]
        tris = piece.vertices[faces]
        wts = barycentric_weights(tris, pts[unresolved])
        c = piece.vertex_colors
        blend = (wts[:, [0]] * c[faces[:, 0], :3]
                 + wts[:, [1]] * c[faces[:, 1], :3]
                 + wts[:, [2]] * c[faces[:, 2], :3])
        rgb[unresolved] = blend.astype(np.uint8)
        unresolved = np.all(rgb == GRAY, axis=1)

    # C) per-face Kd via materials + face_materials (make_dataset.py:388-391)
    if unresolved.any():
        fc_mtl = face_rgba_from_materials(piece)
        if fc_mtl is not None:
            rgb[unresolved] = fc_mtl[fidx[unresolved], :3]

    return pts, rgb


def bake_piece_colors(piece: MeshPiece) -> Optional[np.ndarray]:
    """Per-face RGBA for GLB export, baking the piece's appearance
    (the reference's glb_bake path, make_dataset.py:545-562: texture ->
    colors, else per-face Kd).  Priority: per-face-material texture lookup
    at the face centroid UV -> existing face_colors -> vertex_colors
    (averaged) -> per-face Kd -> gray."""
    f = piece.faces
    if len(f) == 0:
        return None
    mats, face_mats = _piece_materials(piece)
    fc = np.tile(np.array([180, 180, 180, 255], np.uint8), (len(f), 1))
    resolved = np.zeros(len(f), bool)
    if piece.uv is not None and mats is not None:
        uv_c = piece.uv[f].mean(axis=1)                 # (F, 2) centroid UV
        u = np.mod(uv_c[:, 0], 1.0)
        v = np.mod(uv_c[:, 1], 1.0)
        for midx in np.unique(face_mats):
            mask = face_mats == midx
            mat = mats[midx] if midx < len(mats) else None
            if mat is not None and mat.image is not None:
                img = mat.image
                h, w = img.shape[:2]
                x = (u[mask] * (w - 1)).astype(np.int32)
                y = ((1.0 - v[mask]) * (h - 1)).astype(np.int32)
                fc[mask, :3] = img[y, x, :3]
                resolved[mask] = True
            elif mat is not None and mat.rgba is not None:
                fc[mask] = np.asarray(mat.rgba, np.uint8)[:4]
                resolved[mask] = True
    if not resolved.all() and piece.face_colors is not None \
            and len(piece.face_colors) == len(f):
        sel = ~resolved
        fc[sel, :3] = np.asarray(piece.face_colors, np.uint8)[sel, :3]
        resolved[sel] = True
    if not resolved.all() and piece.vertex_colors is not None \
            and len(piece.vertex_colors) == len(piece.vertices):
        sel = ~resolved
        vc = np.asarray(piece.vertex_colors, np.float32)[:, :3]
        fc[sel, :3] = vc[f[sel]].mean(axis=1).astype(np.uint8)
        resolved[sel] = True
    if not resolved.all():
        fm = face_rgba_from_materials(piece)
        if fm is not None:
            sel = ~resolved
            fc[sel] = fm[sel]
    return fc


def allocate_points(areas: np.ndarray, total_points: int) -> np.ndarray:
    """Area-weighted integer allocation (make_dataset.py:419-429)."""
    areas = np.maximum(np.asarray(areas, float), 1e-9)
    frac = areas / areas.sum()
    alloc = np.maximum((frac * total_points).astype(int), 0)
    while alloc.sum() < total_points:
        alloc[np.argmax(frac - alloc / total_points)] += 1
    while alloc.sum() > total_points:
        i = np.argmax(alloc)
        if alloc[i] > 0:
            alloc[i] -= 1
        else:
            break
    return alloc


def sample_model_points_colored(pieces: List[MeshPiece], total_points: int,
                                method: str = "random", oversample: int = 8,
                                rng: Optional[np.random.RandomState] = None
                                ) -> Tuple[np.ndarray, np.ndarray]:
    rng = rng or np.random.RandomState(0)
    if total_points <= 0 or not pieces:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    alloc = allocate_points([pc.area for pc in pieces], total_points)
    all_pts, all_rgb = [], []
    for piece, k in zip(pieces, alloc):
        if k <= 0:
            continue
        pts, rgb = sample_piece_points_with_color(piece, int(k),
                                                  method=method,
                                                  oversample=oversample,
                                                  rng=rng)
        if pts.shape[0]:
            all_pts.append(pts)
            all_rgb.append(rgb)
    if not all_pts:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    return np.vstack(all_pts), np.vstack(all_rgb)
