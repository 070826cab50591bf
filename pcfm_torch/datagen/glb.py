"""Dependency-free binary glTF (.glb) writer for the datagen export.

The reference exports each pose's assembled world mesh as ``mesh.glb``
through trimesh (make_dataset.py:534-564, appearance baked to face
colors). trimesh isn't always available, so this module writes a minimal
valid glTF 2.0 binary directly: one mesh/node per MeshPiece, flat
per-face colors realized by duplicating vertices per face and attaching
a normalized ``COLOR_0`` u8 VEC4 attribute (glTF has no per-face colors).

Layout written: 12-byte GLB header, JSON chunk (4-byte aligned, space
padded), single BIN chunk holding positions (f32 VEC3), colors (u8 VEC4,
normalized) and indices (u32 SCALAR) for every piece.

The port's copy of ``pcfm/datagen/glb.py``: it imports nothing of ``pcfm``.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

from pcfm_torch.datagen.core import MeshPiece, bake_piece_colors

_MAGIC = 0x46546C67
_JSON_CHUNK = 0x4E4F534A
_BIN_CHUNK = 0x004E4942

_F32, _U8, _U32 = 5126, 5121, 5125
_ARRAY_BUF, _ELEM_BUF = 34962, 34963


def _align(b: bytearray, mult: int, pad: bytes):
    while len(b) % mult:
        b.extend(pad)


def write_glb(pieces: List[MeshPiece], path: Path) -> bool:
    """Bake appearance to per-face colors and write ``path``. Returns
    False when no non-empty piece exists (mirrors simulate.export_glb)."""
    bin_buf = bytearray()
    buffer_views = []
    accessors = []
    meshes = []
    nodes = []

    def add_view(data: bytes, target: Optional[int]) -> int:
        _align(bin_buf, 4, b"\x00")
        off = len(bin_buf)
        bin_buf.extend(data)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    for piece in pieces:
        if piece.is_empty:
            continue
        tri = piece.triangles.astype(np.float32)          # (F, 3, 3)
        n_f = tri.shape[0]
        pos = tri.reshape(-1, 3)                          # (3F, 3)
        fc = bake_piece_colors(piece)
        if fc is None:
            fc = np.tile(np.array([180, 180, 180, 255], np.uint8),
                         (n_f, 1))
        col = np.repeat(fc[:, :4].astype(np.uint8), 3, axis=0)  # (3F, 4)
        idx = np.arange(3 * n_f, dtype=np.uint32)

        pv = add_view(pos.tobytes(), _ARRAY_BUF)
        accessors.append({"bufferView": pv, "componentType": _F32,
                          "count": int(pos.shape[0]), "type": "VEC3",
                          "min": [float(x) for x in pos.min(axis=0)],
                          "max": [float(x) for x in pos.max(axis=0)]})
        a_pos = len(accessors) - 1
        cv = add_view(col.tobytes(), _ARRAY_BUF)
        accessors.append({"bufferView": cv, "componentType": _U8,
                          "normalized": True,
                          "count": int(col.shape[0]), "type": "VEC4"})
        a_col = len(accessors) - 1
        iv = add_view(idx.tobytes(), _ELEM_BUF)
        accessors.append({"bufferView": iv, "componentType": _U32,
                          "count": int(idx.shape[0]), "type": "SCALAR"})
        a_idx = len(accessors) - 1

        meshes.append({"primitives": [{
            "attributes": {"POSITION": a_pos, "COLOR_0": a_col},
            "indices": a_idx, "mode": 4}]})
        nodes.append({"mesh": len(meshes) - 1})

    if not meshes:
        return False
    _align(bin_buf, 4, b"\x00")

    gltf = {"asset": {"version": "2.0", "generator": "pcfm"},
            "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}],
            "nodes": nodes, "meshes": meshes,
            "buffers": [{"byteLength": len(bin_buf)}],
            "bufferViews": buffer_views, "accessors": accessors}
    js = bytearray(json.dumps(gltf, separators=(",", ":")).encode())
    _align(js, 4, b" ")

    total = 12 + 8 + len(js) + 8 + len(bin_buf)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _MAGIC, 2, total))
        f.write(struct.pack("<II", len(js), _JSON_CHUNK))
        f.write(js)
        f.write(struct.pack("<II", len(bin_buf), _BIN_CHUNK))
        f.write(bin_buf)
    return True


def read_glb_json(path: Path) -> dict:
    """Parse the JSON chunk of a GLB (round-trip validation helper)."""
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<III", f.read(12))
        if magic != _MAGIC or version != 2:
            raise ValueError(f"{path}: not a GLB v2 file")
        length, ctype = struct.unpack("<II", f.read(8))
        if ctype != _JSON_CHUNK:
            raise ValueError(f"{path}: first chunk is not JSON")
        return json.loads(f.read(length).decode())
