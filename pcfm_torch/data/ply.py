"""PLY point-cloud IO — a copy of pcfm/data/ply.py.  The ASCII reader
parses with the port's native library (``pcfm_torch.native``) and falls back
to numpy where it is not built (``pcfm_torch.native.available()``).

Writers match the reference's ASCII formats byte-for-byte
(util.py:35-64, 124-158); the reader additionally handles binary
little-endian PLY with xyz (+rgb) vertex properties so the packer can
consume `make_dataset.py` output.
"""
from __future__ import annotations

import io
import os
from typing import Optional, Tuple

import numpy as np

from pcfm_torch.native import parse_ascii_rows

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "double": "f8", "float32": "f4", "float64": "f8",
}


def save_point_cloud_xyz(xyz: np.ndarray, path: str):
    """Plain whitespace XYZ (util.py:35-45)."""
    arr = np.asarray(xyz)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for p in arr:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def save_point_cloud_ply(xyz: np.ndarray, path: str):
    """ASCII PLY with xyz floats (util.py:47-64)."""
    arr = np.asarray(xyz)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = arr.shape[0]
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "end_header\n"]
    with open(path, "w") as f:
        f.write("\n".join(header))
        for p in arr:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def save_point_cloud_ply_rgb(xyz: np.ndarray, rgb: np.ndarray, path: str):
    """ASCII PLY with xyz floats + uchar rgb (util.py:124-158).

    rgb: float in [0,1] (scaled by 255 with +0.5 rounding like the
    reference) or uint8 in [0,255].
    """
    xyz_np = np.asarray(xyz)
    rgb_np = np.asarray(rgb)
    if np.issubdtype(rgb_np.dtype, np.floating):
        rgb_np = (np.clip(rgb_np, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    else:
        rgb_np = rgb_np.astype(np.uint8)
    assert xyz_np.shape[0] == rgb_np.shape[0] and rgb_np.shape[1] == 3, \
        f"xyz/rgb shape mismatch: {xyz_np.shape} vs {rgb_np.shape}"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz_np.shape[0]
    header = ["ply", "format ascii 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z",
              "property uchar red", "property uchar green",
              "property uchar blue", "end_header\n"]
    with open(path, "w") as f:
        f.write("\n".join(header))
        for p, c in zip(xyz_np, rgb_np):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a PLY vertex cloud -> (xyz (N,3) float32, rgb (N,3) uint8|None).

    Supports ascii and binary_little_endian with arbitrary per-vertex
    property lists (x/y/z float required; red/green/blue optional).
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = 0
        props = []          # (name, dtype) in order, for the vertex element
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().decode("ascii", "ignore").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError(f"{path}: list property in vertex")
                props.append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        names = [p[0] for p in props]
        if fmt == "ascii":
            body = f.read()
            data = parse_ascii_rows(body, len(props), n_vertex)
            if data is None or data.shape[0] != n_vertex:
                data = np.atleast_2d(np.loadtxt(
                    io.BytesIO(body), max_rows=n_vertex, dtype=np.float64))
            rec = {name: data[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + d) for name, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n_vertex), dtype=dt,
                                count=n_vertex)
            rec = {name: raw[name] for name in names}
        else:
            raise ValueError(f"{path}: unsupported PLY format '{fmt}'")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    rgb = None
    if all(k in rec for k in ("red", "green", "blue")):
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]],
                       axis=-1)
        if np.issubdtype(rgb.dtype, np.floating) and rgb.max() <= 1.0:
            rgb = (rgb * 255.0 + 0.5)
        rgb = rgb.astype(np.uint8)
    return xyz, rgb
