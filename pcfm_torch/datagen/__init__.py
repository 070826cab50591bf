"""Offline dataset generation: URDF -> posed colored point clouds
(pybullet-gated) + pure-numpy sampling core.

The port's copy of ``pcfm/datagen/__init__.py``: it imports nothing of ``pcfm``.
"""
from pcfm_torch.datagen.core import (Material, MeshPiece,
                               allocate_points,
                               barycentric_weights, build_per_joint_grids,
                               choose_anno_id, fps_downsample,
                               include_row_by_cats, parse_steps_override,
                               random_combinations, read_index_csv,
                               row_get_category, sample_model_points_colored,
                               sample_piece_points_with_color,
                               sample_surface, bake_piece_colors,
                               face_rgba_from_materials,
                               material_color_to_rgba255)

__all__ = [
    "Material", "MeshPiece", "bake_piece_colors",
    "face_rgba_from_materials", "material_color_to_rgba255", "allocate_points", "barycentric_weights",
    "build_per_joint_grids", "choose_anno_id", "fps_downsample",
    "include_row_by_cats", "parse_steps_override", "random_combinations",
    "read_index_csv", "row_get_category", "sample_model_points_colored",
    "sample_piece_points_with_color", "sample_surface",
]
