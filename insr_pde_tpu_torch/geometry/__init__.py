"""Mesh geometry of the port (counterpart of `insr_pde_tpu/geometry`): the
same exported names."""

from .mesh_io import read_mesh, read_medit, read_obj, write_medit
from .mesh_ops import (area_weighted_distribution, barycentric_coordinates,
                       boundary_faces, normalize, per_face_areas,
                       per_face_normals, per_tet_volumes, per_vertex_areas,
                       point_sample, random_face, random_tet,
                       sample_mesh, sample_near_surface, sample_spc,
                       sample_surface, sample_tex,
                       sample_uniform_aabb, sample_volume,
                       volume_weighted_distribution)
from .procedural import box_tet_mesh, box_tri_mesh, statue_tet_mesh

__all__ = [
    "read_mesh", "read_medit", "read_obj", "write_medit",
    "normalize", "per_face_normals", "per_face_areas", "per_tet_volumes",
    "per_vertex_areas", "boundary_faces", "area_weighted_distribution",
    "volume_weighted_distribution", "random_face", "random_tet",
    "sample_surface", "sample_volume", "sample_mesh", "sample_near_surface",
    "sample_spc", "sample_tex",
    "point_sample", "barycentric_coordinates", "sample_uniform_aabb",
    "box_tet_mesh", "box_tri_mesh", "statue_tet_mesh",
]
