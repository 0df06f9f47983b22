from .sharding import constrain, mesh_axis_size, spec_for_mesh, use_mesh

__all__ = ["constrain", "mesh_axis_size", "spec_for_mesh", "use_mesh"]
