from .sharding import (NamedSharding, constrain, fit_sharding, make_sharding,
                       mesh_axis_size, spec_for_mesh, tree_shardings,
                       use_mesh)

__all__ = ["NamedSharding", "constrain", "fit_sharding", "make_sharding",
           "mesh_axis_size", "spec_for_mesh", "tree_shardings", "use_mesh"]
