from .distributed import maybe_initialize, maybe_initialize_from_config
from .mesh import Mesh, cpu_mesh, data_sharding, make_mesh, replicate
from .spatial import (RECEPTIVE_RADIUS, plan_windows, receptive_radius,
                      tiled_apply, tiled_forward_for, window_starts)
from .spatial_mesh import (halo_sharded_apply, halo_sharded_forward_for,
                           row_sharding)

__all__ = [
    "Mesh", "RECEPTIVE_RADIUS", "cpu_mesh", "data_sharding",
    "halo_sharded_apply", "halo_sharded_forward_for", "make_mesh",
    "maybe_initialize", "maybe_initialize_from_config", "plan_windows",
    "receptive_radius", "replicate", "row_sharding", "tiled_apply",
    "tiled_forward_for", "window_starts",
]
