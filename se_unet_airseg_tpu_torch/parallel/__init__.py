"""Data and space parallelism of the port: one process per device over
torch.distributed (`mesh.py`)."""

from .mesh import (
    AXES,
    DataMesh,
    MeshAxes,
    all_gather_rows,
    all_gather_slabs,
    all_sum,
    batch_sharding,
    broadcast_tree,
    halo,
    make_mesh,
    replicated,
    space_sum,
    spawn,
    sum_over_ranks,
)

__all__ = [
    "AXES",
    "DataMesh",
    "MeshAxes",
    "all_gather_rows",
    "all_gather_slabs",
    "all_sum",
    "batch_sharding",
    "broadcast_tree",
    "halo",
    "make_mesh",
    "replicated",
    "space_sum",
    "spawn",
    "sum_over_ranks",
]
