"""Launch layer: production meshes, sharding plans, the dry run, roofline
analysis, and the entry points ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``.

NOTE: do not import ``dryrun`` from library code — it starts a
``torch.distributed`` world on the ``fake`` backend when it runs a cell.
"""

from .mesh import elastic_mesh, make_production_mesh, mesh_axis_sizes

__all__ = ["elastic_mesh", "make_production_mesh", "mesh_axis_sizes"]
