"""Production meshes, as ``torch.distributed`` ``DeviceMesh``es.

Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the pod axis is pure data parallelism (gradient
reduce only). The shapes and axis names are the JAX package's
(``src/repro/launch/mesh.py``), so its sharding plans carry over name for
name.

A ``DeviceMesh`` needs a process group of its size: ``init_device_mesh``
uses the default one (a launcher such as ``torchrun`` sets its rank and
size in the environment), or ``launch.dryrun``'s one-process world on the
``fake`` backend. Defined as functions so importing this module touches no
process group. ``elastic_mesh`` re-factorises a degraded device count after
failures — the paper's virtual-node treatment applied to the mesh itself.
"""

from __future__ import annotations

from contextlib import contextmanager
from contextvars import ContextVar

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "elastic_shape", "elastic_mesh",
           "mesh_axis_sizes", "set_mesh", "current_mesh"]

_MESH: ContextVar[DeviceMesh | None] = ContextVar("mesh", default=None)


@contextmanager
def set_mesh(mesh: DeviceMesh):
    """Bind ``mesh`` for the duration of a ``with`` block, as the JAX
    package's ``set_mesh`` context does (``current_mesh`` reads it)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> DeviceMesh | None:
    return _MESH.get()


def _mk(shape, axes, device_type: str) -> DeviceMesh:
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, ep: int | None = None,
                         device_type: str = "cuda") -> DeviceMesh:
    """ep: carve a dedicated expert axis out of the data axis (EP meshes for
    MoE archs whose expert count doesn't divide the model axis)."""
    if ep:
        per_pod_data = 256 // (ep * 16)
        if per_pod_data * ep * 16 != 256:
            raise ValueError(f"ep={ep} doesn't factor a 256-chip pod")
        if multi_pod:
            return _mk((2, ep, per_pod_data, 16),
                       ("pod", "expert", "data", "model"), device_type)
        return _mk((ep, per_pod_data, 16), ("expert", "data", "model"),
                   device_type)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device_type)


def elastic_shape(n_devices: int, model_parallel: int = 16
                  ) -> tuple[int, int]:
    """(data, model) mesh shape covering <= n_devices after failures.

    Keeps the model axis fixed (TP degree is a property of the sharded
    weights) and shrinks the data axis — surviving hosts reload the
    checkpoint under the new mesh and PSTS rebalances the input work."""
    model = model_parallel
    while model > 1 and n_devices < model:
        model //= 2
    data = max(n_devices // model, 1)
    return data, model


def elastic_mesh(n_devices: int, model_parallel: int = 16,
                 device_type: str = "cuda") -> DeviceMesh:
    return _mk(elastic_shape(n_devices, model_parallel), ("data", "model"),
               device_type)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``), or of a stand-in with the JAX mesh's ``axis_names`` and
    ``devices`` (an array of the mesh's shape), as the sharding audit
    builds one."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))
