"""repro_torch.launch — process groups, meshes and sharding rules.

Counterpart of ``repro/launch/mesh.py`` and ``repro/launch/sharding.py``:
:func:`~repro_torch.launch.mesh.make_mesh` builds a ``DeviceMesh`` over
an initialized ``torch.distributed`` group, ``make_host_mesh`` and
``make_production_mesh`` the model meshes, and
:func:`~repro_torch.launch.mesh.launch` runs a function on every rank of
a fresh group of spawned processes on this machine (gloo over
127.0.0.1), the counterpart of the reference's forced host devices.
:mod:`repro_torch.launch.sharding` holds the parameter, batch and cache
rules. The training driver is :mod:`repro_torch.launch.train` (``python
-m repro_torch.launch.train``).
"""
from repro_torch.launch.mesh import (AbstractMesh, axis_size, launch,
                                     make_host_mesh, make_mesh,
                                     make_production_mesh)

__all__ = ["AbstractMesh", "axis_size", "launch", "make_host_mesh",
           "make_mesh", "make_production_mesh"]
