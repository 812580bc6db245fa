"""repro_torch.launch — process groups and meshes for the distributed path.

Counterpart of ``repro/launch/mesh.py``'s ``make_mesh`` and
``make_host_mesh``: :func:`~repro_torch.launch.mesh.make_mesh` builds a
``DeviceMesh`` over an initialized ``torch.distributed`` group, and
:func:`~repro_torch.launch.mesh.launch` runs a function on every rank of
a fresh group of spawned processes on this machine (gloo over
127.0.0.1), the counterpart of the reference's forced host devices.
``make_production_mesh`` and ``launch/sharding.py`` are ROADMAP A3.
The training driver is :mod:`repro_torch.launch.train` (``python -m
repro_torch.launch.train``).
"""
from repro_torch.launch.mesh import axis_size, launch, make_mesh

__all__ = ["axis_size", "launch", "make_mesh"]
