"""Production mesh entry point of the dry run (port of
``repro/launch/mesh.py``): logical meshes, ``meta`` by default, so that
importing this module or building a mesh touches no device."""
from repro_torch.parallel.mesh import (factor_mesh, host_devices,
                                       make_job_mesh, make_production_mesh,
                                       mesh_device_set)

__all__ = ["make_production_mesh", "make_job_mesh", "factor_mesh",
           "host_devices", "mesh_device_set"]
