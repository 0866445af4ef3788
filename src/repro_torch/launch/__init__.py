"""Launchers of the port: the training CLI (``python -m repro_torch.launch.train``)
and the meshes of the sharded train step with the H100's constants
(``launch.mesh``).

The JAX package's dry-runs and their input specs are not ported yet.
"""
from .mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16, make_host_mesh, make_production_mesh

__all__ = [
    "HBM_BW",
    "NVLINK_BW",
    "PEAK_FLOPS_BF16",
    "make_host_mesh",
    "make_production_mesh",
]
