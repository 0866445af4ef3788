"""Launchers of the port: the training CLI (``python -m repro_torch.launch.train``),
the meshes of the sharded train and serving steps with the H100's constants
(``launch.mesh``), and the dry run (``python -m repro_torch.launch.dryrun``,
``python -m repro_torch.launch.dryrun_dmtrl``) over ``launch.input_specs``.

Unlike the JAX package's dry runs, the port's set nothing at import, so any
of them may be imported here or alone.
"""
from .mesh import (
    HBM_BW,
    HBM_BYTES,
    NVLINK_BW,
    PEAK_FLOPS_BF16,
    fake_world,
    make_dryrun_mesh,
    make_host_mesh,
    make_production_mesh,
)

__all__ = [
    "HBM_BW",
    "HBM_BYTES",
    "NVLINK_BW",
    "PEAK_FLOPS_BF16",
    "fake_world",
    "make_dryrun_mesh",
    "make_host_mesh",
    "make_production_mesh",
]
