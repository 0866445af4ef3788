"""Launchers of the port: the training CLI (``python -m repro_torch.launch.train``).

The JAX package's other launchers (the production mesh, the dry-runs and
their input specs) are TPU tooling and are not ported yet.
"""
