"""PyTorch/CUDA port of the DMTRL system (``repro`` is the JAX reference).

Each module sits at the same relative path as its counterpart in
``repro`` and keeps its public names. The port imports torch, numpy and
the standard library only.
"""
