"""MuCHSALSA on PyTorch and CUDA: the port of ``muchsalsa_tpu`` to one
NVIDIA H100.

The port owns every module it runs.  The device code and the entry points
that choose it are its own; the host layers (ingest, graph, matching,
chaining oracle, contraction, spanning, orientation, linearization,
consensus, the host mapper and the pipeline's host stages, ``native``,
``config``) are its own copies of the JAX package's modules, at the same
paths, with their JAX/TPU branches removed.  It imports neither JAX nor
anything of ``muchsalsa_tpu``.
"""
