"""The ground-truth data simulator: ``muchsalsa_tpu.testing.simulate``
unchanged (host numpy, no JAX), so that port scripts name only the port."""

from muchsalsa_tpu.testing.simulate import (
    add_noise, illumina_pairs, random_genome, simulate, write_simulation)

__all__ = ["add_noise", "illumina_pairs", "random_genome", "simulate", "write_simulation"]
