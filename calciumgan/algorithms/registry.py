"""Algorithm registry (parity: ``gan/algorithms/registry.py:1-19``)."""

from __future__ import annotations

from calciumgan.registry import Registry

algorithms: Registry = Registry("algorithm")
register = algorithms.register


def get_algorithm(config, generator, discriminator):
    """Instantiate the configured algorithm over (generator, discriminator)."""
    cls = algorithms.get(config.algorithm)
    return cls(config, generator, discriminator)
