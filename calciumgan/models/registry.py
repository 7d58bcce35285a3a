"""Model registry: name -> (generator module, discriminator module).

Parity with ``gan/models/registry.py:6-33`` (which also logged parameter
counts — that now happens in the training driver where the params exist).
The reference's default ``--model wavegan`` names a model that was renamed to
``calciumgan`` and no longer exists (SURVEY.md §2.11.2); we accept
``wavegan`` as an alias instead of dying.
"""

from __future__ import annotations

from calciumgan.registry import Registry

models: Registry = Registry("model")
register = models.register


def get_models(config):
    """Instantiate (generator, discriminator) modules for config.model."""
    name = config.model
    if name == "wavegan" and name not in models:
        name = "calciumgan"
    builder = models.get(name)
    return builder(config)
