"""Device-mesh parallelism for CalciumGAN.

The reference has NO distribution (single GPU, no ``tf.distribute``, no
collectives — SURVEY.md §2.10/§5.8). This package is the new first-class
infrastructure: a ``jax.sharding.Mesh`` over the visible devices with

- data parallelism: batches sharded over the ``data`` axis; gradient means
  become XLA ``all-reduce``s inserted automatically under jit,
- optional model parallelism: the two O(seq)-parameter Dense layers (the
  discriminator's flatten head and the generator's input projection) sharded
  over the ``model`` axis.
"""

from calciumgan.parallel.mesh import (  # noqa: F401
    batch_sharding,
    create_mesh,
    make_step_fns,
    replicated,
    state_shardings,
)
