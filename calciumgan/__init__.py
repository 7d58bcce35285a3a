"""CalciumGAN in JAX: a framework for synthesising realistic calcium-imaging
fluorescence traces with WaveGAN-style GANs, on one or more GPUs.

A ground-up re-design of the capabilities of bryanlimy/CalciumGAN
(arXiv:2009.02707):

- functional core: pure train steps over an explicit train-state pytree with
  threaded PRNG keys (no hidden layer state, no global seeds),
- ``jax.jit`` + ``jax.sharding.Mesh`` data/model parallelism from day one
  (mesh size 1 == single device),
- bf16 mixed precision (no loss scaling needed, unlike the reference's fp16),
- on-device evaluation (a CUDA OASIS AR(1) deconvolution kernel, spike
  statistics in XLA) replacing the reference's CPU ``multiprocessing.Pool``
  + Cython OASIS,
- a typed, serialisable :class:`~calciumgan.config.Config` replacing the
  mutable ``argparse.Namespace`` threaded through the reference.

Reference layer map: see SURVEY.md at the repository root.
"""

__version__ = "0.1.0"
