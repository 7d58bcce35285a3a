"""Long-context WGAN-GP: training over a time-sharded (context-parallel) mesh.

The reference handles long recordings purely offline (windowed segmentation
to sl2048 — SURVEY.md §5.7); this module trains the UNSEGMENTED long
sequence directly by composing the sequence-parallel generator and
discriminator (:mod:`calciumgan.parallel.seq_parallel`) with the
standard WGAN-GP machinery: :class:`LongContextWGAN_GP` subclasses the
production algorithm and swaps only the two module-apply hooks, so the
critic loop, fused gradient penalty (second-order autodiff through
``shard_map`` + ``ppermute`` — gradient parity proven in
``tests/test_seq_parallel.py``), optimizer updates, logging, and semantics
(same real batch across critic iterations, one phase shift per
discriminator call) are all inherited verbatim.

Supported mesh: ``(data, time)`` — batch rows sharded over ``data``,
sequence frames over ``time`` (either axis may be size 1). Constraints come
from the sequence-parallel stack: layer_norm or no norm (BatchNorm's batch
statistics would need a cross-shard reduction), ``calciumgan`` (1-D) models,
and every layer's shard width must cover its halo — i.e. this is for
sequences of tens of thousands of frames, the regime the reference cannot
reach at all.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from calciumgan.algorithms.wgan_gp import WGAN_GP
from calciumgan.parallel.seq_parallel import (seq_parallel_discriminator,
                                                  seq_parallel_generator)

TIME_AXIS = "time"
DATA_AXIS = "data"


def create_time_mesh(data_parallelism: int = 1, time_parallelism: int = -1,
                     devices=None) -> Mesh:
    """(data, time) mesh; ``time_parallelism=-1`` uses the remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    if time_parallelism == -1:
        if len(devices) % data_parallelism:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"data_parallelism {data_parallelism}")
        time_parallelism = len(devices) // data_parallelism
    n = data_parallelism * time_parallelism
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices "
                         f"({data_parallelism} data x {time_parallelism} "
                         f"time), have {len(devices)}")
    mesh_devices = np.array(devices[:n]).reshape(
        (data_parallelism, time_parallelism))
    return Mesh(mesh_devices, (DATA_AXIS, TIME_AXIS))


class LongContextWGAN_GP(WGAN_GP):
    """WGAN-GP whose generator/discriminator applies run sequence-parallel.

    Construct via :func:`make_long_context_algorithm`. ``batch_stats`` are
    passed through untouched (BatchNorm is rejected at init)."""

    def __init__(self, config, generator, discriminator, mesh: Mesh):
        super().__init__(config, generator, discriminator)
        if getattr(config, "batch_norm", False):
            raise ValueError(
                "long-context training supports layer_norm only (BatchNorm "
                "statistics would need cross-shard reduction)")
        self.mesh = mesh
        self.strides = int(config.strides)
        self.m = int(config.m)
        self.activation = config.activation
        # match the modules' compute-dtype policy
        # (models/calciumgan.py:build) so --mixed_precision stays bf16 here
        import jax.numpy as jnp
        self.compute_dtype = (jnp.bfloat16 if config.mixed_precision
                              else jnp.float32)

    def gen_apply(self, params, batch_stats, noise, key, training: bool):
        fake = seq_parallel_generator(
            params, noise, self.mesh, TIME_AXIS, strides=self.strides,
            activation=self.activation, normalize=self.normalize,
            batch_axis=DATA_AXIS, dtype=self.compute_dtype)
        return fake, batch_stats

    def dis_apply(self, params, batch_stats, x, key, training: bool):
        phase_keys = None
        if training and self.m > 0:
            # one shift per discriminator call per shuffled layer, shared
            # across the batch — the reference's semantics (SURVEY.md §7)
            phase_keys = list(jax.random.split(key, 4))
        out = seq_parallel_discriminator(
            params, x, phase_keys, self.mesh, TIME_AXIS,
            strides=self.strides, m=self.m, activation=self.activation,
            batch_axis=DATA_AXIS, dtype=self.compute_dtype)
        return out, batch_stats


def make_long_context_algorithm(config, mesh: Optional[Mesh] = None,
                                generator=None, discriminator=None):
    """(algo, train_fn, eval_fn, generate_fn) for time-sharded training.

    ``train_fn/eval_fn`` take ``(state, real, key)`` with ``real`` sharded
    ``P('data', 'time', None)``; params/state replicated (the models are
    small — time sharding is about ACTIVATION memory and compute, which
    scale with sequence length)."""
    if config.algorithm != "wgan-gp":
        raise ValueError(
            f"long-context training supports wgan-gp (got "
            f"{config.algorithm!r})")
    if config.model != "calciumgan":
        raise ValueError(
            f"long-context training supports the 1-D calciumgan model (got "
            f"{config.model!r})")
    mesh = mesh or create_time_mesh()
    if generator is None or discriminator is None:
        from calciumgan.models.registry import get_models
        generator, discriminator = get_models(config)
    algo = LongContextWGAN_GP(config, generator, discriminator, mesh)

    rep = NamedSharding(mesh, P())
    data_in = NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
    noise_in = NamedSharding(mesh, P(DATA_AXIS, None))

    train = jax.jit(algo.train_step,
                    in_shardings=(rep, data_in, rep),
                    out_shardings=(rep, rep),
                    donate_argnums=(0,))
    evaluate = jax.jit(algo.eval_step,
                       in_shardings=(rep, data_in, rep,
                                     NamedSharding(mesh, P(DATA_AXIS))),
                       out_shardings=(data_in, rep))
    generate = jax.jit(
        lambda state, noise, key: algo.generate(state, noise, key,
                                                denorm=False),
        in_shardings=(rep, noise_in, rep),
        out_shardings=data_in)
    return algo, train, evaluate, generate
