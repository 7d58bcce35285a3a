"""Generate synthetic calcium signals from a trained checkpoint (serving).

The reference can only generate inside the training process
(``/root/reference/main.py:141-156``, ``gan/utils/utils.py:191-207``); this
standalone CLI restores a checkpoint and batch-generates on the mesh:

    python generate.py --output_dir runs/001 --num_samples 100000 \
        --out samples.h5

Writes denormalised NWC float32 signals (h5 dataset ``signals``), optionally
with on-device OASIS-deconvolved spikes (``--spikes``).
"""

import argparse
import os

import jax
import numpy as np

from calciumgan.algorithms.registry import get_algorithm
from calciumgan.config import Config
from calciumgan.data.pipeline import reverse_preprocessing
from calciumgan.models.registry import get_models
from calciumgan.parallel import mesh as mesh_lib
from calciumgan.utils import checkpoint, h5


def main(config, num_samples: int, out: str, batch_size: int = 1024,
         with_spikes: bool = False, epoch=None, seed: int = 0):
    from calciumgan.train import enable_compilation_cache
    enable_compilation_cache()

    config.load()  # hparams.json of the training run
    config.validate_model_shapes()
    generator, discriminator = get_models(config)
    algo = get_algorithm(config, generator, discriminator)

    mesh = mesh_lib.create_mesh(config.data_parallelism,
                                config.model_parallelism)
    state = algo.init_state(jax.random.PRNGKey(0))
    state = jax.device_put(state, mesh_lib.state_shardings(mesh, state))
    ckpt_dir = config.ckpt_dir or os.path.join(config.output_dir,
                                               "checkpoints")
    state, restored_epoch = checkpoint.restore(ckpt_dir, state, epoch=epoch,
                                               verbose=config.verbose)
    if restored_epoch is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")

    _, _, generate_fn = mesh_lib.make_step_fns(algo, mesh, state)

    n_dev = mesh_lib.data_extent(mesh)
    batch_size = -(-batch_size // n_dev) * n_dev
    key = jax.random.PRNGKey(seed)
    # multi-host: each process feeds and persists its own rows
    proc, nproc = jax.process_index(), jax.process_count()
    local_bs = batch_size // nproc
    if nproc > 1:
        out = f"{out}.{proc:03d}"
        num_samples = -(-num_samples // nproc)
    if os.path.exists(out):
        os.remove(out)

    written = 0
    while written < num_samples:
        n = min(local_bs, num_samples - written)
        k = jax.random.fold_in(key, written)
        noise = np.asarray(jax.device_get(algo.get_noise(k, batch_size)))
        noise = noise[proc * local_bs:(proc + 1) * local_bs]
        fake = generate_fn(state, mesh_lib.put_batch(mesh, noise), k)
        signals = reverse_preprocessing(
            config, mesh_lib.local_rows(fake))[:n].astype(np.float32)
        payload = {"signals": signals}
        if with_spikes:
            from calciumgan.eval.spike_eval import deconvolve_traces
            traces = np.transpose(signals, (0, 2, 1))
            payload["spikes"] = np.transpose(
                deconvolve_traces(traces), (0, 2, 1)).astype(np.int8)
        h5.write(out, payload)
        written += n
        if config.verbose:
            print(f"\r{written}/{num_samples}", end="", flush=True)
    if config.verbose:
        print(f"\nsaved {written} samples (epoch {restored_epoch} "
              f"checkpoint) to {out}")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--output_dir", default="runs", type=str,
                        help="training run directory (hparams + checkpoints)")
    parser.add_argument("--num_samples", default=10000, type=int)
    parser.add_argument("--batch_size", default=1024, type=int)
    parser.add_argument("--out", default="", type=str,
                        help="output h5 (default <output_dir>/samples.h5)")
    parser.add_argument("--spikes", action="store_true",
                        help="also deconvolve spikes (OASIS)")
    parser.add_argument("--epoch", default=None, type=int,
                        help="checkpoint epoch (default: latest)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--ema", default=argparse.SUPPRESS, type=float,
                        help="override the run's --ema at generation time "
                             "(e.g. --ema 0 samples the RAW generator of an "
                             "EMA-trained checkpoint — the raw/EMA eval A/B)")
    parser.add_argument("--verbose", default=1, type=int)
    args = parser.parse_args()

    config = Config(output_dir=args.output_dir, verbose=args.verbose)
    if hasattr(args, "ema"):
        config.ema = args.ema
        config._explicit.add("ema")
    main(config, num_samples=args.num_samples,
         out=args.out or os.path.join(args.output_dir, "samples.h5"),
         batch_size=args.batch_size, with_spikes=args.spikes,
         epoch=args.epoch, seed=args.seed)
