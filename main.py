"""Train CalciumGAN.

CLI parity with the reference driver (``/root/reference/main.py:227-267``):
same flag names and defaults, with the broken ``--model wavegan`` default
fixed to the registered ``calciumgan`` (SURVEY.md §2.11.2), plus
parallelism and runtime flags (``--seed``, ``--data_parallelism``, ``--model_parallelism``,
``--checkpoint_every``).
"""

import argparse

from calciumgan.config import Config


def parse_args(argv=None) -> Config:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", default="dataset/tfrecords", type=str)
    parser.add_argument("--output_dir", default="runs", type=str)
    parser.add_argument("--batch_size", default=64, type=int)
    parser.add_argument("--num_units", default=32, type=int)
    parser.add_argument("--kernel_size", default=24, type=int)
    parser.add_argument("--strides", default=2, type=int)
    parser.add_argument("--m", default=2, type=int,
                        help="phase shuffle shift (temporal)")
    parser.add_argument("--n", default=2, type=int,
                        help="phase shuffle shift (neuron axis, 2d model)")
    parser.add_argument("--epochs", default=20, type=int)
    parser.add_argument("--dropout", default=0.2, type=float)
    parser.add_argument("--learning_rate", default=1e-4, type=float)
    parser.add_argument("--noise_dim", default=32, type=int)
    parser.add_argument("--gradient_penalty", default=10.0, type=float)
    parser.add_argument("--model", default="calciumgan", type=str)
    parser.add_argument("--activation", default="leakyrelu", type=str)
    parser.add_argument("--batch_norm", action="store_true")
    parser.add_argument("--layer_norm", action="store_true")
    parser.add_argument("--algorithm", default="wgan-gp", type=str)
    parser.add_argument("--n_critic", default=5, type=int)
    parser.add_argument("--unroll_critic", action="store_true",
                        help="unroll the critic loop into the XLA graph "
                             "(same math; better scheduling and honest FLOP "
                             "accounting at ~n_critic x compile time)")
    parser.add_argument("--ema", default=0.0, type=float,
                        help="generator-EMA decay per generator update "
                             "(0 = off, typical 0.999): eval/generate use "
                             "the averaged generator, smoothing adversarial "
                             "oscillation in the eval metrics")
    parser.add_argument("--clear_output_dir", action="store_true")
    parser.add_argument("--save_generated", default="", type=str,
                        choices=["", "last", "all"])
    parser.add_argument("--plot_weights", action="store_true")
    parser.add_argument("--skip_checkpoints", action="store_true")
    parser.add_argument("--mixed_precision", action="store_true",
                        help="bfloat16 compute (no loss scaling needed)")
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--dpi", default=120, type=int)
    parser.add_argument("--verbose", default=1, type=int)
    # parallelism and runtime flags (not in the reference)
    parser.add_argument("--seed", default=1234, type=int)
    parser.add_argument("--data_parallelism", default=-1, type=int,
                        help="-1: all visible devices")
    parser.add_argument("--model_parallelism", default=1, type=int)
    parser.add_argument("--time_parallelism", default=1, type=int,
                        help="shard the sequence (time) axis over N devices "
                             "for long-context training (wgan-gp + "
                             "calciumgan + layer_norm)")
    parser.add_argument("--dcn_slices", default=1, type=int,
                        help="multi-slice: prepend a 'slice' mesh axis over "
                             "contiguous device blocks, restricted to data "
                             "parallelism (batch shards over slice x data; "
                             "only gradient all-reduces cross blocks)")
    parser.add_argument("--checkpoint_every", default=10, type=int)
    parser.add_argument("--device_store", default="auto",
                        choices=["auto", "on", "off"],
                        help="stage the dataset signals on device once and "
                             "gather batches in-graph instead of streaming "
                             "per-batch uploads (auto: single process + "
                             "accelerator + fits --device_store_mb)")
    parser.add_argument("--device_store_mb", default=4096, type=int)
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host: call jax.distributed.initialize() "
                             "(coordinator from the standard JAX env vars); "
                             "data shards are split per process")
    args = parser.parse_args(argv)
    if args.distributed:
        import jax
        jax.distributed.initialize()
    del args.distributed

    config = Config.from_args(args)
    # reference flags surrogate datasets by directory name (main.py:264-265)
    config.surrogate_ds = "surrogate" in config.input_dir
    return config


if __name__ == "__main__":
    from calciumgan.train import main

    main(parse_args())
