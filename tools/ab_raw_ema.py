"""Raw-vs-EMA generator eval A/B for an ``--ema``-trained run.

An ``--ema`` run's per-epoch ``generated/epochNNN_signals.h5`` files are
sampled from the AVERAGED generator (``algorithms/gan.py:generate``); its
checkpoints carry both parameter sets. This tool regenerates selected epochs
from the RAW (instantaneous) generator via the ``generate.py --ema 0``
override into a sibling run view, so ``compute_metrics.py`` can score both
trajectories with identical machinery:

    python tools/ab_raw_ema.py --run runs/fft_ema --epochs 80 105 135 149
    python compute_metrics.py --output_dir runs/fft_ema_raw --all_epochs --no_plots

Context: the round-4 fft per-channel record showed a post-optimum rebound
(firing-rate KL 12.9 @80 -> 16.5 @149); the reference has no equivalent —
it can only sample inside training (``/root/reference/main.py:141-156``)
and keeps no averaged generator.
"""

import argparse
import os
import pickle
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from calciumgan.config import Config


def build_raw_view(run_dir: str, epochs, num_samples: int = 1000,
                   batch_size: int = 256, out_dir: str = "") -> str:
    import generate

    out_dir = out_dir or run_dir.rstrip("/") + "_raw"
    gen_dir = os.path.join(out_dir, "generated")
    os.makedirs(gen_dir, exist_ok=True)
    # the eval CLIs need the run's hparams and the cached validation set;
    # the raw view shares both with the EMA run
    shutil.copy(os.path.join(run_dir, "hparams.json"),
                os.path.join(out_dir, "hparams.json"))
    val = os.path.join(run_dir, "generated", "validation.h5")
    val_view = os.path.join(gen_dir, "validation.h5")
    if not os.path.exists(val_view):
        os.link(val, val_view)

    with open(os.path.join(run_dir, "generated", "info.pkl"), "rb") as f:
        train_info = pickle.load(f)

    info = {}
    for epoch in epochs:
        out = os.path.join(gen_dir, f"epoch{epoch:03d}_signals.h5")
        if not os.path.exists(out):
            config = Config(output_dir=run_dir, verbose=1)
            config.ema = 0.0            # the override under test
            config._explicit.add("ema")
            generate.main(config, num_samples=num_samples, out=out,
                          batch_size=batch_size, epoch=epoch)
        info[epoch] = {"global_step": train_info.get(epoch, {}).get(
            "global_step", epoch), "filename": out}
    with open(os.path.join(gen_dir, "info.pkl"), "wb") as f:
        pickle.dump(info, f)
    # point the view's hparams at itself so compute_metrics writes its
    # metrics/ and events under the view, not the EMA run
    import json
    hp_path = os.path.join(out_dir, "hparams.json")
    with open(hp_path) as f:
        hp = json.load(f)
    hp["output_dir"] = out_dir
    hp["ema"] = 0.0
    with open(hp_path, "w") as f:
        json.dump(hp, f, indent=2)
    print(f"raw view at {out_dir}: epochs {sorted(info)}")
    return out_dir


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--run", required=True,
                        help="--ema training run directory")
    parser.add_argument("--epochs", nargs="+", type=int, required=True)
    parser.add_argument("--num_samples", default=1000, type=int)
    parser.add_argument("--batch_size", default=256, type=int)
    parser.add_argument("--out_dir", default="", type=str)
    args = parser.parse_args()
    build_raw_view(args.run, args.epochs, num_samples=args.num_samples,
                   batch_size=args.batch_size, out_dir=args.out_dir)
