"""Print the raw-vs-EMA A/B comparison table from two scored run dirs.

Reads ``metrics/metrics.json`` (written by ``compute_metrics.py``) from a
raw-view run dir and an EMA-view run dir and emits a markdown table over
their common epochs. Companion to ``tools/ab_raw_ema.py`` (which builds the
raw view); the study this feeds replaces the reference's
single-view eval (`/root/reference/compute_metrics.py:186-200`).

Usage: python tools/ab_table.py RAW_DIR EMA_DIR [LABEL]
"""

import json
import sys


def load(run_dir):
    with open(f"{run_dir}/metrics/metrics.json") as f:
        return json.load(f)["epochs"]


def fmt(row):
    return (f"{row['firing_rate_kl']:.2f} / {row['correlation_kl']:.3f} / "
            f"{row['van_rossum_kl']:.2f}")


def main():
    raw_dir, ema_dir = sys.argv[1], sys.argv[2]
    label = sys.argv[3] if len(sys.argv) > 3 else "ema"
    raw, ema = load(raw_dir), load(ema_dir)
    common = sorted(set(raw) & set(ema), key=int)
    print(f"| epoch | raw fr / corr / vR | {label} fr / corr / vR |")
    print("|---|---|---|")
    for e in common:
        print(f"| {e} | {fmt(raw[e])} | {fmt(ema[e])} |")


if __name__ == "__main__":
    main()
