"""Read scalars back out of TensorBoard event files (pure Python).

Complement of :mod:`calciumgan.utils.tb` — used to extract loss curves
and metric trajectories from runs without TensorBoard installed (e.g. sweep
result collection, tests, report generation).
"""

from __future__ import annotations

import glob
import os
import struct
from collections import defaultdict
from typing import Dict, Tuple

from calciumgan.data.tfrecord import read_records, _walk


def read_scalars(logdir_or_file: str) -> Dict[str, Dict[int, float]]:
    """{tag: {step: value}} from every event file under a logdir (non
    recursive) or a single file. Later files win on duplicate steps."""
    if os.path.isdir(logdir_or_file):
        files = sorted(glob.glob(
            os.path.join(logdir_or_file, "events.out.tfevents.*")))
    else:
        files = [logdir_or_file]
    series: Dict[str, Dict[int, float]] = defaultdict(dict)
    for path in files:
        try:
            for record in read_records(path):
                step, pairs = 0, []
                for field, wire, v in _walk(record):
                    if field == 2 and wire == 0:
                        step = v
                    elif field == 5 and wire == 2:      # Summary
                        for f2, _, val_buf in _walk(v):
                            if f2 != 1:
                                continue
                            # tag/value are PER Summary.Value submessage —
                            # multi-value events must not cross-associate
                            tag, value = None, None
                            for f3, w3, item in _walk(val_buf):
                                if f3 == 1:
                                    tag = item.decode()
                                elif f3 == 2 and w3 == 5:
                                    (value,) = struct.unpack("<f", item)
                            if tag is not None and value is not None:
                                pairs.append((tag, value))
                for tag, value in pairs:
                    series[tag][step] = value
        except (OSError, ValueError, IndexError, struct.error):
            continue  # truncated file from a preempted run (struct.error:
            # a record cut mid-payload yields a <4-byte float slice)
    return dict(series)


def last_value(logdir: str, tag: str) -> Tuple[int, float]:
    """(step, value) of the newest step for ``tag``."""
    series = read_scalars(logdir).get(tag, {})
    if not series:
        raise KeyError(f"no scalar '{tag}' under {logdir}")
    step = max(series)
    return step, series[step]
