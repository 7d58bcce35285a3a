"""Typed configuration for CalciumGAN.

Replaces the reference's single mutable ``argparse.Namespace`` (``hparams``)
that is threaded through every layer and enriched as a side effect
(see ``/root/reference/main.py:227-267``, ``gan/utils/dataset_helper.py:113-144``
and ``search.py:16-53`` — three divergent producers of the same namespace).

Design:
- one dataclass with every CLI flag of the reference's ``main.py`` plus every
  derived dataset attribute the eval CLIs depend on (the ``hparams.json``
  contract of ``gan/utils/utils.py:72-84``),
- ``save()`` persists the full superset to ``<output_dir>/hparams.json``,
- ``load()`` fills only *unset* fields so eval-CLI flags win, matching the
  semantics of the reference's ``load_hparams`` (``utils.py:78-84``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

# Fields that are tuples on the python side but lists in JSON.
_TUPLE_FIELDS = ("signal_shape", "spike_shape", "noise_shape")


@dataclass
class Config:
    """Full configuration: CLI flags + derived dataset/runtime attributes."""

    # --- CLI flags (parity with reference main.py:227-262) ---
    input_dir: str = "dataset/tfrecords"
    output_dir: str = "runs"
    batch_size: int = 64
    num_units: int = 32
    kernel_size: int = 24
    strides: int = 2
    m: int = 2  # phase shuffle temporal shift
    n: int = 2  # phase shuffle neuron shift (2d model)
    epochs: int = 20
    dropout: float = 0.2
    learning_rate: float = 1e-4
    noise_dim: int = 32
    gradient_penalty: float = 10.0
    model: str = "calciumgan"
    activation: str = "leakyrelu"
    batch_norm: bool = False
    layer_norm: bool = False
    algorithm: str = "wgan-gp"
    n_critic: int = 5
    # unroll the critic loop into the XLA graph instead of a lax.scan:
    # identical math; XLA can schedule across iterations and its cost
    # analysis counts every iteration (a scan body is counted once, which
    # understates FLOPs/MFU n_critic-fold). Costs ~n_critic x compile time.
    unroll_critic: bool = False
    # generator-EMA decay per generator update (0 = off): eval/generate use
    # an exponential moving average of the generator params, smoothing the
    # adversarial oscillation that shows up as post-optimum KL rebounds.
    # Typical value 0.999.
    ema: float = 0.0
    clear_output_dir: bool = False
    save_generated: str = ""  # "", "last", "all"
    plot_weights: bool = False
    skip_checkpoints: bool = False
    mixed_precision: bool = False
    profile: bool = False
    dpi: int = 120
    verbose: int = 1

    # --- additions to the reference's flags ---
    seed: int = 1234
    # Data-parallel mesh size; -1 means "all visible devices".
    data_parallelism: int = -1
    # Model-parallel mesh size (shards the large dense layers; 1 = off).
    model_parallelism: int = 1
    # Sequence/context-parallel mesh size: shards the TIME axis over a
    # 'time' mesh axis via ppermute halo exchanges (1 = off; wgan-gp +
    # calciumgan + layer_norm only — parallel/long_context.py).
    time_parallelism: int = 1
    # Multi-slice: outer 'slice' mesh axis over contiguous device blocks,
    # data-parallel only (1 = single slice; see parallel/mesh.py
    # create_mesh).
    dcn_slices: int = 1
    # Checkpoint cadence in epochs (reference hard-codes 10, main.py:141).
    checkpoint_every: int = 10
    # Stage the train/validation signals on device once and gather batches
    # in-graph ('auto': single process + accelerator backend + fits the MB
    # budget), instead of uploading every batch (data/pipeline.py:
    # DeviceStore). The 4096 MB budget predates 80 GB cards and was never
    # sized for them.
    device_store: str = "auto"
    device_store_mb: int = 4096

    # --- runtime state ---
    global_step: int = 0
    start_epoch: int = 0
    surrogate_ds: bool = False

    # --- evaluation CLI flags (compute_metrics.py:549-571) ---
    num_processors: int = 6   # unused: metrics run on-device
    all_epochs: bool = False
    num_neuron_plots: int = 6
    num_trial_plots: int = 6
    plots_per_row: int = 3
    format: str = "pdf"
    # runtime selections made by the eval CLIs
    num_samples: Optional[int] = None
    neurons: Optional[List[int]] = None
    trials: Optional[List[int]] = None
    # compute_dg_metrics.py flags (reference :204-216)
    num_trials: int = 5
    save_plots: bool = False

    # --- derived dataset attributes (dataset_helper.py:113-144) ---
    train_size: Optional[int] = None
    validation_size: Optional[int] = None
    signal_shape: Optional[Tuple[int, ...]] = None
    spike_shape: Optional[Tuple[int, ...]] = None
    sequence_length: Optional[int] = None
    num_neurons: Optional[int] = None
    num_channels: Optional[int] = None
    num_train_shards: Optional[int] = None
    num_validation_shards: Optional[int] = None
    buffer_size: Optional[int] = None
    normalize: bool = False
    fft: bool = False
    conv2d: bool = False
    # fft min-max statistics: "global" (reference semantics — one scalar
    # pair over all coefficients) or "per_channel" (one pair per
    # coefficient position; see data/segments.py:preprocess)
    fft_norm: str = "global"
    # scalars under global norm; (signal_shape)-shaped float32 arrays under
    # per-channel fft norm (arrays round-trip hparams.json as nested lists
    # and are re-coerced by load())
    signals_min: Optional[Any] = None
    signals_max: Optional[Any] = None
    noise_shape: Optional[Tuple[int, ...]] = None
    train_steps: Optional[int] = None
    validation_steps: Optional[int] = None
    train_files: Optional[str] = None
    validation_files: Optional[str] = None

    # --- paths and bookkeeping (main.py:190, utils.py:93-152) ---
    focus_neurons: List[int] = field(
        default_factory=lambda: [87, 58, 90, 39, 7, 60, 14, 5, 13])
    generated_dir: Optional[str] = None
    validation_cache: Optional[str] = None
    ckpt_dir: Optional[str] = None
    git_hash: Optional[str] = None

    # Extra keys from loaded hparams.json that are not dataclass fields.
    extras: dict = field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    def __post_init__(self):
        for name in _TUPLE_FIELDS:
            v = getattr(self, name)
            if isinstance(v, list):
                setattr(self, name, tuple(v))
        # Field names the user explicitly passed on a CLI (populated by
        # from_args); load() never clobbers these. Not a dataclass field so
        # it stays out of hparams.json.
        self._explicit: set = set()

    # ------------------------------------------------------------------
    @classmethod
    def from_args(cls, args: Any) -> "Config":
        """Build a Config from an argparse Namespace (unknown keys -> extras).

        With a parser whose defaults are ``argparse.SUPPRESS`` (the eval
        CLIs), ``vars(args)`` holds exactly the flags the user typed; those
        are recorded so :meth:`load` can honor "eval flags always win" even
        when the typed value equals the default
        (reference contract: ``gan/utils/utils.py:78-84``)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs, extras = {}, {}
        for key, value in vars(args).items():
            if key in names:
                kwargs[key] = value
            else:
                extras[key] = value
        cfg = cls(**kwargs)
        cfg.extras.update(extras)
        cfg._explicit = set(vars(args).keys())
        return cfg

    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        extras = d.pop("extras", {})
        d.update(extras)
        return d

    def save(self, path: Optional[str] = None) -> None:
        """Persist to ``<output_dir>/hparams.json`` (superset contract).

        Multi-host: process 0 is the single writer (all processes hold the
        same config); the write is atomic so eval CLIs never read a torn
        file. Must run after ``jax.distributed.initialize()`` on multi-host
        or every process believes it is process 0 and all of them write
        (the atomic replace makes that benign but wasteful)."""
        import jax
        # populate on every process so in-memory configs agree, THEN gate
        # the write on chief-ness
        if self.git_hash is None:
            self.git_hash = _git_hash()
        if jax.process_index() != 0:
            return
        path = path or os.path.join(self.output_dir, "hparams.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=_json_default)
        os.replace(tmp, path)

    def load(self, path: Optional[str] = None) -> "Config":
        """Fill *unset* (None) fields from a saved hparams.json.

        Mirrors the reference's ``load_hparams`` which only sets attributes
        the eval CLI did not already provide (``utils.py:78-84``): fields
        recorded in ``_explicit`` (typed on the CLI — from_args with
        SUPPRESS-default parsers) are never overwritten, even when the typed
        value equals the dataclass default. Other fields are filled when
        still None or still holding the dataclass default.
        """
        path = path or os.path.join(self.output_dir, "hparams.json")
        with open(path) as f:
            content = json.load(f)
        defaults = {f.name: f.default for f in dataclasses.fields(type(self))
                    if f.default is not dataclasses.MISSING}
        names = {f.name for f in dataclasses.fields(type(self))}
        explicit = getattr(self, "_explicit", set())
        for key, value in content.items():
            if key == "extras":
                continue
            if key not in names:
                self.extras[key] = value
                continue
            if key in explicit:
                continue
            current = getattr(self, key)
            is_default = key in defaults and _safe_eq(current, defaults[key])
            if current is None or is_default:
                if key in _TUPLE_FIELDS and isinstance(value, list):
                    value = tuple(value)
                if (key in ("signals_min", "signals_max")
                        and isinstance(value, list)):
                    # per-channel fft norm: JSON nested lists -> arrays
                    import numpy as np
                    value = np.asarray(value, np.float32)
                setattr(self, key, value)
        return self

    # ------------------------------------------------------------------
    @property
    def dtype_name(self) -> str:
        return "bfloat16" if self.mixed_precision else "float32"

    def validate_model_shapes(self) -> None:
        """Reference asserts sequence_length % strides**5 == 0
        (``gan/models/calciumgan.py:15-19``, ``models/utils.py:28-34``)."""
        if self.sequence_length is None:
            raise ValueError("sequence_length is unset; load a dataset first")
        if self.model in ("calciumgan", "calciumgan2d"):
            w = self.sequence_length / (self.strides ** 5)
            if not float(w).is_integer():
                raise ValueError(
                    f"sequence_length {self.sequence_length} is not divisible "
                    f"by strides**5 ({self.strides ** 5}): w={w}")


def _safe_eq(a, b) -> bool:
    """Scalar equality that never raises on array-valued fields."""
    try:
        return bool(a == b)
    except (ValueError, TypeError):
        return False


def _git_hash() -> str:
    try:
        return subprocess.check_output(
            ["git", "describe", "--always"],
            stderr=subprocess.DEVNULL).strip().decode()
    except Exception:
        return "unknown"


def _json_default(obj):
    """Coerce numpy scalars and other exotic types for json.dump."""
    try:
        import numpy as np
        if isinstance(obj, np.generic):
            return obj.item()
        if isinstance(obj, np.ndarray):
            return obj.tolist()
    except ImportError:
        pass
    return str(obj)
