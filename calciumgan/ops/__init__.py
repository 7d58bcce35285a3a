"""On-device compute (JAX/XLA, and a CUDA kernel for OASIS) for CalciumGAN.

These replace the reference's external native/CPU dependencies:
- ``oasis``: OASIS AR(1) spike deconvolution (reference used the Cython
  ``oasis.oasis_methods.oasisAR1`` — ``gan/utils/spike_helper.py:5,28``).
- ``spike_metrics``: firing rate / binned correlation / covariance /
  van Rossum / Victor-Purpura (reference used Elephant+Neo on a CPU
  multiprocessing pool — ``gan/utils/spike_metrics.py``).
- ``signal_metrics``: train-time signal fidelity metrics
  (``gan/utils/signals_metrics.py``).
- ``phase_shuffle``: WaveGAN phase shuffle as a pure function of a PRNG key
  (``gan/models/calciumgan.py:106-138``).
"""
