"""PyTorch/CUDA port of ``gnn_pressure_estimation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference; this package mirrors its
module paths so each counterpart is easy to find:

- ``core``       — ``GraphTemplate`` (host) and the torch ``BatchedGraph``
- ``ops``        — band layout and mask index, plain band and dense-attention
  ops, hand-written CUDA kernels (``csrc/*.cu``, built at first use by
  ``ops/_build.py``)
- ``models``     — ``GATConv``, ``SimpleMeanConv``, ``GATRes``, presets
- ``data``       — INP parsing, the zarr-zip store and its codecs, template
  building, the snapshot dataset from zips or memory, its loader, the
  online-simulation (noisy) dataset (numpy only)
- ``simgen``     — the network generator and the hydraulic solver (NumPy, and
  C++ built with ``make`` at first use into ``_build/``)
- ``evaluation`` — the serving surface, ``Inferencer``; the multi-trial
  harness, ``Evaluator``, and its ``Timer``
- ``train``      — ``Trainer``, ``TrainConfig``, AutoClip, early stopping,
  checkpoints
- ``utils``      — scaling, node masks, metrics
- ``weights``    — carries JAX parameter trees and parity fixtures across

It imports ``torch``, numpy and scipy only — never JAX, Flax, Optax or the
JAX package. Entry points run on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
