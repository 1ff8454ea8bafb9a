"""kgc_gcn_torch — the PyTorch/CUDA port of kgc_gcn_tpu for NVIDIA Hopper.

A second package beside the JAX one, with its file layout and names.  It
imports torch and numpy, never JAX and nothing of ``kgc_gcn_tpu``.  Its
relational aggregation runs through hand-written CUDA kernels on the card
(``csrc/``, ``ops/``); each kernel has a plain PyTorch version that the CPU
path and the tests use.
"""

from kgc_gcn_torch.config import Config, dataset_preset

__version__ = "0.1.0"

__all__ = ["Config", "dataset_preset", "__version__"]
