"""cellregmap_tpu_torch: CellRegMap's interaction scan in PyTorch + CUDA.

A port of ``cellregmap_tpu`` (JAX) to PyTorch on an NVIDIA H100.  The
Khatri-Rao contraction (K1), the best-rho score-factor rotation (K4) and
the score statistic (K5) are hand-written CUDA kernels (``csrc/``), built
with nvcc on first use; everything else is torch on the same device.  The
port imports neither jax nor the JAX package.
"""
from ._config import DEFAULT_CONFIG, ScanConfig
from .api import CellRegMap, get_L_values, run_interaction

__all__ = ["CellRegMap", "DEFAULT_CONFIG", "ScanConfig", "get_L_values",
           "run_interaction"]
