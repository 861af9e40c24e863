"""cellregmap_tpu_torch: CellRegMap's interaction scan, association tests
and effect sizes in PyTorch + CUDA.

A port of ``cellregmap_tpu`` (JAX) to PyTorch on an NVIDIA H100.  The
Khatri-Rao contraction (K1), the delta grid (K2), the REML/ML Newton
stages (K3), the best-rho score-factor rotation (K4), the score statistic
(K5), the mixture weights and device p-value tails (K6a, K6b), the fast
association scan (K8), the Woodbury family evaluator of the effect sizes
(K9) and the null fits over the rho grid (K10) are hand-written CUDA
kernels (``csrc/``), built with nvcc on first use; the association refit
(K7) runs the K2 and K3 kernels with the ML objective, the
gene-batched interaction scan runs K2-K6 with a gene axis, and the
gene-batched association scans run K10, K8 and K7 with a gene axis (each
gene at its own null's best rho).  Every scan takes ``checkpoint=``.
Everything else is torch on the same device.  The port imports neither jax
nor the JAX package.
"""
from ._config import DEFAULT_CONFIG, ScanConfig
from .api import (CellRegMap, estimate_betas, get_L_values, run_association,
                  run_association_fast, run_association_fast_multigene,
                  run_association_multigene, run_interaction,
                  run_interaction_multigene)
from .utils.maf import compute_maf

__all__ = ["CellRegMap", "DEFAULT_CONFIG", "ScanConfig", "compute_maf",
           "estimate_betas", "get_L_values", "run_association",
           "run_association_fast", "run_association_fast_multigene",
           "run_association_multigene", "run_interaction",
           "run_interaction_multigene"]
