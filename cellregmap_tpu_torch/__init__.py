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
gene at its own null's best rho).  ``ScanConfig(dtype="float32")`` runs
the interaction scans in the float32 context (f32 instantiations of K1-K4
and K6a, K5 on f32 operands), and the screen -> confirm scans
(``run_interaction_screen``) screen every variant there and re-test the
hits in float64.  Every scan takes ``checkpoint=`` (the gene-batched
screen aside, as in the JAX package).  ``plink_scan`` streams variant
blocks from PLINK filesets through the scans (with a CLI,
``python -m cellregmap_tpu_torch.plink_scan``), and ``ops.lowrank`` holds
the reference's low-rank covariance shims (``QSCov``, ``PMat``,
``ScoreStatistic``, ``economic_qs``).  Everything else is torch on the
same device.  The port imports neither jax nor the JAX package.
"""
from ._config import DEFAULT_CONFIG, ScanConfig
from ._types import Term
from .api import (CellRegMap, estimate_betas, get_L_values, run_association,
                  run_association_fast, run_association_fast_multigene,
                  run_association_multigene, run_interaction,
                  run_interaction_multigene, run_interaction_screen)
from .models.pvalues import (davies_pvalue, liu_sf, lrt_pvalues, qmin,
                             saddlepoint_sf, score_statistic_liu_params)
from .plink_scan import scan_interaction_plink
from .sim import (Simulation, Variances, create_variances, sample_phenotype,
                  sample_phenotype_gxe)
from .utils.maf import compute_maf

__version__ = "0.1.0"

__all__ = ["CellRegMap", "DEFAULT_CONFIG", "ScanConfig", "Simulation",
           "Term", "Variances", "compute_maf", "create_variances",
           "davies_pvalue", "estimate_betas", "get_L_values", "liu_sf",
           "lrt_pvalues", "qmin", "run_association", "run_association_fast",
           "run_association_fast_multigene", "run_association_multigene",
           "run_interaction", "run_interaction_multigene",
           "run_interaction_screen", "sample_phenotype",
           "sample_phenotype_gxe", "saddlepoint_sf", "scan_interaction_plink",
           "score_statistic_liu_params", "__version__"]
