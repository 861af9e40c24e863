"""Hand-written CUDA kernels of the interaction scan, the association tests
and the effect sizes, with their plain torch versions.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); it counts its launches in the
module-level integer ``launches``, and those of its float32 context's
instantiation in ``launches_f32`` too (:func:`launch_counts_f32`).
"""
from __future__ import annotations

from . import (best_rho_rotate, delta_grid, fast_scan, kr_contract,
               mixture_tails, null_fit, reml_newton, score_core, sym_eigvalsh,
               woodbury_family)

MODULES = {"kr_contract": kr_contract, "delta_grid": delta_grid,
           "reml_newton": reml_newton, "best_rho_rotate": best_rho_rotate,
           "score_core": score_core, "null_fit": null_fit,
           "fast_scan": fast_scan, "woodbury_family": woodbury_family,
           "sym_eigvalsh": sym_eigvalsh, "mixture_tails": mixture_tails}


# the modules with a float32-context instantiation
F32_MODULES = ("kr_contract", "delta_grid", "reml_newton", "best_rho_rotate",
               "score_core", "sym_eigvalsh", "null_fit", "fast_scan",
               "woodbury_family")


def reset_launches() -> None:
    for mod in MODULES.values():
        mod.launches = 0
    for name in F32_MODULES:
        MODULES[name].launches_f32 = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}


def launch_counts_f32() -> dict:
    """Of :func:`launch_counts`, the float32 context's instantiations'."""
    return {name: MODULES[name].launches_f32 for name in F32_MODULES}
