"""Hand-written CUDA kernels of the interaction scan, with their plain
torch versions.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor (or raises); it counts its launches in the
module-level integer ``launches``.
"""
from __future__ import annotations

from . import best_rho_rotate, kr_contract, score_core

MODULES = {"kr_contract": kr_contract, "best_rho_rotate": best_rho_rotate,
           "score_core": score_core}


def reset_launches() -> None:
    for mod in MODULES.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}
