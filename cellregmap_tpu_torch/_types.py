"""Shared enums (the port's own copy of ``cellregmap_tpu._types``; reference
cellregmap/_types.py:1-8)."""
from enum import Enum, auto


class Term(Enum):
    """How the environment enters the simulated phenotype."""

    FIXED = auto()
    RANDOM = auto()
