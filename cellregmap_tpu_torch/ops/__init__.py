"""Subpackage of the PyTorch port."""
from .lowrank import (PMat, QSCov, ScoreStatistic, economic_qs,
                      economic_qs_linear)

__all__ = ["PMat", "QSCov", "ScoreStatistic", "economic_qs",
           "economic_qs_linear"]
