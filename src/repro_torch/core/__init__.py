"""EbV LU decomposition — the paper's contribution, dense slice of the port.

Layers:
  * ``ebv``           — paper-faithful unblocked bi-vectorized LU + the
                        r ↔ n-2-r equalization schedule.
  * ``blocked``       — blocked (rank-k) LU and the plain version of the
                        fused CUDA factor.
  * ``solve``         — vectorized substitution phases + ``linear_solve``.
  * ``health``        — post-factor screening for the no-pivot contract.
  * ``pivoted``       — partial-pivoting last resort.
  * ``factorization`` — the ``Factorization`` artifact.
"""
from .ebv import (
    ebv_lu,
    ebv_step,
    equalized_pairing,
    pair_lengths,
    fold_index,
    unpack_lu,
    reconstruct,
    make_diagonally_dominant,
)
from .blocked import blocked_lu, panel_factor, ebv_folded_owners, cyclic_owners
from .solve import forward_substitution, backward_substitution, lu_solve, linear_solve
from .health import (
    DEFAULT_THRESHOLDS,
    FactorHealth,
    HealthThresholds,
    factor_health,
    relative_residual,
)
from .pivoted import PivotedFactors, pivoted_lu, pivoted_solve
from .factorization import Factorization

__all__ = [
    "ebv_lu", "ebv_step", "equalized_pairing", "pair_lengths", "fold_index",
    "unpack_lu", "reconstruct", "make_diagonally_dominant",
    "blocked_lu", "panel_factor", "ebv_folded_owners", "cyclic_owners",
    "forward_substitution", "backward_substitution", "lu_solve", "linear_solve",
    "FactorHealth", "HealthThresholds", "DEFAULT_THRESHOLDS", "factor_health",
    "relative_residual", "PivotedFactors", "pivoted_lu", "pivoted_solve",
    "Factorization",
]
