"""EbV LU decomposition — the paper's contribution, dense and banded.

Layers:
  * ``ebv``           — paper-faithful unblocked bi-vectorized LU + the
                        r ↔ n-2-r equalization schedule.
  * ``blocked``       — blocked (rank-k) LU and the plain version of the
                        fused CUDA factor.
  * ``solve``         — vectorized substitution phases + ``linear_solve``.
  * ``banded``        — the band LU and solves, scalar and blocked.
  * ``health``        — post-factor screening for the no-pivot contract.
  * ``pivoted``       — partial-pivoting last resort.
  * ``factorization`` — the ``Factorization`` artifact.
  * ``batched``       — the batched solvers (a leading batch axis).
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
from .banded import to_banded, from_banded, banded_lu, banded_solve, make_banded_dd
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
from .batched import (
    batched_ebv_lu,
    batched_lu_solve,
    batched_linear_solve,
    batched_linear_solve_many,
)

__all__ = [
    "ebv_lu", "ebv_step", "equalized_pairing", "pair_lengths", "fold_index",
    "unpack_lu", "reconstruct", "make_diagonally_dominant",
    "blocked_lu", "panel_factor", "ebv_folded_owners", "cyclic_owners",
    "to_banded", "from_banded", "banded_lu", "banded_solve", "make_banded_dd",
    "forward_substitution", "backward_substitution", "lu_solve", "linear_solve",
    "FactorHealth", "HealthThresholds", "DEFAULT_THRESHOLDS", "factor_health",
    "relative_residual", "PivotedFactors", "pivoted_lu", "pivoted_solve",
    "Factorization", "batched_ebv_lu", "batched_lu_solve", "batched_linear_solve",
    "batched_linear_solve_many",
]
