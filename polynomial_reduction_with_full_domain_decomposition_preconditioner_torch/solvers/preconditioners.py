"""The preconditioner container of the outer solve.

Port of the JAX package's ``solvers/preconditioners.Preconditioner``
(the lighter Jacobi and p-multigrid preconditioners belong to a later
slice). A Preconditioner carries
  build(arrays, extra, ops) -> (r -> z),
  extra: the preconditioner's own tensors,
and the returned z must be continuous and masked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["Preconditioner"]


@dataclass
class Preconditioner:
    build: Callable[[Any, Any, tuple], Callable]
    extra: Any = None
