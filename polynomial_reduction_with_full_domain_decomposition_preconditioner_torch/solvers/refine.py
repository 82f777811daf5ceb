"""Mixed-precision iterative refinement to double-precision accuracy.

Port of the JAX package's ``solvers/refine.py``: the fast f32 solver
(with its bf16 preconditioner) is the correction engine; residuals and
the solution accumulate in float64 on the same device (native f64 on the
H100), and the criterion is the f64 relative residual.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["RefinedResult", "refine_solve"]


@dataclass
class RefinedResult:
    u: torch.Tensor               # f64 solution
    rel_residual: float           # final f64 relative residual
    cycles: int                   # refinement cycles run
    inner_iterations: int         # total f32 Krylov iterations
    history: list                 # f64 relative residual per cycle
    converged: bool


def refine_solve(dom64, solve32, f64, *, tolerance: float = 1.0e-7,
                 max_cycles: int = 10) -> RefinedResult:
    """Solve A u = f to ``tolerance`` RELATIVE f64 residual.

    dom64: a float64 Domain on the same partition as the f32 domain.
    solve32: the f32 solve function (Domain.solver output) used as the
      correction solver each cycle.
    f64: float64 right-hand side field.
    """
    u = torch.zeros_like(f64)
    _, f_norm = dom64.residual(u, f64)
    f_norm = float(f_norm)
    if f_norm == 0.0:
        return RefinedResult(u=u, rel_residual=0.0, cycles=0,
                             inner_iterations=0, history=[0.0],
                             converged=True)
    history = []
    inner_total = 0
    for cycle in range(max_cycles):
        r, rn = dom64.residual(u, f64)
        rel = float(rn) / f_norm
        history.append(rel)
        if rel < tolerance:
            return RefinedResult(u=u, rel_residual=rel, cycles=cycle,
                                 inner_iterations=inner_total,
                                 history=history, converged=True)
        res = solve32(r.to(torch.float32))
        inner_total += int(res.iterations)
        u = u + res.u.to(torch.float64)
    r, rn = dom64.residual(u, f64)
    rel = float(rn) / f_norm
    history.append(rel)
    return RefinedResult(u=u, rel_residual=rel, cycles=max_cycles,
                         inner_iterations=inner_total, history=history,
                         converged=rel < tolerance)
