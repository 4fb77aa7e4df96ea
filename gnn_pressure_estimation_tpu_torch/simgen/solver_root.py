"""Independent hydraulic engine: dense Newton root-finder (scipy.optimize).

A third solution engine from a *different algorithm class* than the two GGA
implementations (``solver_py`` and ``solver/hydraulic.cpp``): the steady-state
problem is posed as one nonlinear system F(z) = 0 over

    z = [H_junction (nj unknowns), q_link (L unknowns)]

with F = [junction mass balance; per-link energy/control equation] and handed
to ``scipy.optimize.root`` (Powell hybrid — dense quasi-Newton with a
numerically estimated Jacobian). Nothing of the GGA structure is reused: no
inverse-gradient linearization, no junction-head Schur system, no y/p flow
update — so an algorithmic bug shared by the two GGA codes cannot reproduce
here. The physics terms come from :mod:`solver_certify` (direct evaluations
of the published headloss/pump/valve formulas).

Link *statuses* are taken as an input (the combinatorial part of EPANET's
solve — which valves are ACTIVE vs OPEN, which check valves closed — is a
discrete decision this continuous engine does not re-make). The intended use
is oracle diversification: take the statuses a primary solver decided, then
verify its continuous solution by re-solving the physics independently
(``tests/test_solver_oracle.py``). Reference semantics:
generator/EPYNET/Executorv7.py:325-347 (EN_runH single-period solve).

A copy of ``gnn_pressure_estimation_tpu/simgen/solver_root.py`` on the
port's ``solver_certify`` and ``solver_py.SolverResult``. The dense Newton
step estimates its Jacobian numerically, one residual evaluation a column
over nj + L unknowns, so it suits networks of tens of links (minitown), not
thousands (bigtown).
"""

from __future__ import annotations

import numpy as np
from scipy import optimize

from gnn_pressure_estimation_tpu_torch.simgen import solver_certify as C
from gnn_pressure_estimation_tpu_torch.simgen.network_state import (
    ACTIVE,
    CLOSED,
    NetworkState,
)
from gnn_pressure_estimation_tpu_torch.simgen.solver_py import SolverResult

PRV, PSV, PBV, FCV, TCV, GPV = range(6)


def _link_equation(ns: NetworkState, li: int, st: int, head, q: float) -> float:
    """Residual of link li's defining equation (ft)."""
    n1, n2 = ns.node1[li], ns.node2[li]
    dh = float(head[n1] - head[n2])
    lt = int(ns.link_type[li])
    if st == CLOSED:
        return q  # q = 0
    if lt == 0:  # pipe: dh − h(q) = 0  (h = sign(q)·r·|q|^a is C¹ at q=0)
        return dh - C.pipe_headloss(ns, li, q)
    if lt == 1:  # pump: dh + gain(q) = 0
        return dh + C.pump_gain(ns, li, max(q, 1e-6))
    vt = int(ns.valve_type[li])
    if st == ACTIVE and vt == PRV:
        return float(head[n2]) - (ns.elevation[n2] + ns.valve_setting[li])
    if st == ACTIVE and vt == PSV:
        return float(head[n1]) - (ns.elevation[n1] + ns.valve_setting[li])
    if st == ACTIVE and vt == PBV:
        return dh - ns.valve_setting[li]
    if st == ACTIVE and vt == FCV:
        return q - ns.valve_setting[li]
    K = ns.valve_setting[li] if (vt == TCV and st == ACTIVE) else ns.minor_loss[li]
    return dh - C.valve_loss(ns, li, q, K)


def solve(
    ns: NetworkState,
    status: np.ndarray,
    tol: float = 1e-10,
) -> SolverResult:
    """Solve heads/flows for the given link statuses. Raises if the
    root-finder does not converge."""
    nj = ns.n_junctions
    L = len(ns.link_type)
    n1, n2 = ns.node1, ns.node2
    status = np.asarray(status, np.int32)

    def residuals(z):
        head = np.concatenate([z[:nj], ns.fixed_head[nj:]])
        q = z[nj:]
        # junction mass balance
        net = np.zeros(ns.n_nodes)
        np.add.at(net, n2, q)
        np.add.at(net, n1, -q)
        F = np.empty(nj + L)
        F[:nj] = net[:nj] - ns.demand[:nj]
        for li in range(L):
            F[nj + li] = _link_equation(ns, li, int(status[li]), head, float(q[li]))
        return F

    # initial guess: junction heads near the fixed-head mean, small flows in
    # the pipe direction; pumps start near their curve reference flow
    h0 = float(np.mean(ns.fixed_head[nj:])) if ns.n_nodes > nj else 50.0
    z0 = np.empty(nj + L)
    z0[:nj] = h0
    z0[nj:] = 0.1
    for li in np.where(ns.link_type == 1)[0]:
        if ns.pump_r[li] > 0 and ns.pump_h0[li] > 0:
            z0[nj + li] = (ns.pump_h0[li] / (4 * ns.pump_r[li])) ** (1 / ns.pump_n[li])
    z0[nj:][status == CLOSED] = 0.0

    sol = optimize.root(residuals, z0, method="hybr", tol=tol)
    if not sol.success:
        # one Levenberg-Marquardt retry from the hybr iterate (robust to the
        # mild nonsmoothness at q≈0)
        sol = optimize.root(residuals, sol.x, method="lm", tol=tol)
    resid = float(np.max(np.abs(residuals(sol.x))))
    if not sol.success and resid > 1e-6:
        raise RuntimeError(f"root engine did not converge (max residual {resid:.3g})")

    head = np.concatenate([sol.x[:nj], ns.fixed_head[nj:]])
    return SolverResult(
        head=head,
        flow=sol.x[nj:].copy(),
        status=status.copy(),
        warn_code=0,
        converged=True,
        iterations=int(sol.nfev),
    )
