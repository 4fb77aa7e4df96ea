"""Single-period demand-driven hydraulic solver — NumPy reference.

The Global Gradient Algorithm (Todini & Pilati 1988), the same method EPANET's
``EN_runH`` executes for one hydraulic step (the reference's hot call,
Executorv7.py:325-347). Internal units are EPANET's (feet, cfs) so the
resistance constants (4.727 Hazen-Williams, 0.02517 minor-loss, 2g = 64.4)
match EPANET's hydcoeffs.c at formula level.

Per Newton iteration, each link contributes an inverse headloss gradient
``p = 1/(dh/dq)`` and a correction ``y = p·h(q)``; the junction-head system

    A_ii = Σ p,  A_ij = −p,
    F_i  = Σ s·(q − y) − D_i + Σ p·H_fixed

is solved sparsely (SciPy spsolve), then flows update as
``q ← (q − y) + p·(H_a − H_b)``. Valve/check-valve/pump statuses are
re-evaluated every iteration (EPANET valvestatus/linkstatus semantics);
convergence = Σ|Δq|/Σ|q| < accuracy with no status flips.

This is both the correctness oracle for the C++ component
(simgen/solver/hydraulic.cpp) and the always-available fallback.

A copy of ``gnn_pressure_estimation_tpu/simgen/solver_py.py``, kept here so
the PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from gnn_pressure_estimation_tpu_torch.simgen.network_state import (
    ACTIVE,
    CLOSED,
    OPEN,
    NetworkState,
)

CBIG = 1e8
CSMALL = 1e-6
RQTOL = 1e-7       # minimum headloss gradient (EPANET hyd->RQtol)
QTOL = 1e-4        # flow tolerance for status checks (cfs)
HTOL = 5e-4        # head tolerance for status checks (ft)
TINY = 1e-6
HW_EXP = 1.852
GRAV2 = 64.4       # 2g in ft/s^2 (EPANET constant)

PRV, PSV, PBV, FCV, TCV, GPV = range(6)


@dataclasses.dataclass
class SolverResult:
    head: np.ndarray        # [n_nodes] hydraulic grade, ft
    flow: np.ndarray        # [n_links] signed node1→node2, cfs
    status: np.ndarray      # [n_links] final statuses
    warn_code: int          # 0 ok; 1 unbalanced; 3 disconnected/ill-posed
    converged: bool
    iterations: int


def _pipe_resistance(ns: NetworkState, li: np.ndarray) -> np.ndarray:
    """Flow-independent resistance r for H-W / C-M; D-W base for friction
    factor application (EPANET resistcoeff)."""
    L, d, c = ns.length[li], np.maximum(ns.diameter[li], 1e-6), ns.roughness[li]
    hl = ns.headloss_model
    if hl == 0:    # Hazen-Williams: h = r q^1.852
        return 4.727 * L / np.maximum(c, 1e-6) ** HW_EXP / d**4.871
    if hl == 2:    # Chezy-Manning: h = r q^2 (c = Manning n)
        A = np.pi * d**2 / 4.0
        Rh = d / 4.0
        return L * (c / 1.49) ** 2 / (A**2 * Rh ** (4.0 / 3.0))
    # Darcy-Weisbach base: h = f * r_dw * q^2, r_dw = L/(2g d A^2)
    A = np.pi * d**2 / 4.0
    return L / (GRAV2 * d * A**2)


def _dw_friction(ns: NetworkState, li: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Friction factor: laminar 64/Re, Swamee-Jain turbulent, cubic
    interpolation in 2000<Re<4000 (EPANET DWcoeff structure)."""
    d = np.maximum(ns.diameter[li], 1e-6)
    e = ns.roughness[li]  # already ft
    Re = np.maximum(4.0 * np.abs(q) / (np.pi * d * ns.viscosity), 1.0)
    f_lam = 64.0 / Re
    with np.errstate(divide="ignore"):
        arg = e / (3.7 * d) + 5.74 / Re**0.9
        f_turb = 0.25 / np.log10(arg) ** 2
    # cubic blend between Re 2000 and 4000
    x = np.clip((Re - 2000.0) / 2000.0, 0.0, 1.0)
    blend = x * x * (3.0 - 2.0 * x)
    f_lo = 64.0 / 2000.0
    arg4 = e / (3.7 * d) + 5.74 / 4000.0**0.9
    f_hi = 0.25 / np.log10(arg4) ** 2
    f_trans = f_lo + blend * (f_hi - f_lo)
    f = np.where(Re < 2000.0, f_lam, np.where(Re > 4000.0, f_turb, f_trans))
    return f


def solve(ns: NetworkState, max_iter: int | None = None, accuracy: float | None = None) -> SolverResult:
    n, L = ns.n_nodes, len(ns.link_type)
    nj = ns.n_junctions
    max_iter = max_iter or ns.trials
    accuracy = accuracy or ns.accuracy

    is_junc = np.zeros(n, bool)
    is_junc[:nj] = True

    n1, n2 = ns.node1, ns.node2
    ltype = ns.link_type
    pipes = np.where(ltype == 0)[0]
    pumps = np.where(ltype == 1)[0]
    valves = np.where(ltype == 2)[0]

    # initial flows: 1 fps through the cross-section (EPANET inithyd)
    area = np.pi * np.maximum(ns.diameter, 1e-3) ** 2 / 4.0
    q = np.where(ltype == 1, np.maximum(ns.pump_speed, TINY) * 1.0, area * 1.0)
    for li in pumps:
        # design flow ~ q at bep: use curve reference flow if available
        if ns.pump_r[li] > 0 and ns.pump_n[li] > 0 and ns.pump_h0[li] > 0:
            qref = (ns.pump_h0[li] / (4.0 * ns.pump_r[li])) ** (1.0 / ns.pump_n[li])
            q[li] = max(qref, TINY)
        else:
            q[li] = max(area[li], TINY)

    status = ns.status.copy()
    # valves with a zero/unset setting behave as open (reference
    # Executorv7.py:270 treats setting 0 as unused)
    for li in valves:
        if status[li] == ACTIVE and ns.valve_type[li] in (PRV, PSV, PBV, FCV) \
                and ns.valve_setting[li] <= 0.0:
            status[li] = OPEN

    head = ns.fixed_head.copy()
    head[:nj] = ns.elevation[:nj] + 30.0  # warm guess

    r_pipe_all = np.zeros(L)
    if len(pipes):
        r_pipe_all[pipes] = _pipe_resistance(ns, pipes)
    m_minor = np.where(
        ns.diameter > 0, 0.02517 * ns.minor_loss / np.maximum(ns.diameter, 1e-6) ** 4, 0.0
    )

    warn = 0
    it = 0
    relerr = np.inf
    status_changed = True

    for it in range(1, max_iter + 1):
        p = np.zeros(L)
        y = np.zeros(L)
        # net imbalance per node with current flows (for PRV/PSV flow recovery)
        X = np.zeros(n)
        np.add.at(X, n2, q)
        np.add.at(X, n1, -q)
        X -= ns.demand

        absq = np.abs(q)

        # ---- pipes ----------------------------------------------------
        if len(pipes):
            qa = np.maximum(absq[pipes], TINY)
            if ns.headloss_model == 0:
                r = r_pipe_all[pipes]
                hl = r * qa**HW_EXP
                grad = HW_EXP * r * qa ** (HW_EXP - 1.0)
            elif ns.headloss_model == 2:
                r = r_pipe_all[pipes]
                hl = r * qa**2
                grad = 2.0 * r * qa
            else:
                f = _dw_friction(ns, pipes, q[pipes])
                r = f * r_pipe_all[pipes]
                hl = r * qa**2
                grad = 2.0 * r * qa
            ml = m_minor[pipes]
            hl = hl + ml * qa**2
            grad = grad + 2.0 * ml * qa
            grad = np.maximum(grad, RQTOL)
            pp = 1.0 / grad
            yy = pp * hl * np.sign(q[pipes])
            closed = status[pipes] == CLOSED
            p[pipes] = np.where(closed, 1.0 / CBIG, pp)
            y[pipes] = np.where(closed, q[pipes], yy)

        # ---- pumps ----------------------------------------------------
        for li in pumps:
            w = ns.pump_speed[li]
            if status[li] == CLOSED or w <= TINY:
                p[li] = 1.0 / CBIG
                y[li] = q[li]
                continue
            qa = max(q[li], TINY)
            if ns.pump_power[li] > 0:   # constant power: hGain = 8.814 hp / q
                hgain = 8.814 * ns.pump_power[li] / qa
                grad = 8.814 * ns.pump_power[li] / qa**2
                grad = min(grad, CBIG)
            else:
                h0 = ns.pump_h0[li] * w * w
                nn = ns.pump_n[li]
                rr = ns.pump_r[li] * w ** (2.0 - nn)
                hgain = h0 - rr * qa**nn
                grad = max(nn * rr * qa ** (nn - 1.0), RQTOL)
            p[li] = 1.0 / grad
            # link headloss = -gain
            y[li] = -hgain / grad

        # ---- valves ---------------------------------------------------
        prv_rows: list[tuple[int, float]] = []  # (node, hset)
        for li in valves:
            vt = ns.valve_type[li]
            st = status[li]
            if st == CLOSED:
                p[li] = 1.0 / CBIG
                y[li] = q[li]
                continue
            if st == ACTIVE and vt == PRV:
                hset = ns.elevation[n2[li]] + ns.valve_setting[li]
                p[li] = 0.0
                y[li] = X[n2[li]]        # q_new = q − y balances downstream
                prv_rows.append((n2[li], hset))
                continue
            if st == ACTIVE and vt == PSV:
                hset = ns.elevation[n1[li]] + ns.valve_setting[li]
                p[li] = 0.0
                y[li] = -X[n1[li]]
                prv_rows.append((n1[li], hset))
                continue
            if st == ACTIVE and vt == PBV:
                p[li] = CBIG
                y[li] = CBIG * ns.valve_setting[li]
                continue
            if st == ACTIVE and vt == FCV:
                # EPANET fcvcoeff: fixed-flow injection with a *tiny*
                # conductance (q_new = setting + dh/CBIG) rather than an
                # exact flow constraint — keeps junction continuity exact
                # even when the setting is infeasible against a fixed
                # demand (the head difference then blows up and warn 6 /
                # the pressure plausibility filters flag the scene)
                p[li] = 1.0 / CBIG
                y[li] = q[li] - ns.valve_setting[li]
                continue
            # OPEN valve (or TCV active = throttling loss, GPV ~ open):
            # h = m·q|q| with m from the loss coefficient; lossless open
            # valves fall back to a tiny linear resistance (EPANET CSMALL).
            # Known simplification: EPANET models an ACTIVE GPV through its
            # user-supplied headloss CURVE (EN hydraul.c gpvcoeff); curves
            # are not part of this framework's INP subset, so a GPV behaves
            # as an open valve with its minor-loss coefficient.
            K = ns.valve_setting[li] if (vt == TCV and st == ACTIVE) else ns.minor_loss[li]
            m = 0.02517 * K / max(ns.diameter[li], 1e-6) ** 4
            qa = max(absq[li], TINY)
            grad = max(2.0 * m * qa, CSMALL)
            p[li] = 1.0 / grad
            y[li] = (m * qa**2) * np.sign(q[li]) / grad

        # ---- assemble junction system --------------------------------
        rows, cols, vals = [], [], []
        qy = q - y
        # node balance contributions Σ s·(q−y), s = +1 into node2, −1 out of node1
        contrib = np.zeros(n)
        np.add.at(contrib, n2, qy)
        np.add.at(contrib, n1, -qy)
        F = contrib[:nj] - ns.demand[:nj]

        a_diag = np.zeros(nj)
        for li in range(L):
            a, b = n1[li], n2[li]
            pl = p[li]
            if pl == 0.0:
                continue
            ja, jb = a < nj, b < nj
            if ja:
                a_diag[a] += pl
                if jb:
                    rows.append(a); cols.append(b); vals.append(-pl)
                else:
                    F[a] += pl * head[b]
            if jb:
                a_diag[b] += pl
                if ja:
                    rows.append(b); cols.append(a); vals.append(-pl)
                else:
                    F[b] += pl * head[a]

        for node, hset in prv_rows:
            if node < nj:
                a_diag[node] += CBIG
                F[node] += CBIG * hset

        rows.extend(range(nj))
        cols.extend(range(nj))
        vals.extend(a_diag + 1e-12)

        A = sp.csc_matrix((vals, (rows, cols)), shape=(nj, nj))
        try:
            H = spla.spsolve(A, F)
        except Exception:
            return SolverResult(head, q, status, warn_code=110, converged=False, iterations=it)
        if not np.all(np.isfinite(H)):
            return SolverResult(head, q, status, warn_code=110, converged=False, iterations=it)
        head[:nj] = H

        # ---- flow update ---------------------------------------------
        dh = head[n1] - head[n2]
        q_new = qy + p * dh
        # FCV active exact, PRV/PSV recovered via y (p=0 handled naturally)
        dq = q_new - q
        denom = np.sum(np.abs(q_new))
        relerr = np.sum(np.abs(dq)) / max(denom, TINY)
        q = q_new

        # ---- status checks (EPANET linkstatus/valvestatus schedule) ----
        # Pumps/CVs every CheckFreq=2 iterations while it<=MaxCheck=10;
        # PRV/PSV every iteration while it<=MaxCheck; afterwards only once
        # the flow has converged (prevents parallel-pump flip-flop,
        # EPANET hydsolver.c hasconverged/statuschanged policy).
        MAXCHECK, CHECKFREQ = 10, 2
        flow_conv = relerr < accuracy
        check_links = (it <= MAXCHECK and it % CHECKFREQ == 0) or flow_conv
        check_valves = it <= MAXCHECK or flow_conv
        status_changed = False
        if not (check_links or check_valves):
            continue
        # check valves + pumps: close on reverse flow
        for li in (pipes if check_links else []):
            if ns.check_valve[li]:
                if status[li] == OPEN and (head[n1[li]] - head[n2[li]] < -HTOL or q[li] < -QTOL):
                    status[li] = CLOSED; q[li] = TINY; status_changed = True
                elif status[li] == CLOSED and head[n1[li]] - head[n2[li]] > HTOL:
                    status[li] = OPEN; q[li] = TINY; status_changed = True
        for li in (pumps if check_links else []):
            if ns.status[li] == CLOSED:
                continue  # user-closed stays closed
            w = ns.pump_speed[li]
            hmax = (ns.pump_h0[li] * w * w) if ns.pump_power[li] == 0 else CBIG
            dh_li = head[n1[li]] - head[n2[li]]
            if status[li] == OPEN and -dh_li > hmax + HTOL:
                status[li] = CLOSED; q[li] = TINY; status_changed = True
            elif status[li] == CLOSED and -dh_li < hmax - HTOL:
                status[li] = OPEN; q[li] = TINY; status_changed = True
        for li in (valves if check_valves else []):
            if ns.status[li] == CLOSED:
                continue
            vt = ns.valve_type[li]
            if vt == PRV and ns.valve_setting[li] > 0:
                hset = ns.elevation[n2[li]] + ns.valve_setting[li]
                h1, h2 = head[n1[li]], head[n2[li]]
                st = status[li]
                new = st
                if st == ACTIVE:
                    if q[li] < -QTOL:
                        new = CLOSED
                    elif h1 < hset - HTOL:
                        new = OPEN
                elif st == OPEN:
                    if q[li] < -QTOL:
                        new = CLOSED
                    elif h2 >= hset + HTOL:
                        new = ACTIVE
                else:  # CLOSED
                    if h1 >= hset + HTOL and h2 < hset - HTOL:
                        new = ACTIVE
                    elif h1 < hset - HTOL and h1 > h2 + HTOL:
                        new = OPEN
                if new != st:
                    status[li] = new
                    q[li] = TINY if new != CLOSED else TINY
                    status_changed = True
            elif vt == PSV and ns.valve_setting[li] > 0:
                hset = ns.elevation[n1[li]] + ns.valve_setting[li]
                h1, h2 = head[n1[li]], head[n2[li]]
                st = status[li]
                new = st
                if st == ACTIVE:
                    if q[li] < -QTOL:
                        new = CLOSED
                    elif h2 > hset + HTOL:
                        new = OPEN
                elif st == OPEN:
                    if q[li] < -QTOL:
                        new = CLOSED
                    elif h1 <= hset - HTOL:
                        new = ACTIVE
                else:
                    if h2 <= hset - HTOL and h1 > hset + HTOL:
                        new = ACTIVE
                    elif h2 > hset + HTOL and h1 > h2 + HTOL:
                        new = OPEN
                if new != st:
                    status[li] = new
                    q[li] = TINY
                    status_changed = True
            elif vt == FCV and status[li] == ACTIVE:
                # head must drop across an FCV; otherwise it can't deliver
                if head[n1[li]] < head[n2[li]] - HTOL:
                    status[li] = OPEN; status_changed = True

        if relerr < accuracy and not status_changed and it > 1:
            break

    converged = relerr < accuracy
    if not converged:
        warn = 1
    return SolverResult(
        head=head, flow=q, status=status, warn_code=warn, converged=converged,
        iterations=it,
    )
