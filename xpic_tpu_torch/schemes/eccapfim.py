"""eccapfim: fully implicit, energy- and charge-conserving scheme
(counterpart of ``xpic_tpu/schemes/eccapfim.py``).

Reference: src/impls/eccapfim/{simulation,particles}.cpp.  Each step
solves the nonlinear Maxwell system over E^{n+1/2} (the SNES NGMRES
solve, eccapfim/simulation.cpp:69-104) where every residual evaluation
re-integrates all particles from their start-of-step state with a
Crank-Nicolson Picard iteration and deposits the path-averaged current
(form_iteration, eccapfim/particles.cpp:30-180):

    F(E_h) = E_h + dt^2/4 curl-(curl+(E_h)) - E^n
             + dt/2 J(E_h) - dt/2 curl-(B^n)

After convergence: E^{n+1} = 2 sol - E^n, B^{n+1} = B^n - dt curl+(sol).

The particle sweep:
* particles stay binned by their start-of-step cell for the whole step
  (the ``previous_storage`` analog, eccapfim/particles.h:28-30);
* the fields are gathered into per-cell 6^3 window blocks once per
  residual evaluation; the Picard loop contracts weights against the
  blocks (no grid access inside the loop).  On the card the 4-segment
  path average runs in the ``segment_fields`` kernel
  (``ops/segment_kernel.py``);
* the reference's per-particle cell-traversal while loop
  (cell_traversal.cpp) becomes a fixed 4-segment path split, exact while
  the per-axis displacement stays below one cell (the reference's own
  CFL guard assumes it, simulation.tpp:68-77); a larger move raises;
* positions stay unwrapped during the step and wrap once at its end.

Host synchronisations: one per Picard iteration (the loop's exit test),
three scalars per Anderson iteration, and one read of the solve's
statistics per step.

Nonlinear solver: Anderson mixing (the algorithmic core of NGMRES) with
atol=rtol=1e-7 over the preconditioned residual (eccapfim/simulation.h:
14-24).
"""

from __future__ import annotations

import logging
import math
import time

import torch

from ..config import Geometry
from ..ops.binning import BinnedState, migrate_checked
from ..ops.gather_scatter import cell_t
from ..ops.implicit_esirkepov import (
    MAXSEG,
    _axis_map,
    _axis_weights_E,
    _component_weights,
    _contract,
    deposit_J_implicit,
    gather_B_implicit,
    gather_E_implicit,
    gather_window_blocks,
    scatter_blocks,
    split_segments,
)
from ..ops.segment_kernel import segment_fields
from ..ops.stencil import curl_negative, curl_positive
from ..solvers import anderson_solve
from ..solvers.spectral import make_matM_preconditioner
from .base import Simulation

log = logging.getLogger("xpic")

ATOL = 1e-7
RTOL = 1e-7
MAXIT = 1000
CN_MAXIT = 30
CN_TOL = 0.5 * ATOL
# float32 cannot reach the reference's float64 budgets; it solves to the
# dtype's achievable floor instead.  The outer criterion is RMS per dof
# (the L2 norm grows with sqrt(n), and the float32 deposit/sweep
# roundoff floor grows with it).
ATOL_F32 = 1e-5  # per sqrt(dof)
# Per-particle Picard floor in float32: a small tail of particles near
# field nodes stalls around 1e-5 under the float32 gather jitter.
CN_TOL_F32 = 2e-5
# Classifier cushion (grid units) of the crosser fast path, added to the
# physical bound of how far a Picard iterate can drift from the
# start-of-step estimate.
CROSS_CUSHION = 2e-3


def _pick_kc(K: int) -> int:
    """Crosser-slot width of the fast path: ~K/3 bounds the per-cell
    crosser count with a Poisson-tail margin at a few-% crossing rate;
    rows narrower than 12 slots gain nothing over the general path."""
    if K < 12:
        return 0
    return max(8, K // 3)


def _segment_fields(Eblk, Bblk, t0, tn):
    """Path-averaged (E, B) over the cell-crossing segments
    (eccapfim/particles.cpp:104-124): the ``segment_fields`` kernel on
    the card, its plain twin on the CPU."""
    return segment_fields(Eblk, Bblk, t0, tn)


def _rest_fields(Eblk, Bblk, t0):
    """Zero-displacement specialization of :func:`_segment_fields`: at
    tn == t0 there is one segment and the two E terms coincide (sn ==
    s0, so the combination weights are both 3 S2), collapsing the gather
    to three contractions.  Equal to ``_segment_fields(Eblk, Bblk, t0,
    t0)`` up to float reassociation."""
    sh, sn, _s0 = _axis_weights_E(t0, t0)
    comps = []
    for cx in range(3):
        cy, cz, w_sh, (sny, A), _ = _component_weights(cx, sh, sn, sn)
        # term1 == term2, A == 3 S2[cz]: E = 2 * contract(sh, sn, 3 sn)
        comps.append(2.0 * _contract(
            Eblk[:, cx], _axis_map(cx, cy, cz, w_sh, sny, A), first=cx))
    return torch.stack(comps, dim=-1), gather_B_implicit(Bblk, t0)


def _one_segment_fields(Eblk, Bblk, t0, tn):
    """Collapsed :func:`_segment_fields` for moves that cross no
    node-cell face: one full-length segment (the other three segments of
    the general path are zero-length and contribute exactly zero)."""
    E_p = gather_E_implicit(Eblk, t0, tn)
    B_p = gather_B_implicit(Bblk, 0.5 * (t0 + tn))
    return E_p, B_p


def _take(x, order):
    """x [G, K(, 3)] with each cell row permuted by ``order`` [G, K]."""
    if x.ndim == 2:
        return torch.gather(x, 1, order)
    return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))


def _cn_sweep(Eblk, Bblk, t0, p0, valid, dt, qm, d_steps, kc=0, rest=None):
    """Masked Crank-Nicolson Picard iteration for all particles at once
    (eccapfim/particles.cpp:126-156).  Positions are cell-relative grid
    units, velocities physical.

    With ``kc > 0`` the rows are pre-partitioned (crossers in the first
    ``kc`` columns); the returned violation count is the largest number,
    in one iterate, of classified non-crossers that crossed a face.
    ``rest`` passes the zero-displacement (E, B) gather when the
    classifier already computed it.  Returns (tn, pn, vh, iterations,
    still-active mask, violations)."""
    fast = 0 < kc < t0.shape[1]
    no_viol = torch.zeros((), dtype=torch.int64, device=t0.device)

    def fields(tn):
        if not fast:
            E_p, B_p = _segment_fields(Eblk, Bblk, t0, tn)
            return E_p, B_p, no_viol
        E_c, B_c = _segment_fields(Eblk, Bblk, t0[:, :kc], tn[:, :kc])
        t0n, tnn = t0[:, kc:], tn[:, kc:]
        E_1, B_1 = _one_segment_fields(Eblk, Bblk, t0n, tnn)
        # Exact guard: a classified non-crosser whose iterate crossed a
        # face got the (invalid-across-breakpoints) single-segment
        # gather; count it so the host can redo the step exactly.
        viol = torch.sum(
            torch.any(torch.round(tnn) != torch.round(t0n), dim=-1)
            & valid[:, kc:])
        return torch.cat([E_c, E_1], dim=1), torch.cat([B_c, B_1], dim=1), viol

    E_p, B_p = rest if rest is not None else _rest_fields(Eblk, Bblk, t0)

    def residue(pn, vh, E_p, B_p):
        return torch.linalg.norm(
            (pn - p0) - dt * qm * (E_p + torch.linalg.cross(vh, B_p)), dim=-1)

    cn_tol = CN_TOL if p0.dtype == torch.float64 else CN_TOL_F32
    res0 = residue(p0, p0, E_p, B_p)
    target = cn_tol + cn_tol * res0
    alpha = 0.5 * dt * qm

    it, tn, pn, res = 0, t0, p0, res0
    active = (res0 >= target) & valid
    nviol = no_viol
    while it < CN_MAXIT and bool(torch.any(active)):
        a = alpha * E_p
        b = alpha * B_p
        w = p0 + a
        b2 = torch.sum(b * b, dim=-1, keepdim=True)
        vh = (w + torch.linalg.cross(w, b)
              + b * torch.sum(w * b, dim=-1, keepdim=True)) / (1.0 + b2)
        m = active[..., None]
        tn = torch.where(m, t0 + (vh / d_steps) * dt, tn)
        pn = torch.where(m, 2.0 * vh - p0, pn)
        E_n, B_n, viol = fields(tn)
        E_p = torch.where(m, E_n, E_p)
        B_p = torch.where(m, B_n, B_p)
        res = torch.where(active, residue(pn, vh, E_p, B_p), res)
        active = active & ~(res < target)
        nviol = torch.maximum(nviol, viol)
        it += 1
    vh = 0.5 * (pn + p0)
    return tn, pn, vh, it, active, nviol


def _segment_deposit(t0, tn, vh, scale):
    """4-segment path-averaged current deposit blocks
    (eccapfim/particles.cpp:158-170): per segment, scale * its length
    fraction (dtau == dt, so dtau/dt == 1)."""
    taus = split_segments(t0, tn)
    dseg = tn - t0
    Jblk = 0.0
    for s in range(MAXSEG):
        a = taus[..., s][..., None]
        b = taus[..., s + 1][..., None]
        seg0 = t0 + a * dseg
        seg1 = t0 + b * dseg
        bs = (b - a)[..., 0] * scale  # [G, K]
        Jblk = Jblk + deposit_J_implicit(seg0, seg1, vh, bs)
    return Jblk


def _form_species(E_hk, B, st: BinnedState, geom: Geometry, qm: float,
                  a0: float, kc: int = 0):
    """One species' contribution to J(E_hk) plus its candidate state.

    ``st`` is the start-of-step binned state; it stays fixed across
    residual evaluations.  Returns ``(J, r_new, p_new, cn_iterations,
    nonconverged, max_disp, (overflow, violations))``.

    ``kc > 0`` enables the crosser-compaction fast path: probable
    face-crossers are moved to the first ``kc`` slot columns of their
    own cell row (a stable in-row partition) and only they take the
    4-segment path; the rest take the single-segment gather and deposit.
    ``overflow`` is 1 when a row held more classified crossers than
    ``kc``; ``violations`` counts classified non-crossers whose Picard
    iterate crossed a face (checked every iterate).  Either makes the
    caller redo the step on the general path, so the result is never
    approximate.
    """
    t0 = cell_t(geom, st.r)
    p0, valid = st.p, st.valid
    fast = 0 < kc < t0.shape[1]
    overflow = torch.zeros((), dtype=torch.int64, device=t0.device)
    d_steps = torch.tensor(geom.cell_steps, dtype=E_hk.dtype,
                           device=E_hk.device)

    Eblk = gather_window_blocks(E_hk, geom)
    Bblk = gather_window_blocks(B, geom)

    rest = None
    if fast:
        # Conservative per-particle crosser classification: the
        # displacement estimate from the start-of-step velocity, with a
        # margin bounding how far any Picard iterate's midpoint velocity
        # can drift from it, |vh - p0| <= dt/2 |qm| (|E| + |vh||B|) at
        # the particle's own location (the zero-displacement gather,
        # which the sweep needs anyway) with a 2x cushion for the field
        # variation along the path.  The exact per-iterate check stays
        # the authority either way.
        E_p0, B_p0 = _rest_fields(Eblk, Bblk, t0)
        e_loc = torch.linalg.norm(E_p0, dim=-1)
        b_loc = torch.linalg.norm(B_p0, dim=-1)
        p_loc = torch.linalg.norm(p0, dim=-1)
        dv = (abs(qm) * geom.dt) * (e_loc + p_loc * b_loc)  # [G, K]
        d_est = p0 * (geom.dt / d_steps)
        marg = (dv[..., None] * geom.dt) / d_steps + CROSS_CUSHION
        r0 = torch.round(t0)
        hi = torch.round(t0 + (torch.clamp(d_est, min=0.0) + marg)) != r0
        lo = torch.round(t0 - (torch.clamp(-d_est, min=0.0) + marg)) != r0
        pred = torch.any(hi | lo, dim=-1) & valid
        counts = torch.sum(pred, dim=1)
        overflow = (torch.max(counts) > kc).to(torch.int64)
        # Stable in-row partition: crossers first (key 0 < key 1).
        order = torch.argsort((~pred).to(torch.int32), dim=1, stable=True)
        t0, p0, valid = _take(t0, order), _take(p0, order), _take(valid, order)
        rest = (_take(E_p0, order), _take(B_p0, order))

    tn, pn, vh, iters, nonconv, nviol = _cn_sweep(
        Eblk, Bblk, t0, p0, valid, geom.dt, qm, d_steps,
        kc if fast else 0, rest)

    # Deposit the path-averaged current of the converged move.
    valid_f = valid.to(E_hk.dtype)
    if fast:
        Jblk = _segment_deposit(t0[:, :kc], tn[:, :kc], vh[:, :kc],
                                a0 * valid_f[:, :kc])
        Jblk = Jblk + deposit_J_implicit(t0[:, kc:], tn[:, kc:],
                                         vh[:, kc:], a0 * valid_f[:, kc:])
    else:
        Jblk = _segment_deposit(t0, tn, vh, a0 * valid_f)
    J = scatter_blocks(Jblk, geom)

    # Candidate state (committed after the nonlinear solve converges):
    # absolute grid units = st.r + (tn - t0).
    if fast:
        # Undo the in-row partition so that slot order matches the input.
        inv = torch.argsort(order, dim=1)
        r_new = _take(_take(st.r, order) + (tn - t0), inv)
        pn = _take(pn, inv)
    else:
        r_new = st.r + (tn - t0)
    # Fast-particle guard: the 4-segment split handles at most one face
    # crossing per axis; a per-axis move >= 1 cell would silently lose
    # charge outside the 6-wide window, so the caller raises on it.
    max_disp = torch.max(torch.where(valid[..., None], torch.abs(tn - t0),
                                     torch.zeros_like(tn)))
    return (J, r_new, pn, iters, torch.sum(nonconv), max_disp,
            (overflow, nviol))


def _commit_state(st: BinnedState, geom: Geometry):
    """Boundary map + checked migration of the converged particle move
    (after_iteration -> update_cells, eccapfim/simulation.cpp:106-129)."""
    return migrate_checked(st, geom)


class EccapfimSimulation(Simulation):
    scheme_name = "eccapfim"

    def initialize_implementation(self) -> None:
        self.phase_timings: dict[str, float] = {}
        self.conv_history: list[float] = []
        # Per step: outer (Anderson) iterations, the Crank-Nicolson
        # iterations of every species sweep, and whether the fast path's
        # guard sent the step to the general path.
        self.outer_history: list[int] = []
        self.cn_history: list[list[int]] = []
        self.fallback_history: list[bool] = []
        self._cn_counts: list[int] = []
        self._fused_cache: dict = {}

    def initialize(self) -> None:
        super().initialize()
        # Auto-append the scheme's ConvergenceHistory table
        # (eccapfim/simulation.cpp:29).
        from ..diagnostics.convergence_history import ConvergenceHistory

        self.diagnostics.append(ConvergenceHistory(self))

    def _fused_residual(self, fast: bool = False):
        """The preconditioned residual G = 2 M^{-1} F(E_hk) and its
        byproducts (form_function, eccapfim/simulation.cpp:200-246),
        built once per path and cached with the solve's norm bound.

        Preconditioning: M = I + dt^2/4 curl- curl+ is the stiff linear
        part of F.  The Chebyshev inverse (``solvers/spectral.py``, the
        ``cheb_step`` kernel on the card) leaves only the O(dt) plasma
        response, which Anderson contracts in a handful of iterations.
        """
        cache = self._fused_cache
        if fast in cache:
            return cache[fast]
        geom = self.geom
        params = tuple((sp.params.qm, sp.params.q * sp.params.n_Np)
                       for sp in self.species if sp.n > 0)
        # matM in spectral.py is 2 I + (dt'^2/2) curlcurl; with
        # dt' = dt/sqrt(2):  matM = 2 I + (dt^2/2) curlcurl = 2 M.
        P = make_matM_preconditioner(geom, geom.dt / math.sqrt(2.0))
        steps, bounds = geom.cell_steps, geom.bounds
        sim = self

        def fused(E_hk, E, B, states):
            J = torch.zeros_like(E)
            pend, its = [], []
            max_disp = torch.zeros((), dtype=E.dtype, device=E.device)
            nonconv = torch.zeros((), dtype=torch.int64, device=E.device)
            overflow = torch.zeros_like(nonconv)
            viol = torch.zeros_like(nonconv)
            for st, (qm, a0) in zip(states, params):
                kc = _pick_kc(st.p.shape[1]) if fast else 0
                J_s, r_new, pn, it_s, nc, md, (ov, vi) = _form_species(
                    E_hk, B, st, geom, qm, a0, kc)
                overflow = overflow + ov
                viol = viol + vi
                J = J + J_s
                # The per-species current: the reference stores J per
                # species (src/interfaces/particles.h:20).
                pend.append((r_new, pn, J_s))
                its.append(it_s)
                sim._cn_counts.append(it_s)
                max_disp = torch.maximum(max_disp, md)
                nonconv = nonconv + nc
            F = (E_hk
                 + 0.25 * geom.dt ** 2
                 * curl_negative(curl_positive(E_hk, steps, bounds),
                                 steps, bounds)
                 - E
                 + 0.5 * geom.dt * J
                 - 0.5 * geom.dt * curl_negative(B, steps, bounds))
            G = 2.0 * P(F, 0.0)
            return G, (J, tuple(pend), its, max_disp, nonconv,
                       (overflow, viol))

        lam_cc = 4.0 * (1.0 / geom.dx ** 2 + 1.0 / geom.dy ** 2
                        + 1.0 / geom.dz ** 2)
        cache[fast] = (fused, 1.0 + 0.25 * geom.dt ** 2 * lam_cc)
        return cache[fast]

    def _solve_once(self, states, atol, rtol, fast: bool):
        """One nonlinear solve plus one device->host read of its
        statistics: the fast path's guard, accumulated over every
        residual evaluation (a contaminated iterate reached the Anderson
        window even if the final one is clean), and the last sweep's
        flags."""
        fused, _ = self._fused_residual(fast)
        last = {}
        guard = [None, None]

        def G(x):
            g, out = fused(x, self.E, self.B, states)
            last["out"] = out
            ov, vi = out[5]
            guard[0] = ov if guard[0] is None else torch.maximum(guard[0], ov)
            guard[1] = vi if guard[1] is None else torch.maximum(guard[1], vi)
            return g

        result = anderson_solve(G, self.E, atol=atol, rtol=rtol, maxit=MAXIT,
                                m=10)
        J_last, pend, its, max_disp, nonconv, _ = last["out"]
        max_disp, nonconv, overflow, viol = torch.stack(
            [max_disp.to(torch.float64), nonconv.to(torch.float64),
             guard[0].to(torch.float64), guard[1].to(torch.float64)]
        ).tolist()
        return {
            "x": result.x, "history": result.history,
            "iterations": result.iterations,
            "residual_norm": result.residual_norm,
            "converged": result.converged, "J": J_last, "pend": pend,
            "sp_its": its, "max_disp": max_disp, "nonconv": int(nonconv),
            "overflow": int(overflow), "violations": int(viol),
        }

    def timestep_implementation(self, t: int) -> None:
        geom = self.geom
        t0 = time.perf_counter()
        self._cn_counts = []

        # init_iteration: guess E^{n+1/2,0} = E^n
        # (eccapfim/simulation.cpp:46-66).
        _, bound = self._fused_residual(False)
        states = tuple(sp.state for sp in self.species if sp.n > 0)

        if self.E.dtype == torch.float64:
            atol = rtol = ATOL / bound
        else:
            # RMS-scaled absolute floor only; the relative target stays
            # at the documented RTOL.
            atol = ATOL_F32 * math.sqrt(self.E.numel()) / bound
            rtol = RTOL / bound
        out = self._solve_once(states, atol, rtol, True)
        fell_back = bool(out["overflow"] or out["violations"])
        if fell_back:
            # The conservative crosser classifier missed a particle or a
            # cell row overflowed the kc crosser columns: the solve is
            # untrusted; redo the whole step on the exact general path
            # (the solve mutated nothing yet).
            log.info(
                "  eccapfim fast path guard tripped at t=%d (%d species "
                "with a cell row over kc classified crossers; at most %d "
                "classified non-crossers crossed a face in one Picard "
                "iterate); redoing the step on the general 4-segment path",
                t, out["overflow"], out["violations"])
            out = self._solve_once(states, atol, rtol, False)
        self.fallback_history.append(fell_back)

        res_it = out["iterations"]
        res_rnorm = out["residual_norm"]
        max_disp, nonconv = out["max_disp"], out["nonconv"]
        for sp, it_count in zip((s for s in self.species if s.n > 0),
                                out["sp_its"]):
            sp.cn_iterations = float(it_count)
        self.conv_history = out["history"]
        self.outer_history.append(res_it)
        self.cn_history.append(self._cn_counts)
        self.phase_timings["calc_iteration"] = time.perf_counter() - t0
        if max_disp >= 1.0:
            raise RuntimeError(
                f"eccapfim: particle moved {max_disp:.2f} cells along one "
                f"axis in a single dt — beyond the one-crossing-per-axis "
                f"segment split; reduce dt (v_th dt/dx guard) or the "
                f"field amplitude")
        if nonconv:
            raise RuntimeError(
                f"eccapfim: Crank-Nicolson iteration did not converge for "
                f"{nonconv} particles (maxit={CN_MAXIT})")
        if not out["converged"]:
            raise RuntimeError(
                f"eccapfim nonlinear solve did not converge: "
                f"|F|={res_rnorm:.3e} after {res_it} its")
        log.info("  Nonlinear solve converged in %d iterations, |F|=%.3e",
                 res_it, res_rnorm)

        sol = out["x"]
        # after_iteration (eccapfim/simulation.cpp:106-129)
        self.E = 2.0 * sol - self.E
        self.B = self.B - geom.dt * curl_positive(sol, geom.cell_steps,
                                                  geom.bounds)
        self.J = out["J"]

        # Commit the particle states of the last residual evaluation
        # (at the converged solution) and wrap coordinates.
        pend_iter = iter(out["pend"])
        for sp in self.species:
            if sp.n == 0:
                sp.J = torch.zeros_like(self.J)
                continue
            r_new, pn, J_s = next(pend_iter)
            sp.state, load = _commit_state(
                BinnedState(r=r_new, p=pn, valid=sp.state.valid), geom)
            sp.J = J_s
            self.check_load(sp, load)
        self.refresh_counts()
