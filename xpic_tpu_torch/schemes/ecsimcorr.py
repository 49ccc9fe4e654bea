"""ecsimcorr: ECSIM + charge-conserving correction + energy
renormalization (counterpart of ``xpic_tpu/schemes/ecsimcorr.py``).

Reference: src/impls/ecsimcorr/{simulation,particles}.cpp.  Extends the
ECSIM step (ecsimcorr/simulation.cpp:21-32):

1. ``clear_sources``  : also zero the Esirkepov current currJe and
                        snapshot each species' kinetic energy.
2. ``first_push``     : half drift r += v dt/2 with an Esirkepov deposit
                        into currJe, then the ECSIM fill (currI, matL).
3. ``advance_fields`` : the ECSIM predict solve -> Ep.
4. ``second_push``    : Boris vEB with (Ep, B), second half drift plus
                        Esirkepov deposit; accumulates the predicted
                        field work pred_w = sum q mpw (v_avg . E_p).
5. ``correct_fields`` : solve matM Ec = 2 E - dt currJe + dt curl-(B-B0)
                        on the constant SPD matM (CG).
6. ``final_update``   : per species, velocity renormalization by
                        lambda = sqrt(1 + dt (corr_w - pred_w)/K), then
                        the ECSIM final update with Ep <- Ec.

The half drifts migrate with the capacity-checked rebin; the push's E
gather is the slot gather (the ``slot_gather`` kernel on the card) on
both mass routes.  Host synchronisations: one per Krylov iteration of
the two solves, the rebin guard of each migration, and one fused read a
step of the consistency norm, the renormalization statistics and the
migration loads (``_host_sync``), where the solves' non-convergence
raises.

Over a z mesh (``geom.mesh``) the deposits, gathers, curls, the CG and
its Chebyshev preconditioner run through the mesh as in ECSIM; the
renormalization's four sums of a species (pred_w, corr_w, K and K0)
are all-reduced in one collective, so every rank scales by the same
lambda, and
the step's fused vector (the consistency norm's sum of squares and the
loads) is all-gathered once before its host read.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import Geometry
from ..ops.binning import BinnedState, kinetic_energy_state, migrate_checked
from ..ops.gather_scatter import (
    B_STAGGER,
    cell_t,
    esirkepov_current,
    gather_vector,
)
from ..ops.mass_free import gather_vector_slots
from ..ops.stencil import curl_negative, curl_positive
from ..parallel.mesh import mesh_of
from ..parallel.step import matL_apply
from ..pushers import update_vEB
from ..solvers import cg
from ..solvers.spectral import make_matM_preconditioner
from .ecsim import ATOL, MAXIT, RTOL, EcsimSimulation

log = logging.getLogger("xpic")

_NO_STATS = dict(lambda_dK=0.0, pred_dK=0.0, corr_dK=0.0, pred_w=0.0,
                 corr_w=0.0)


def _steps(geom: Geometry, like):
    return torch.tensor(geom.cell_steps, dtype=like.dtype, device=like.device)


def _half_drift_deposit(st: BinnedState, geom: Geometry, alpha: float):
    """r += v dt/2 with the Esirkepov deposit of the half move, then the
    checked migration (ecsimcorr/particles.cpp:27-50).  Returns
    ``(state, J_inc, load)``."""
    t0 = cell_t(geom, st.r)
    rg1 = st.r + (st.p / _steps(geom, st.r)) * (0.5 * geom.dt)
    J_inc = esirkepov_current(t0, cell_t(geom, rg1), st.valid, alpha, geom)
    st2, load = migrate_checked(BinnedState(r=rg1, p=st.p, valid=st.valid),
                                geom)
    return st2, J_inc, load


def _second_push_corr(Ep, B, st: BinnedState, geom: Geometry, qm: float,
                      qn_Np: float, alpha: float):
    """Boris vEB + second half drift + Esirkepov deposit + pred_w
    (ecsimcorr/particles.cpp:52-92).  Returns ``(state, J_inc, pred_w,
    load)``."""
    t = cell_t(geom, st.r)
    mask = st.valid[..., None]
    E_p = gather_vector_slots(Ep, t, geom)
    E_p = torch.where(mask, E_p, torch.zeros_like(E_p))
    B_p = gather_vector(B, t, st.valid, geom, order=1, width=3, anchor=-1,
                        stagger=B_STAGGER)
    p0 = st.p
    p1 = update_vEB(geom.dt, qm, p0, E_p, B_p)
    p1 = torch.where(mask, p1, torch.zeros_like(p1))

    rg1 = st.r + (p1 / _steps(geom, st.r)) * (0.5 * geom.dt)
    J_inc = esirkepov_current(t, cell_t(geom, rg1), st.valid, alpha, geom)
    work = 0.5 * torch.sum((p0 + p1) * E_p, dim=-1)
    pred_w = qn_Np * torch.sum(torch.where(st.valid, work,
                                           torch.zeros_like(work)))
    st2, load = migrate_checked(BinnedState(r=rg1, p=p1, valid=st.valid),
                                geom)
    return st2, J_inc, pred_w, load


def _correct_fields(E, B, B0, currJe, geom: Geometry):
    """Solve matM Ec = 2 E - dt currJe + dt curl-(B - B0) by CG from E,
    preconditioned by the Chebyshev apply at shift 0 (matM is constant
    SPD; ecsimcorr/simulation.cpp:52-63, 131-133).  Returns ``(Ec,
    iterations, residual_norm, converged)``."""
    steps, bounds, mesh = geom.cell_steps, geom.bounds, mesh_of(geom)
    half_dt2 = 0.5 * geom.dt * geom.dt

    def matM(x):
        return 2.0 * x + half_dt2 * curl_negative(
            curl_positive(x, steps, bounds, mesh), steps, bounds, mesh)

    rhs = (2.0 * E - geom.dt * currJe
           + geom.dt * curl_negative(B - B0, steps, bounds, mesh))
    P = make_matM_preconditioner(geom, geom.dt)
    res = cg(matM, rhs, x0=E, rtol=RTOL, atol=ATOL, maxit=MAXIT,
             M_inv=lambda v: P(v, 0.0), mesh=mesh)
    return res.x, res.iterations, res.residual_norm, res.converged


def _renormalize(st: BinnedState, currJe_s, Ec, pred_w, K0,
                 geom: Geometry, m_mpw: float):
    """Velocity renormalization lambda = sqrt(1 + dt (corr_w - pred_w)/K)
    (ecsimcorr/particles.cpp:93-126).  Returns the scaled state and the
    statistics [lambda_dK, pred_dK, corr_dK, pred_w, corr_w] (a device
    tensor).  On a slab the four sums pred_w, corr_w, K and K0 are
    all-reduced in one collective, so every rank scales by the same
    lambda."""
    sums = torch.stack([pred_w, torch.sum(currJe_s * Ec),
                        kinetic_energy_state(st, m_mpw), K0])
    if mesh_of(geom) is not None:
        sums = mesh_of(geom).allreduce_sum(sums)
    pred_w, corr_w, K, K0 = sums
    lambda2 = torch.where(
        K > 0.0,
        1.0 + geom.dt * (corr_w - pred_w) / torch.clamp(K, min=1e-300),
        torch.ones_like(K))
    lam = torch.sqrt(lambda2)
    p = torch.where(st.valid[..., None], st.p * lam, torch.zeros_like(st.p))
    stats = torch.stack([
        (lambda2 - 1.0) * K,  # lambda_dK
        K - K0,               # pred_dK
        lambda2 * K - K0,     # corr_dK
        pred_w,
        corr_w,
    ])
    return BinnedState(r=st.r, p=p, valid=st.valid), stats


class EcsimcorrSimulation(EcsimSimulation):
    scheme_name = "ecsimcorr"
    windows = EcsimSimulation.windows + ((-2, 6),)  # the Esirkepov deposit

    def initialize_implementation(self) -> None:
        super().initialize_implementation()
        self.Ec = torch.zeros_like(self.E)
        # Per step: the correct solve's iterations, the consistency norm.
        self.correct_ksp_history: list[int] = []
        self.consistency_history: list[float] = []
        for sp in self.species:  # the step-0 row of EcsimcorrEnergy
            sp.corr_stats = dict(_NO_STATS)

    def clear_sources(self) -> None:
        super().clear_sources()
        self.currJe = torch.zeros_like(self.J)
        for sp in self.species:
            # A device scalar, read inside _renormalize.
            sp.energy0 = kinetic_energy_state(
                sp.state, sp.params.m * sp.params.n_Np)

    def first_push(self) -> None:
        for sp in self.species:
            if sp.n == 0:
                sp.currJe = torch.zeros_like(self.J)
                sp._load = None
                continue
            alpha = sp.params.q * sp.params.n_Np / (6.0 * self.geom.dt)
            sp.state, sp.currJe, sp._load = _half_drift_deposit(
                sp.state, self.geom, alpha)
        self.fill_ecsim_current()

    def second_push(self) -> None:
        for sp in self.species:
            if sp.n == 0:
                continue
            pr = sp.params
            alpha = pr.q * pr.n_Np / (6.0 * self.geom.dt)
            sp.state, J_inc, sp.pred_w, load2 = _second_push_corr(
                self.Ep, self.B, sp.state, self.geom, pr.qm,
                pr.q * pr.n_Np, alpha)
            # Both half-step migrations' loads [2, 3]; the step's load is
            # their elementwise maximum, taken in _host_sync once each is
            # reduced over the ranks.
            sp._load = torch.stack([load2 if sp._load is None
                                    else sp._load, load2])
            sp.currJe = sp.currJe + J_inc
            self.currJe = self.currJe + sp.currJe

    def advance_fields(self) -> None:
        # Convergence is read at the step's end, in _host_sync.
        sol = self._predict()
        self._adv_solve = (sol.iterations, sol.residual_norm, sol.converged)

    def correct_fields(self) -> None:
        self.Ec, its, rnorm, ok = _correct_fields(
            self.E, self.B, self.B0, self.currJe, self.geom)
        self._corr_solve = (its, rnorm, ok)

    def _matL_apply(self, x):
        """The step's summed mass matrix applied to ``x``, dense blocks
        or the matrix-free operands."""
        return matL_apply(self._mass, x, self.geom)

    def final_update(self) -> None:
        for sp in self.species:
            if sp.n == 0:
                sp.corr_stats = dict(_NO_STATS)
                sp._stats_d = None
                continue
            pred_w = getattr(sp, "pred_w", None)
            if pred_w is None:
                pred_w = torch.zeros((), dtype=self.dtype, device=self.device)
            sp.state, sp._stats_d = _renormalize(
                sp.state, sp.currJe, self.Ec, pred_w, sp.energy0, self.geom,
                sp.params.m * sp.params.n_Np)
        mesh = mesh_of(self.geom)

        # Scheme health: the ECSIM current at the corrected field must
        # match the Esirkepov current, ||currJe - (currI + matL Ec)||
        # (ecsimcorr/simulation.cpp:76-83), taken before the swap; on a
        # slab the rank's sum of squares, reduced in _host_sync.
        diff = (self.currJe - (self.currI + self._matL_apply(self.Ec))
                ).reshape(-1)
        self._consistency_d = (torch.linalg.norm(diff) if mesh is None
                               else torch.sum(diff * diff))

        self.Ep, self.Ec = self.Ec, self.Ep  # VecSwap (simulation.cpp:85)
        E = self.E
        self.E = 2.0 * self.Ep - E
        self.B = self.B - self.geom.dt * curl_positive(
            self.Ep, self.geom.cell_steps, self.geom.bounds, mesh)

    def _host_sync(self) -> None:
        """The step's one fused device-to-host read: the consistency
        norm, each live species' renormalization statistics and
        migration load.  The two solves' results are already on the
        host; their non-convergence raises here, as in the JAX scheme.
        On a slab the vector is all-gathered first, in one collective:
        the squared norm and each migration's particle counts are summed
        over the ranks, its largest cell load is their maximum, and the
        statistics are already every rank's."""
        parts = [self._consistency_d.reshape(1)]
        live = [sp for sp in self.species
                if getattr(sp, "_stats_d", None) is not None]
        for sp in live:
            parts.append(sp._stats_d)
            load = getattr(sp, "_load", None)
            parts.append(load.reshape(6).to(self.dtype) if load is not None
                         else torch.full((6,), -1.0, dtype=self.dtype,
                                         device=self.device))
        vec = torch.cat([v.to(self.dtype) for v in parts])
        mesh = mesh_of(self.geom)
        if mesh is None:
            ranks = vec.cpu().numpy().astype(np.float64)[None]
        else:
            ranks = mesh.allgather(vec).cpu().numpy().astype(np.float64)
        vals = ranks[0]
        if mesh is not None:
            vals[0] = np.sqrt(ranks[:, 0].sum())

        adv_its, adv_rnorm, adv_ok = self._adv_solve
        corr_its, corr_rnorm, corr_ok = self._corr_solve
        self._ksp_iters = int(adv_its)
        self.ksp_history.append(self._ksp_iters)
        if not adv_ok:
            raise RuntimeError(
                f"ECSIM field solve did not converge: |r|={adv_rnorm:.3e} "
                f"after {int(adv_its)} iterations")
        if not corr_ok:
            raise RuntimeError(
                f"ecsimcorr correct solve did not converge: "
                f"|r|={corr_rnorm:.3e}")
        self.correct_ksp_iters = int(corr_its)
        self.current_consistency_norm = float(vals[0])
        self.correct_ksp_history.append(self.correct_ksp_iters)
        self.consistency_history.append(self.current_consistency_norm)
        log.info("  Norm of the difference in ECSIM and Esirkepov "
                 "currents: %.7f", self.current_consistency_norm)
        off = 1
        for sp in live:
            s = vals[off:off + 5]
            sp.corr_stats = dict(
                lambda_dK=float(s[0]), pred_dK=float(s[1]),
                corr_dK=float(s[2]), pred_w=float(s[3]), corr_w=float(s[4]))
            loads = ranks[:, off + 5:off + 11].reshape(-1, 2, 3)
            load = np.concatenate([loads[..., :1].max(axis=0),
                                   loads[..., 1:].sum(axis=0)],
                                  axis=1).max(axis=0)
            if load[0] >= 0:
                self.check_load(sp, load.astype(np.int64), reduced=True)
            sp._load = None
            sp._stats_d = None
            off += 11

    def timestep_implementation(self, t: int) -> None:
        phases = [
            ("clear_sources", self.clear_sources),
            ("first_push", self.first_push),
            ("advance_fields", self.advance_fields),
            ("second_push", self.second_push),
            ("correct_fields", self.correct_fields),
            ("final_update", self.final_update),
        ]
        for name, fn in phases:
            t0 = time.perf_counter()
            fn()
            self.phase_timings[name] = time.perf_counter() - t0
        # The Esirkepov current is the scheme's J
        # (ecsimcorr/simulation.cpp:16).
        self.J = self.currJe
        for sp in self.species:
            sp.J = getattr(sp, "currJe", torch.zeros_like(self.J))
        self._host_sync()
        self.refresh_counts()
