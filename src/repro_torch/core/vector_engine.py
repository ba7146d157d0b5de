"""Struct-of-arrays simulator engine (the counterpart of
``repro/core/vector_engine.py``'s ``_NumpyEngine``).

Per-user state lives in ``(n_users,)`` numpy arrays — the run's
``EngineState`` (core/engine_state.py) — and the fleet's catalog is
flattened into ``(n_devices, n_apps)`` lookup tables gathered per user
once at startup. Every phase of a slot — app arrivals, cooldown
transitions, policy decisions, training progression, Eq. (10) energy
accounting, Eq. (15)/(16) queue updates — is a handful of vector ops.

Real-ML runs are batched (core/realml.py): with an ``ml_backend`` the
engine snapshots pulls per starting cohort (``pull_batch``) and, when a
slot's trainers finish, hands the whole finisher cohort to
``finish_async_batch`` — one batched local epoch, then the pushes applied
in user order through the K1 kernel. Under a lock-step policy (``sync``)
the cohort is trained and submitted instead (``local_train_batch``,
``submit_batch``), and the round's models are averaged when its last
trainer finishes (``sync_aggregate``). Accuracy is sampled every
``backend.eval_every`` slots.

Equivalence contract: seeded runs reproduce the JAX package's numpy
engine — identical decision sequences, update counts, push logs and
queue traces in trace mode; in real mode the schedule is identical while
H == 0 (the online argmin then ignores the momentum norm) and the float
metrics agree within the tolerances of ``tests/test_torch_slice.py``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .engine_state import (MODE_COOL, MODE_TRAIN, MODE_WAIT, PLAN_HOLD,
                           PushLog)
from .simulator import SimResult, n_slots, trace_v_norm
from .staleness import gradient_gap

__all__ = ["run_vectorized"]


def run_vectorized(sim) -> SimResult:
    """Run ``sim`` (a constructed FederatedSim) on the numpy engine."""
    return _NumpyEngine(sim).run()


def _user_tables(sim):
    """Gather the fleet's catalog rows for each user's device, once per
    run."""
    tab = sim.fleet_spec.tables
    dev = sim.fleet_spec.device_ids
    return (tab.p_train[dev], tab.t_train[dev], tab.p_idle[dev],
            tab.p_sched[dev], tab.p_app[dev], tab.p_corun[dev],
            tab.t_corun[dev], tab.saving_rate[dev])


class _NumpyEngine:
    """Per-run slot loop over the shared ``EngineState``. Policies
    read/mutate state from their ``decide_vectorized`` hook:

    - ``s``: the run's ``EngineState`` (``sim.state``)
    - ``waiting`` / ``has_app``: this slot's masks (set before dispatch)
    - ``p_if_train`` / ``p_if_idle``: Eq. (10) powers of the train/idle
      branch per user (co-run aware, maintained incrementally)
    - ``T_COR``, ``SRATE``, ``app_sched``, ``app_choice``: lookahead
      tables (the offline plan)
    - ``ar``: every user index (a sync round starts them all)
    - ``begin_training(idx)``: schedule users ``idx`` this slot
    - ``v_norm(ver)``: the momentum norm (the backend's in real mode, the
      trace model otherwise)
    - ``sched``: the OnlineScheduler queue-update rule + decide_batch
    """

    def __init__(self, sim):
        cfg = sim.cfg
        self.cfg = cfg
        self.n = cfg.n_users
        self.T = n_slots(cfg)
        (self.PT, self.TT, self.PI, self.PS, self.P_APP, self.P_COR,
         self.T_COR, self.SRATE) = _user_tables(sim)
        self.OVERHEAD = self.PS - self.PI
        self.app_sched, self.app_choice = sim.app_sched, sim.app_choice
        self.sched = sim.sched
        self.policy = sim.policy
        self.agg = sim.agg
        self.fleet_spec = sim.fleet_spec
        self.backend = sim.ml_backend     # None for trace runs
        self.ar = np.arange(self.n)
        self.s = sim.state
        # app-dependent lookups, maintained on app arrival/expiry events
        self.p_if_train = self.PT.copy()
        self.p_if_idle = self.PI.copy()
        self.t_if_corun = np.zeros(self.n)
        self.waiting = np.zeros(self.n, dtype=bool)
        self.has_app = np.zeros(self.n, dtype=bool)

    def v_norm(self, ver):
        """ver may be a scalar or an array of per-finisher versions; the
        backend's norm is slot-constant and broadcasts."""
        if self.backend is not None:
            return self.backend.v_norm()
        return trace_v_norm(self.cfg.v_norm0, ver)

    def _finish_cohort(self, fidx, lags):
        """Real-ML finish of one slot's finisher cohort. Returns the
        per-finisher ``(gaps, weights)`` for the push log."""
        b = self.backend
        cfg = self.cfg
        if b.sync == self.policy.sync_rounds:
            if b.sync:
                trained = b.local_train_batch(fidx, self.s.pulled_at[fidx])
                return b.submit_batch(fidx, trained, lags, cfg.eta,
                                      cfg.beta)
            return b.finish_async_batch(fidx, self.s.pulled_at[fidx], lags,
                                        cfg.eta, cfg.beta,
                                        need_gaps=cfg.collect_push_log)
        # policy/backend round-mode mismatch: nothing trains, as in the
        # JAX package (its loop oracle finds no matching hook); the log
        # gets the gaps and the rule's weights all the same
        vn = b.v_norm()
        gaps = np.asarray(gradient_gap(vn, lags, cfg.eta, cfg.beta),
                          dtype=float)
        if self.policy.sync_rounds:
            return gaps, np.ones(len(lags))
        return gaps, np.asarray(self.agg.weight(lags, gaps, vn,
                                                fleet=self.fleet_spec,
                                                users=fidx), dtype=float)

    def begin_training(self, idx):
        """idx: user indices starting training this slot (corun iff app)."""
        s = self.s
        ha = s.app[idx] >= 0
        s.corun[idx] = ha
        s.train_rem[idx] = np.where(ha, self.t_if_corun[idx], self.TT[idx])
        s.mode[idx] = MODE_TRAIN
        s.pulled_at[idx] = s.version
        s.in_flight += len(idx)
        if self.backend is not None:
            self.backend.pull_batch(np.asarray(idx), s.version)

    def run(self) -> SimResult:
        cfg = self.cfg
        policy = self.policy
        t_d = cfg.t_d
        T = self.T
        s = self.s
        sched = self.sched
        app_sched, app_choice = self.app_sched, self.app_choice
        mode, app, app_rem = s.mode, s.app, s.app_rem
        carry = s.carry

        trace_t: List[int] = []
        trace_E: List[float] = []
        trace_Q: List[float] = []
        trace_H: List[float] = []
        accuracy: List[Tuple] = []
        eval_every = self.backend.eval_every if self.backend is not None \
            else 0
        push_log = PushLog()

        for t in range(T):
            # --- app arrivals / progression -------------------------------
            srow = app_sched[t]
            has_app = app >= 0
            new_app = srow & ~has_app
            if has_app.any():
                app_rem[has_app] -= t_d
                ended = has_app & (app_rem <= 0.0)
                if ended.any():
                    app[ended] = -1
                    app_rem[ended] = 0.0
                    self.p_if_train[ended] = self.PT[ended]
                    self.p_if_idle[ended] = self.PI[ended]
            if new_app.any():
                nidx = np.nonzero(new_app)[0]
                aid = app_choice[t, nidx]
                app[nidx] = aid
                app_rem[nidx] = self.T_COR[nidx, aid]
                self.p_if_train[nidx] = self.P_COR[nidx, aid]
                self.p_if_idle[nidx] = self.P_APP[nidx, aid]
                self.t_if_corun[nidx] = self.T_COR[nidx, aid]

            # --- cooldown -> waiting (queue arrival) -----------------------
            arrivals = 0
            cooling = mode == MODE_COOL
            if cooling.any():
                s.cooldown[cooling] -= 1
                to_wait = cooling & (s.cooldown <= 0)
                arrivals = int(np.count_nonzero(to_wait))
                if arrivals:
                    mode[to_wait] = MODE_WAIT
                    s.plan[to_wait] = PLAN_HOLD
            self.waiting = mode == MODE_WAIT
            self.has_app = app >= 0

            # --- policy decisions for waiting users ------------------------
            served, gap_sum = policy.decide_vectorized(self, t, carry)

            # --- training progression --------------------------------------
            training = mode == MODE_TRAIN
            if training.any():
                s.train_rem[training] -= t_d
                fin = training & (s.train_rem <= 0.0)
                fidx = np.nonzero(fin)[0]
                k = len(fidx)
                if k:
                    gaps = weights = None
                    if policy.sync_rounds:
                        lags = s.version - s.pulled_at[fidx]
                        if self.backend is None and cfg.collect_push_log:
                            gaps = gradient_gap(self.v_norm(s.version),
                                                lags, cfg.eta, cfg.beta)
                            # FedAvg rounds average; no per-push weight
                            weights = np.ones(k)
                    else:
                        # async finishers bump the version one by one, in
                        # user order — each sees the versions of earlier
                        # finishers
                        vers = s.version + np.arange(k)
                        lags = vers - s.pulled_at[fidx]
                        if self.backend is None and cfg.collect_push_log:
                            vns = self.v_norm(vers)
                            gaps = gradient_gap(vns, lags, cfg.eta,
                                                cfg.beta)
                            weights = self.agg.weight(
                                lags, gaps, vns, fleet=self.fleet_spec,
                                users=fidx)
                        s.version += k
                    if self.backend is not None:
                        # one batched local epoch + ordered K1 pushes (or
                        # the round's submissions)
                        gaps, weights = self._finish_cohort(fidx, lags)
                    s.updates[fidx] += 1
                    mode[fidx] = MODE_COOL
                    s.cooldown[fidx] = cfg.ready_delay
                    s.idle_gap[fidx] = 0.0
                    s.in_flight -= k
                    s.corun_updates += int(np.count_nonzero(s.corun[fidx]))
                    if cfg.collect_push_log:
                        push_log.extend(t, fidx, lags, gaps, s.corun[fidx],
                                        weights)
            if policy.sync_rounds and s.round_open and \
                    not np.any(mode == MODE_TRAIN):
                s.round_open = False
                s.version += 1
                if self.backend is not None and self.backend.sync:
                    self.backend.sync_aggregate()

            # --- energy accounting (Eq. 10) --------------------------------
            training = mode == MODE_TRAIN
            p = np.where(training, self.p_if_train, self.p_if_idle)
            if cfg.include_scheduler_overhead and policy.uses_online_queue:
                p = np.where(mode == MODE_WAIT, p + self.OVERHEAD, p)
            if t_d != 1.0:     # p * 1.0 == p bitwise; skip the alloc
                p *= t_d
            s.energy += p

            # --- queues -----------------------------------------------------
            sched.update_queues(arrivals, served, gap_sum)
            s.Q, s.H = sched.Q, sched.H
            s.sum_Q += s.Q
            s.sum_H += s.H
            if t % cfg.trace_every == 0:
                trace_t.append(t)
                trace_E.append(float(s.energy.sum()))
                trace_Q.append(s.Q)
                trace_H.append(s.H)
            if eval_every and t % eval_every == 0 and t > 0:
                accuracy.append((t, self.backend.evaluate()))

        if self.backend is not None:
            accuracy.append((T, self.backend.evaluate()))
        updates_total = int(s.updates.sum())
        return SimResult(
            energy_j=float(s.energy.sum()),
            updates=updates_total,
            trace_t=np.array(trace_t), trace_energy=np.array(trace_E),
            trace_Q=np.array(trace_Q), trace_H=np.array(trace_H),
            push_log=push_log, accuracy=accuracy,
            mean_Q=s.sum_Q / T if T else 0.0,
            mean_H=s.sum_H / T if T else 0.0,
            corun_fraction=s.corun_updates / max(updates_total, 1))
