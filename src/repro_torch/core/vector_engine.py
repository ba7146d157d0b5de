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

Device dynamics (core/dynamics.py) run first in a slot, through the same
host transition as the loop oracle, their effects applied as masked
writes (see ``_NumpyEngine.run``).

Equivalence contract: seeded runs reproduce the JAX package's numpy
engine — identical decision sequences, update counts, push logs and
queue traces in trace mode; in real mode the schedule is identical while
H == 0 (the online argmin then ignores the momentum norm) and the float
metrics agree within the tolerances of ``tests/test_torch_slice.py``.

The device scan engine (``engine="jax"``, the counterpart of the JAX
package's chunked ``lax.scan``) runs the same slot on the card: every
per-user field of the ``EngineState`` is a ``(B, n)`` tensor (float64,
int64 or bool) with a leading config axis, every scheduler scalar and
knob a ``(B, 1)`` tensor. A run is ``B = 1``; ``run_jax_sweep`` stacks
the points of a sweep bucket (``sweep_bucket_key``) as ``B > 1`` and
advances them together, as ``jax.vmap`` does for the reference. The
policy's ``scan_step``, the rule's ``scan_weight`` and the dynamics'
``scan_step`` supply the decisions, the push-log weights and the churn;
arrivals, cooldowns, training, Eq. (10) energy and Eqs. (15)/(16) queues
are engine code. The horizon runs in chunks of ``SimConfig.jax_chunk``
slots (0: auto-tuned, core/autotune.py); inside a chunk the host reads
nothing from the device (offline's plan slots excepted, where its
knapsack runs on the host), and online's sequential in-slot replay is
one CUDA C++ launch a slot (``kernels/online_replay``). Pushes are
scattered into a ``PushBuffer`` at ``count + rank`` in user order, rows
past the capacity dropped by masking while ``count`` stays exact; the
buffer is drained once a chunk, and a chunk that overflowed it is re-run
from its entry state with the capacity doubled to the next power of two
(the whole batch). Against the JAX package's jax engine under x64 and
the numpy engine: the schedule (t, user, lag, corun) is equal, energy and
``mean_Q`` within rel 1e-9, ``mean_H`` within rel 1e-6 (the replay sums
the gaps in user order, numpy pairwise), gaps and weights within rtol
1e-9. After a scan run ``sim.scan_info`` records the chunk, the final
push-buffer capacity, the overflow retries, the batch size, the padded
user-axis length ``n_arr`` and the auto-tuner's namespace (``None``
unless it ran).

A run with ``SimConfig.n_devices`` sizes its user axis to the devices of
``launch.mesh.make_sim_mesh`` (D of them) and pads it with inert users to
``n_arr = pad_to_devices(n, D)`` (core/engine_state.py): zero catalog
rows, no arrivals, MODE_OFF state rows and the dynamics' ``pad_state``
rows. The hooks see the live ``n`` (``sv.n``/``dv.n``), draw there and
pad their draws (``pad_users``), so the threefry stream, the decisions,
the queues, the push log and the live users' state are the unpadded
run's bit for bit; the energy sums read the live users only. The run
goes on the first device (one card: D = 1, ``n_arr = n``); ``_Scan``'s
``n_arr`` pads past ``n`` on one device (the tests' check that padding
is inert).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .engine_state import (MODE_COOL, MODE_OFF, MODE_TRAIN, MODE_WAIT,
                           PLAN_HOLD, EngineState, PushBuffer, PushLog,
                           pad_state_per_user, pad_to_devices,
                           unpad_state_per_user)
from .policies import _gradient_gap_t, _trace_v_norm_t
from .simulator import SimResult, n_slots, trace_v_norm
from .staleness import gradient_gap

__all__ = ["run_vectorized", "run_jax_sweep", "sweep_bucket_key"]


def run_vectorized(sim, backend: str = "vectorized") -> SimResult:
    """Run ``sim`` (a constructed FederatedSim) on the numpy engine, or on
    the device scan engine with ``backend="jax"`` (on ``sim.device``)."""
    if backend == "jax":
        return _Scan([sim], resolve_device(sim.device)).run()[0]
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
    - ``v_norm(ver)``: the momentum norm (the ``v_norm`` hook — the
      backend's in real mode — or the trace model)
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
        self.dynamics = sim.dynamics
        self.fleet_spec = sim.fleet_spec
        self._v_hook = sim.ml.get("v_norm")
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
        hook's norm is slot-constant and broadcasts."""
        if self._v_hook is not None:
            return self._v_hook()
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
        dynamics = self.dynamics
        dyn_active = dynamics.active
        dyn_lose = dynamics.dropout == "lose"
        up = net_extra = None

        for t in range(T):
            departures = 0

            # --- device dynamics (churn) -----------------------------------
            # the loop oracle's host transition, effects as masked writes:
            # waiting -> off is a queue departure, training -> off follows
            # the dropout rule, cooling parks in off, and recovered users
            # re-enter through cooldown with the network's extra delay
            if dyn_active:
                s.dyn, s.rng_key, eff = dynamics.host_step(
                    s.dyn, s.rng_key, mode, s.corun, t_d)
                up = np.asarray(eff.up)
                net_extra = np.asarray(eff.net_extra)
                wd = np.asarray(eff.went_down)
                if wd.any():
                    dwait = wd & (mode == MODE_WAIT)
                    dtrain = wd & (mode == MODE_TRAIN)
                    dcool = wd & (mode == MODE_COOL)
                    departures = int(np.count_nonzero(dwait))
                    mode[dwait | dcool] = MODE_OFF
                    if dyn_lose:
                        mode[dtrain] = MODE_OFF
                        s.train_rem[dtrain] = 0.0
                        s.in_flight -= int(np.count_nonzero(dtrain))
                    else:       # resume: paused, pays the extra seconds
                        s.train_rem[dtrain] += float(eff.resume_penalty)
                ret = np.asarray(eff.went_up) & (mode == MODE_OFF)
                if ret.any():
                    mode[ret] = MODE_COOL
                    s.cooldown[ret] = cfg.ready_delay + net_extra[ret]

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
            # under churn a down trainer is paused (resume rule) and
            # makes no progress
            training = (mode == MODE_TRAIN) & up if dyn_active \
                else mode == MODE_TRAIN
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
                    s.cooldown[fidx] = cfg.ready_delay if not dyn_active \
                        else cfg.ready_delay + net_extra[fidx]
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
            if dyn_active:     # a down device draws nothing
                p = np.where(up, p, 0.0)
            if t_d != 1.0:     # p * 1.0 == p bitwise; skip the alloc
                p *= t_d
            s.energy += p

            # --- queues -----------------------------------------------------
            sched.update_queues(arrivals, served, gap_sum, departures)
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
            corun_fraction=s.corun_updates / max(updates_total, 1),
            drops=dynamics.total_drops(s.dyn))


# ======================================================================
# The device scan engine: the slot on (B, n) tensors, chunked
# ======================================================================
_F, _I = torch.float64, torch.int64
# the scheduler scalars of EngineState (each a (B, 1) tensor on the card)
_SCALARS = {"version": _I, "in_flight": _I, "round_open": torch.bool,
            "Q": _F, "H": _F, "sum_Q": _F, "sum_H": _F,
            "corun_updates": _I}
_PER_USER = ("mode", "cooldown", "app", "app_rem", "train_rem", "corun",
             "idle_gap", "pulled_at", "energy", "updates", "plan")
# SimConfig knobs the slot reads, (B, 1) each
_KNOBS = ("V", "L_b", "epsilon", "eta", "beta", "v_norm0", "t_d",
          "ready_delay", "offline_window", "offline_resolution")


def _next_pow2(k: int) -> int:
    c = 1
    while c < k:
        c <<= 1
    return c


def _scan_setup(sim, n_devices: int = 1):
    """Host operands of one sim: its catalog gathers, arrivals, knobs,
    hook operands and the push buffer's first capacity. ``jax_chunk=0``
    (and, over several devices, a push log without
    ``push_log_capacity``) resolves against the device memory budget
    (core/autotune.py) of ``n_devices``."""
    cfg = sim.cfg
    n, T = cfg.n_users, n_slots(cfg)
    collect = cfg.collect_push_log
    tune = None
    chunk = cfg.jax_chunk
    if chunk == 0 or (n_devices > 1 and collect
                      and not cfg.push_log_capacity):
        from .autotune import autotune_scan_params
        tune = autotune_scan_params(sim, n_devices=n_devices)
        if chunk == 0:
            chunk = tune.jax_chunk
    chunk = min(chunk, T) if T else 0
    if not collect:
        cap = 0
    elif cfg.push_log_capacity:
        cap = _next_pow2(cfg.push_log_capacity)
    elif tune is not None:
        cap = tune.push_capacity
    else:
        cap = _next_pow2(max(1024, 2 * n))
    return SimpleNamespace(
        n=n, T=T, chunk=chunk, collect=collect, cap=cap, tune=tune,
        tables=tuple(np.asarray(a, np.float64) for a in _user_tables(sim)),
        app_sched=np.asarray(sim.app_sched[:T], bool),
        app_choice=np.asarray(sim.app_choice[:T], np.int32),
        knobs=tuple(getattr(cfg, k) for k in _KNOBS),
        pol_ops=tuple(sim.policy.scan_operands(cfg)),
        agg_ops=tuple(sim.agg.scan_operands(cfg)),
        dyn_ops=tuple(sim.dynamics.scan_operands(cfg))
        if sim.dynamics.active else (),
        statics=tuple(sim.policy.scan_statics(cfg)),
        overhead=cfg.include_scheduler_overhead)


def _pad_setup(prep, sim, n_arr):
    """The host operands and the initial state of one sim padded from
    ``n`` to ``n_arr`` users with INERT rows: zero catalog rows (zero idle
    power, so zero energy), no arrivals, MODE_OFF state rows and the
    dynamics' own ``pad_state`` rows. Returns the padded state."""
    k = n_arr - prep.n
    if k == 0:
        return sim.state
    prep.tables = tuple(
        np.concatenate([t, np.zeros((k,) + t.shape[1:], t.dtype)])
        for t in prep.tables)
    for f in ("app_sched", "app_choice"):
        a = getattr(prep, f)
        setattr(prep, f, np.concatenate(
            [a, np.zeros((a.shape[0], k), a.dtype)], axis=1))
    dyn_rows = sim.dynamics.pad_state(k) if sim.dynamics.active else None
    if sim.dynamics.active and dyn_rows is None:
        raise ValueError(
            f"{type(sim.dynamics).__name__} has no pad_state recipe; "
            "a padded run needs one when n_users is not a multiple of the "
            "device count (or pick n_users divisible by n_devices)")
    return pad_state_per_user(sim.state, n_arr, dyn_rows=dyn_rows)


def _column(values, dev, dtype=None):
    """Per-config numbers -> a (B, 1) tensor: ``dtype``, else floats f64,
    ints int64, bools bool."""
    a = np.asarray(values)
    if dtype is None:
        dtype = _F if a.dtype.kind == "f" else \
            torch.bool if a.dtype.kind == "b" else _I
    return torch.as_tensor(a.reshape(-1, 1)).to(dev, dtype)


def _stack_leaf(leaves, dev):
    """One carry/dyn leaf of B configs: numpy arrays -> a (B, *shape)
    tensor ((B, 1) for 0-d) in the engine's dtypes; Python numbers stay
    on the host and must agree across the batch."""
    if not isinstance(leaves[0], np.ndarray):
        if any(x != leaves[0] for x in leaves[1:]):
            raise ValueError(
                "a carry's Python-number leaves must be equal across a "
                f"sweep bucket; got {leaves}")
        return leaves[0]
    a = np.stack([np.asarray(x) for x in leaves])
    if a.ndim == 1:
        a = a[:, None]
    dtype = _F if a.dtype.kind == "f" else \
        torch.bool if a.dtype.kind == "b" else _I
    return torch.as_tensor(a).to(dev, dtype)


def _stack_tree(trees, dev):
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: _stack_tree([t[k] for t in trees], dev) for k in trees[0]}
    return _stack_leaf(trees, dev)


def _state_to_device(states, dev) -> EngineState:
    """B host EngineStates -> one EngineState of stacked device tensors
    (one transfer a field)."""
    kw = {}
    for f in _PER_USER:
        a = np.stack([getattr(s, f) for s in states])
        dtype = torch.bool if a.dtype == np.bool_ else \
            _F if a.dtype.kind == "f" else _I
        kw[f] = torch.as_tensor(a).to(dev, dtype)
    for f, dtype in _SCALARS.items():
        kw[f] = torch.as_tensor(
            np.asarray([getattr(s, f) for s in states]).reshape(-1, 1)
        ).to(dev, dtype)
    kw["rng_key"] = torch.as_tensor(np.stack(
        [np.asarray(s.rng_key, np.uint32).astype(np.int64)
         for s in states])).to(dev)
    for f in ("carry", "agg_carry", "dyn"):
        kw[f] = _stack_tree([getattr(s, f) for s in states], dev)
    return EngineState(**kw)


def _tree_to_host(tree, b, like):
    """Row ``b`` of a host copy of a stacked carry/dyn tree, each leaf in
    the shape of ``like`` (the run's initial host tree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to_host(v, b, like[k]) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return tree[b].reshape(np.shape(like))
    return tree


def _state_to_host(state: EngineState, initial) -> List[EngineState]:
    """The batch's final device state as host EngineStates (numpy
    arrays, Python scalars; ``initial`` the rows' starting host states),
    read in one transfer a field, so that ``sim.state`` reads as after a
    numpy-engine run."""
    host = {f: getattr(state, f).cpu().numpy()
            for f in _PER_USER + tuple(_SCALARS) + ("rng_key",)}
    trees = {f: _map_tensors(lambda x: x.cpu().numpy(), getattr(state, f))
             for f in ("carry", "agg_carry", "dyn")}
    out = []
    for b, init in enumerate(initial):
        kw = {f: host[f][b] for f in _PER_USER}
        for f, dtype in _SCALARS.items():
            v = host[f][b, 0]
            kw[f] = bool(v) if dtype == torch.bool else \
                float(v) if dtype == _F else int(v)
        kw["rng_key"] = host["rng_key"][b].astype(np.uint32)
        for f in ("carry", "agg_carry", "dyn"):
            kw[f] = _tree_to_host(trees[f], b, getattr(init, f))
        out.append(EngineState(**kw))
    return out


def _map_tensors(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return fn(tree) if torch.is_tensor(tree) else tree


class _Scan:
    """One batch of sims on one device: the stacked operands and the
    slot step. ``step(state, t)`` advances every config row one slot;
    ``run()`` drives the chunks, drains the push buffer and decodes the
    rows. ``n_arr`` (internal): the padded user-axis length; 0 takes
    ``pad_to_devices(n, D)`` for a run with ``n_devices`` (D devices of
    ``make_sim_mesh``), else ``n``."""

    def __init__(self, sims, dev, n_arr: int = 0):
        self.sims = sims
        self.dev = dev
        self.B = len(sims)
        cfg0 = sims[0].cfg
        D = 1
        if cfg0.n_devices:
            from ..launch.mesh import make_sim_mesh
            D = make_sim_mesh(cfg0.n_devices, dev).size
        preps = [_scan_setup(s, D) for s in sims]
        p0 = preps[0]
        self.n, self.T, self.chunk = p0.n, p0.T, p0.chunk
        self.n_arr = int(n_arr) or pad_to_devices(self.n, D)
        self.initial = [_pad_setup(p, s, self.n_arr)
                        for p, s in zip(preps, sims)]
        self.collect, self.cap, self.tune = p0.collect, p0.cap, p0.tune
        self.overhead, self.statics = p0.overhead, p0.statics
        sim0 = sims[0]
        self.cfg0 = sim0.cfg
        self.policy, self.agg, self.dynamics = \
            sim0.policy, sim0.agg, sim0.dynamics
        self.dyn_active = self.dynamics.active
        self.dyn_lose = self.dynamics.dropout == "lose"

        def stack(arrs, dtype):
            return torch.as_tensor(np.stack(arrs)).to(dev, dtype)

        tabs = [stack([p.tables[k] for p in preps], _F) for k in range(8)]
        (self.PT, self.TT, self.PI, self.PS, self.P_APP, self.P_COR,
         self.T_COR, self.SRATE) = tabs
        self.app_sched = stack([p.app_sched for p in preps], torch.bool)
        self.app_choice = stack([p.app_choice for p in preps], torch.int32)
        self.knobs = {k: _column([p.knobs[i] for p in preps], dev,
                                 _I if k == "ready_delay" else _F)
                      for i, k in enumerate(_KNOBS)}

        def ops(name):
            rows = [getattr(p, name) for p in preps]
            return tuple(_column([r[k] for r in rows], dev)
                         for k in range(len(rows[0])))

        self.pol_ops, self.agg_ops, self.dyn_ops = \
            ops("pol_ops"), ops("agg_ops"), ops("dyn_ops")
        self.ar = torch.arange(self.n_arr, device=dev)
        self.ar_f = self.ar.to(_F)

    def pad_users(self, x, fill):
        """A (..., n) per-user tensor extended to (..., n_arr) with
        ``fill`` (the identity unpadded)."""
        k = self.n_arr - self.n
        if not k:
            return x
        return torch.cat([x, x.new_full(x.shape[:-1] + (k,), fill)], -1)

    def _live(self, x):
        """The live users' columns of a (B, n_arr) tensor, contiguous, so
        that a sum over them adds what the unpadded run adds."""
        return x if self.n_arr == self.n else x[:, :self.n].contiguous()

    # ------------------------------------------------------------ the slot
    def _gather(self, table, aid):
        return torch.gather(table, 2, aid[..., None]).squeeze(-1)

    def step(self, s: EngineState, t: int) -> EngineState:
        n, kn = self.n, self.knobs
        t_d, ready_delay = kn["t_d"], kn["ready_delay"]
        policy = self.policy
        mode, cooldown, app, app_rem = s.mode, s.cooldown, s.app, s.app_rem
        train_rem, corun, idle_gap = s.train_rem, s.corun, s.idle_gap
        pulled_at, energy, updates = s.pulled_at, s.energy, s.updates
        version, in_flight = s.version, s.in_flight
        rng_key, dyn = s.rng_key, s.dyn

        # device dynamics, first in the slot (its draw precedes the
        # policy's, as on the host engines)
        if self.dyn_active:
            dv = SimpleNamespace(n=n, n_arr=self.n_arr,
                                 pad_users=self.pad_users, device=self.dev,
                                 rng_key=rng_key, mode=mode, corun=corun,
                                 t_d=t_d, fp_zero=0.0, consts=self.dyn_ops,
                                 float_dtype=_F, int_dtype=_I)
            dyn, eff = self.dynamics.scan_step(dyn, dv)
            rng_key = dv.rng_key
            up, net_extra = eff.up, eff.net_extra
            wd = eff.went_down
            dwait = wd & (mode == MODE_WAIT)
            dtrain = wd & (mode == MODE_TRAIN)
            dcool = wd & (mode == MODE_COOL)
            departures = dwait.sum(-1, keepdim=True)
            if self.dyn_lose:
                mode = torch.where(dwait | dtrain | dcool, MODE_OFF, mode)
                train_rem = torch.where(dtrain, 0.0, train_rem)
                in_flight = in_flight - dtrain.sum(-1, keepdim=True)
            else:       # resume: paused, pays the extra seconds
                mode = torch.where(dwait | dcool, MODE_OFF, mode)
                train_rem = torch.where(
                    dtrain, train_rem + eff.resume_penalty, train_rem)
            ret = eff.went_up & (mode == MODE_OFF)
            mode = torch.where(ret, MODE_COOL, mode)
            cooldown = torch.where(ret, ready_delay + net_extra, cooldown)

        # app arrivals and expiries
        srow, crow = self.app_sched[:, t], self.app_choice[:, t]
        has_app0 = app >= 0
        new_app = srow & ~has_app0
        app_rem = torch.where(has_app0, app_rem - t_d, app_rem)
        ended = has_app0 & (app_rem <= 0.0)
        app = torch.where(ended, -1, app)
        app_rem = torch.where(ended, 0.0, app_rem)
        app = torch.where(new_app, crow.to(_I), app)
        aid = app.clamp_min(0)
        tcor_g = self._gather(self.T_COR, aid)
        papp_g = self._gather(self.P_APP, aid)
        pcor_g = self._gather(self.P_COR, aid)
        app_rem = torch.where(new_app, tcor_g, app_rem)

        # cooldown -> waiting (queue arrivals)
        cooling = mode == MODE_COOL
        cooldown = torch.where(cooling, cooldown - 1, cooldown)
        to_wait = cooling & (cooldown <= 0)
        mode = torch.where(to_wait, MODE_WAIT, mode)
        plan = torch.where(to_wait, PLAN_HOLD, s.plan)
        arrivals = to_wait.sum(-1, keepdim=True)
        waiting = mode == MODE_WAIT
        has_app = app >= 0

        # the policy's decisions
        sv = SimpleNamespace(
            n=n, n_arr=self.n_arr, pad_users=self.pad_users, T=self.T, t=t,
            device=self.dev, float_dtype=_F,
            int_dtype=_I, waiting=waiting, has_app=has_app, app=app,
            updates=updates, pcor_g=pcor_g, papp_g=papp_g, tcor_g=tcor_g,
            PT=self.PT, TT=self.TT, PI=self.PI, PS=self.PS,
            T_COR=self.T_COR, SRATE=self.SRATE, app_sched=self.app_sched,
            app_choice=self.app_choice, plan=plan, idle_gap=idle_gap,
            in_flight=in_flight, version=version, round_open=s.round_open,
            Q=s.Q, H=s.H, rng_key=rng_key, consts=self.pol_ops,
            statics=self.statics,
            **{k: v for k, v in kn.items() if k != "ready_delay"})
        carry, (start, gap_sum) = policy.scan_step(s.carry, sv)
        idle_gap, round_open = sv.idle_gap, sv.round_open
        plan, rng_key = sv.plan, sv.rng_key
        served = start.sum(-1, keepdim=True)

        # begin training
        mode = torch.where(start, MODE_TRAIN, mode)
        corun = torch.where(start, has_app, corun)
        train_rem = torch.where(start, torch.where(has_app, tcor_g, self.TT),
                                train_rem)
        pulled_at = torch.where(start, version, pulled_at)
        in_flight = in_flight + served

        # training progression (a down "resume" trainer is paused)
        training = mode == MODE_TRAIN
        if self.dyn_active:
            training = training & up
        train_rem = torch.where(training, train_rem - t_d, train_rem)
        fin = training & (train_rem <= 0.0)
        kfin = fin.sum(-1, keepdim=True)
        updates = updates + fin
        mode = torch.where(fin, MODE_COOL, mode)
        cooldown = torch.where(
            fin, ready_delay + net_extra if self.dyn_active else ready_delay,
            cooldown)
        idle_gap = torch.where(fin, 0.0, idle_gap)
        in_flight = in_flight - kfin
        corun_updates = s.corun_updates + (fin & corun).sum(-1, keepdim=True)

        # push events: one row a finisher at count + its rank in user
        # order; rows past the capacity go to the dump row and are lost,
        # the count stays exact
        events, agg_carry = s.events, s.agg_carry
        if self.collect:
            fin_i = fin.to(_I)
            rank = torch.cumsum(fin_i, -1) - fin_i
            if policy.sync_rounds:
                lag = version - pulled_at
                vn = _trace_v_norm_t(kn["v_norm0"], version)
            else:
                vers = version + rank
                lag = vers - pulled_at
                vn = _trace_v_norm_t(kn["v_norm0"], vers)
            gap = _gradient_gap_t(vn, lag, kn["eta"], kn["beta"])
            if policy.sync_rounds:
                w = torch.ones_like(gap)    # FedAvg rounds average
            else:
                pv = SimpleNamespace(lag=lag, gap=gap, v_norm=vn,
                                     users=self.ar, consts=self.agg_ops,
                                     float_dtype=_F)
                agg_carry, w = self.agg.scan_weight(agg_carry, pv)
                w = w.expand(gap.shape)
            rows = torch.stack(
                [torch.full_like(gap, t), self.ar_f.expand(gap.shape),
                 lag.to(_F), gap, corun.to(_F), w.to(_F)], dim=-1)
            cap = events.rows.shape[1] - 1
            pos = events.count + rank
            pos = torch.where(fin & (pos < cap), pos, cap)
            events.rows.scatter_(1, pos[..., None].expand(rows.shape), rows)
            events = PushBuffer(events.rows, events.count + kfin)

        if policy.sync_rounds:
            closed = round_open & \
                ((mode == MODE_TRAIN).sum(-1, keepdim=True) == 0)
            version = version + closed
            round_open = round_open & ~closed
        else:
            version = version + kfin

        # energy (Eq. 10)
        training = mode == MODE_TRAIN
        p = torch.where(training, torch.where(has_app, pcor_g, self.PT),
                        torch.where(has_app, papp_g, self.PI))
        if self.overhead and policy.uses_online_queue:
            p = torch.where(mode == MODE_WAIT, p + (self.PS - self.PI), p)
        if self.dyn_active:     # a down device draws nothing
            p = torch.where(up, p, 0.0)
        energy = energy + p * t_d

        # queues (Eqs. 15-16; departures extend Eq. 15 under churn)
        Q = s.Q - served
        if self.dyn_active:
            Q = Q - departures
        Q = Q.clamp_min(0.0) + arrivals
        H = (s.H + gap_sum - kn["L_b"]).clamp_min(0.0)
        return EngineState(
            mode=mode, cooldown=cooldown, app=app, app_rem=app_rem,
            train_rem=train_rem, corun=corun, idle_gap=idle_gap,
            pulled_at=pulled_at, energy=energy, updates=updates, plan=plan,
            version=version, in_flight=in_flight, round_open=round_open,
            Q=Q, H=H, sum_Q=s.sum_Q + Q, sum_H=s.sum_H + H,
            corun_updates=corun_updates, rng_key=rng_key, carry=carry,
            agg_carry=agg_carry, dyn=dyn, events=events)

    # ----------------------------------------------------------- the run
    def _fresh_events(self, cap):
        # one spare row at index cap takes the rows that do not fit
        return PushBuffer(
            torch.zeros((self.B, cap + 1, 6), dtype=_F, device=self.dev),
            torch.zeros((self.B, 1), dtype=_I, device=self.dev))

    def run(self) -> List[SimResult]:
        B, T, chunk = self.B, self.T, self.chunk
        initial = self.initial
        state = _state_to_device(initial, self.dev)
        cap = self.cap
        if self.collect:
            state = dataclasses.replace(state, events=self._fresh_events(cap))
        logs = [PushLog() for _ in range(B)]
        # (Q, H, energy sum) at every slot some row's trace_every samples;
        # each row takes its own slots out of them below
        idxs = [np.arange(0, T, s.cfg.trace_every) for s in self.sims]
        sampled = np.zeros(T, dtype=bool)
        for idx in idxs:
            sampled[idx] = True
        samples = []
        retries = 0
        t0 = 0
        while t0 < T:
            t1 = min(t0 + chunk, T)     # the tail chunk stops at T
            prev = state
            part = []
            for t in range(t0, t1):
                state = self.step(state, t)
                if sampled[t]:
                    part.append(torch.cat(
                        [state.Q, state.H,
                         self._live(state.energy).sum(-1, keepdim=True)],
                        dim=1))
            if self.collect:
                counts = state.events.count[:, 0].tolist()
                if max(counts) > cap:
                    # re-run the chunk from its entry state, every row
                    # with the larger buffer (counts are exact)
                    cap = _next_pow2(max(counts))
                    state = dataclasses.replace(
                        prev, events=self._fresh_events(cap))
                    retries += 1
                    continue
                if any(counts):
                    rows = state.events.rows[:, :max(counts)].cpu().numpy()
                    for b in range(B):
                        logs[b].extend_rows(rows[b, :counts[b]])
                state = dataclasses.replace(state, events=PushBuffer(
                    state.events.rows, torch.zeros_like(state.events.count)))
            if part:
                samples.append(torch.stack(part, dim=1).cpu().numpy())
            t0 = t1
        trace = np.concatenate(samples, axis=1) if samples \
            else np.zeros((B, 0, 3))
        energy_rows = self._live(state.energy).sum(-1).cpu().numpy()
        hosts = [unpad_state_per_user(h, self.n) for h in _state_to_host(
            dataclasses.replace(state, events=None), initial)]
        at = np.cumsum(sampled) - 1     # a sampled slot's column in trace
        results = []
        for b, sim in enumerate(self.sims):
            host, idx = hosts[b], idxs[b]
            cols = at[idx]
            sim.state = host
            sim._ran = True
            sim.scan_info = SimpleNamespace(
                chunk=chunk, capacity=cap, retries=retries, batch=B,
                n_arr=self.n_arr, tune=self.tune)
            updates_total = int(host.updates.sum())
            results.append(SimResult(
                energy_j=float(energy_rows[b]), updates=updates_total,
                trace_t=idx, trace_energy=trace[b, cols, 2],
                trace_Q=trace[b, cols, 0], trace_H=trace[b, cols, 1],
                push_log=logs[b], accuracy=[],
                mean_Q=host.sum_Q / T if T else 0.0,
                mean_H=host.sum_H / T if T else 0.0,
                corun_fraction=host.corun_updates / max(updates_total, 1),
                drops=sim.dynamics.total_drops(host.dyn)))
        return results


# ======================================================================
# Batched sweeps: one stacked run advances B same-shape scenarios
# ======================================================================
def sweep_bucket_key(sim):
    """The bucket a sim shares a batched scan with, or None when it
    cannot join one: real-ML hooks or a backend, ``engine="loop"``, a
    padded user axis (``n_devices``: the devices are the parallelism), an
    auto-tuned chunk (``jax_chunk=0``, resolved per run), a policy or
    dynamics without a scan hook or with ``supports_vmap`` cleared
    (offline), or a push log under a rule without ``scan_weight``. Sims
    with equal keys have equal shapes, hook behaviours (``jax_cache_key``),
    statics and push-buffer capacity; everything else (V, L_b,
    ``scan_operands``, arrivals, seeds) is a per-row operand."""
    from .aggregation import aggregation_support
    from .dynamics import dynamics_support
    cfg = sim.cfg
    policy, agg, dynamics = sim.policy, sim.agg, sim.dynamics
    if sim.ml or sim.ml_backend is not None or cfg.engine == "loop":
        return None
    if cfg.n_devices or cfg.jax_chunk == 0:
        return None
    if not (policy.supports_jax and policy.supports_vmap):
        return None
    if not (dynamics_support(dynamics)["jax"] and dynamics.supports_vmap):
        return None
    collect = cfg.collect_push_log
    if collect and not (aggregation_support(agg)["jax"]
                        and agg.supports_vmap):
        return None
    n = cfg.n_users
    T = n_slots(cfg)
    if not T:
        return None
    cap = _next_pow2(cfg.push_log_capacity or max(1024, 2 * n)) \
        if collect else 0
    return (n, min(cfg.jax_chunk, T), T, policy.jax_cache_key(),
            cfg.include_scheduler_overhead, collect, cap,
            tuple(policy.scan_statics(cfg)),
            agg.jax_cache_key() if collect else None,
            dynamics.jax_cache_key() if dynamics.active else None)


def run_jax_sweep(sims) -> List[SimResult]:
    """Run constructed FederatedSims that share a ``sweep_bucket_key``
    (and a ``device``) as ONE stacked scan: their operands and states
    stack on a leading config axis and every slot advances them all.
    Each row decodes to the ``SimResult`` of its own per-point run
    (discrete outputs bit for bit, energies to float-sum order). The push
    buffer is ``(B, cap, 6)``; when any row overflows a chunk, the chunk
    re-runs for the whole batch with the buffer doubled."""
    sims = list(sims)
    if not sims:
        return []
    keys = {sweep_bucket_key(s) for s in sims}
    if None in keys or len(keys) != 1:
        raise ValueError(
            "run_jax_sweep needs sims sharing one sweep_bucket_key; got "
            f"{len(keys)} distinct keys (None = not batchable). Use "
            "core.scenario.run_sweep for bucketing and per-point runs.")
    devices = {str(torch.device(s.device)) for s in sims}
    if len(devices) != 1:
        raise ValueError(f"run_jax_sweep needs one device, got {devices}")
    return _Scan(sims, resolve_device(sims[0].device)).run()
