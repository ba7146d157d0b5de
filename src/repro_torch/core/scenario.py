"""Composable experiment scenarios: policy x arrivals x fleet x config.

The counterpart of ``repro/core/scenario.py``: the entry point over the
simulator::

    from repro_torch.core import Scenario

    # the paper's Fig. 5 experiment: real LeNet-5 training on the card
    r = Scenario(policy="online", ml="lenet", n_users=25, horizon_s=3600,
                 V=5.0, app_arrival_p=0.004).run()

    # the same on the CPU
    r = Scenario(policy="online", ml="lenet", n_users=25, horizon_s=3600,
                 V=5.0, app_arrival_p=0.004,
                 ml_kwargs=dict(device="cpu")).run()

    # Fig. 5's oracle: per-user hooks on the loop engine
    from repro_torch.core import make_ml_hooks
    r = Scenario(policy="online", engine="loop", ml_mode="real",
                 n_users=25, horizon_s=3600, V=5.0,
                 app_arrival_p=0.004).run(ml_hooks=make_ml_hooks(25)[0])

    # the paper's trace-mode experiment on the device scan engine
    r = Scenario(policy="online", engine="jax", n_users=100_000,
                 horizon_s=300).run()                 # device="cuda"

    # a V grid as one batched scan on the card (16 points, one program)
    results = Scenario(policy="online", n_users=25, horizon_s=600).sweep(
        V=[2.5 * (k + 1) for k in range(16)])

Strings resolve through the registries; objects pass through as-is.
``run_experiment(policy="online", n_users=25)`` builds the Scenario
inline for one-liners. ``run_sweep`` buckets its points by
``sweep_bucket_key`` and runs each bucket of two or more as one stacked
scan on ``device`` (``run_jax_sweep``), the rest one by one: a trace
sweep on ``engine="auto"`` or ``"vectorized"`` joins a bucket, as in the
JAX package, so ``Scenario.sweep()`` runs on the card by default.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Union

from .arrivals import ArrivalProcess, resolve_arrival_or_default
from .fleet import Fleet, resolve_fleet
from .policies import Policy, resolve_policy
from .realml import BatchedMLBackend, make_backend
from .simulator import FederatedSim, SimConfig, SimResult


class Scenario:
    """One composed experiment: resolved policy/arrivals/fleet + SimConfig.

    ``ml`` couples the schedule to real training: a ``core.realml``
    backend name (``"lenet"``, ``"mlp"``) or ``BatchedMLBackend`` instance — setting
    it forces ``ml_mode="real"``, and ``build()`` constructs a fresh
    backend per run (seeded from ``SimConfig.seed``, round mode matched to
    the policy's ``sync_rounds``, training eta/beta defaulting to the
    config's, the config's aggregation rule and kernel mode). ``ml_kwargs`` are extra backend constructor arguments
    (``n_train``, ``batch_size``, ``device``, ...). Remaining keyword
    arguments are ``SimConfig`` fields, or pass a prebuilt ``config=``.
    """

    def __init__(self, policy: Union[str, Policy, None] = None,
                 arrivals: Union[str, ArrivalProcess, None] = None,
                 fleet: Union[str, Fleet, None] = None,
                 name: Optional[str] = None,
                 config: Optional[SimConfig] = None,
                 ml: Union[str, BatchedMLBackend, None] = None,
                 ml_kwargs: Optional[dict] = None,
                 **sim_kwargs):
        if config is not None:
            if sim_kwargs:
                raise ValueError(
                    f"pass either config= or SimConfig kwargs, not both "
                    f"(got {sorted(sim_kwargs)})")
            if policy is not None and policy is not config.policy:
                config = dataclasses.replace(config, policy=policy)
            self.config = config
        else:
            self.config = SimConfig(
                policy="online" if policy is None else policy, **sim_kwargs)
        if ml is not None and self.config.ml_mode != "real":
            self.config = dataclasses.replace(self.config, ml_mode="real")
        if ml is None and ml_kwargs:
            raise ValueError("ml_kwargs without ml= has no effect; "
                             "pass ml='lenet' (or a backend instance)")
        self.ml = ml
        self.ml_kwargs = dict(ml_kwargs or {})
        # raw arrivals argument, kept so grid() re-resolves it against
        # each point's config (a swept app_arrival_p rebinds the default
        # Bernoulli process; an explicit instance keeps its own rates)
        self._arrivals_arg = arrivals
        self.policy = resolve_policy(self.config.policy)
        self.arrivals = resolve_arrival_or_default(
            arrivals, self.config.app_arrival_p)
        self.fleet = None if fleet is None else resolve_fleet(fleet)
        self.name = name if name is not None else self.policy.name

    def build(self, ml_hooks: Optional[dict] = None,
              ml_backend: Optional[BatchedMLBackend] = None,
              device="cuda") -> FederatedSim:
        """Construct the (seeded) simulator without running it.
        ``ml_hooks`` (per-user hooks, ``make_ml_hooks``) run on the loop
        engine; pass them only to scenarios without ``ml=``. ``device``
        is where the device scan engine runs (``FederatedSim``)."""
        backend = ml_backend
        if backend is None and self.ml is not None:
            if ml_hooks is not None:
                raise ValueError(
                    "Scenario has ml= set; pass ml_hooks only to scenarios "
                    "without a backend")
            kw = dict(self.ml_kwargs)
            kw.setdefault("eta", self.config.eta)
            kw.setdefault("beta", self.config.beta)
            kw.setdefault("seed", self.config.seed)
            kw.setdefault("aggregation", self.config.aggregation)
            kw.setdefault("kernel", self.config.kernel)
            backend = make_backend(self.ml, self.config.n_users,
                                   sync=self.policy.sync_rounds, **kw)
        return FederatedSim(self.config, ml_hooks=ml_hooks,
                            ml_backend=backend,
                            arrivals=self.arrivals, fleet=self.fleet,
                            device=device)

    def run(self, ml_hooks: Optional[dict] = None,
            ml_backend: Optional[BatchedMLBackend] = None,
            device="cuda") -> SimResult:
        """Build and run. ``device`` is read only by the device scan
        engine (``engine="jax"``): ``"cuda"`` by default, ``"cpu"`` when
        the caller asks for it."""
        return self.build(ml_hooks=ml_hooks, ml_backend=ml_backend,
                          device=device).run()

    def grid(self, **axes) -> List["Scenario"]:
        """Cartesian product of ``SimConfig`` overrides as a scenario
        list, e.g. ``base.grid(V=[1e2, 1e3, 1e4], L_b=[5.0, 10.0])`` —
        six scenarios, the last-named axis varying fastest. Each point
        keeps this scenario's arrivals/fleet/ml composition; a swept
        ``app_arrival_p`` rebinds the default Bernoulli process per
        point."""
        names = list(axes)
        vals = [list(axes[k]) for k in names]
        out = []
        for combo in itertools.product(*vals):
            cfg = dataclasses.replace(self.config, **dict(zip(names, combo)))
            out.append(Scenario(config=cfg, arrivals=self._arrivals_arg,
                                fleet=self.fleet, name=self.name,
                                ml=self.ml,
                                ml_kwargs=self.ml_kwargs or None))
        return out

    def sweep(self, device="cuda", **axes) -> List[SimResult]:
        """``run_sweep(self.grid(**axes), device=device)``; results in
        ``grid`` order."""
        return run_sweep(self.grid(**axes), device=device)

    def __repr__(self):
        flt = self.fleet.name if self.fleet is not None else "paper"
        ml = "" if self.ml is None else \
            f", ml={getattr(self.ml, 'name', self.ml)!r}"
        return (f"Scenario({self.name!r}: policy={self.policy.name!r}, "
                f"arrivals={self.arrivals.name!r}, fleet={flt!r}, "
                f"n_users={self.config.n_users}, "
                f"horizon_s={self.config.horizon_s}{ml})")


def run_sweep(scenarios, device="cuda") -> List[SimResult]:
    """Run many ``Scenario``s, batching compatible ones as ONE stacked
    scan on ``device`` (``vector_engine.run_jax_sweep``).

    Points are bucketed by ``sweep_bucket_key`` (shapes, chunk, hook
    behaviours, statics, push-buffer capacity): each bucket of two or more
    runs batched; singletons and points that cannot batch (real-ML runs,
    offline's host knapsack, ``engine="loop"``, components without scan
    hooks, ``jax_chunk=0``) run as their own ``run()``. Results come back
    in input order, each equal to its per-point scan run (discrete
    outputs bit for bit, energies to float-sum order).

    A point that runs alone holds its sim only for its own run, and a
    real-ML point (which never batches) builds its backend just before
    it: a sweep keeps one point's model on the card at a time."""
    from .vector_engine import run_jax_sweep, sweep_bucket_key
    scenarios = list(scenarios)
    sims: List[Optional[FederatedSim]] = []
    for sc in scenarios:
        if not isinstance(sc, Scenario):
            raise TypeError(
                f"run_sweep takes Scenarios, got {type(sc).__name__}; "
                "build one with Scenario(...) or Scenario.grid(...)")
        sims.append(None if sc.ml is not None else sc.build(device=device))
    buckets: dict = {}
    for idx, sim in enumerate(sims):
        key = None if sim is None else sweep_bucket_key(sim)
        buckets.setdefault(key, []).append(idx)
    results: List[Optional[SimResult]] = [None] * len(sims)
    for key, idxs in buckets.items():
        if key is not None and len(idxs) >= 2:
            batch = [sims[i] for i in idxs]
            for i in idxs:
                sims[i] = None
            for i, res in zip(idxs, run_jax_sweep(batch)):
                results[i] = res
        else:
            for i in idxs:
                sim = sims[i] if sims[i] is not None \
                    else scenarios[i].build(device=device)
                sims[i] = None
                results[i] = sim.run()
    return results


def run_experiment(scenario: Optional[Scenario] = None, *,
                   ml_hooks: Optional[dict] = None,
                   ml_backend: Optional[BatchedMLBackend] = None,
                   **kwargs) -> SimResult:
    """Run a ``Scenario`` (or build one inline from kwargs) end to end."""
    if scenario is None:
        scenario = Scenario(**kwargs)
    elif kwargs:
        raise TypeError(
            f"pass either a Scenario or Scenario kwargs, not both "
            f"(got {sorted(kwargs)})")
    return scenario.run(ml_hooks=ml_hooks, ml_backend=ml_backend)
