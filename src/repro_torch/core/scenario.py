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

    # the offline schedule (Alg. 1) over a knob grid, one run a point
    results = Scenario(policy="offline", n_users=25,
                       horizon_s=3600).sweep(L_b=[5.0, 1000.0])

Strings resolve through the registries; objects pass through as-is.
``run_experiment(policy="online", n_users=25)`` builds the Scenario
inline for one-liners. ``run_sweep`` runs its points one after another;
the JAX package's batched config axis (same-shape points stacked under
one compiled scan) waits for the port's scan engine (ROADMAP Queue 1
item 6).
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
    backend name (``"lenet"``) or ``BatchedMLBackend`` instance — setting
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

    def build(self, ml_backend: Optional[BatchedMLBackend] = None
              ) -> FederatedSim:
        """Construct the (seeded) simulator without running it."""
        backend = ml_backend
        if backend is None and self.ml is not None:
            kw = dict(self.ml_kwargs)
            kw.setdefault("eta", self.config.eta)
            kw.setdefault("beta", self.config.beta)
            kw.setdefault("seed", self.config.seed)
            kw.setdefault("aggregation", self.config.aggregation)
            kw.setdefault("kernel", self.config.kernel)
            backend = make_backend(self.ml, self.config.n_users,
                                   sync=self.policy.sync_rounds, **kw)
        return FederatedSim(self.config, ml_backend=backend,
                            arrivals=self.arrivals, fleet=self.fleet)

    def run(self, ml_backend: Optional[BatchedMLBackend] = None
            ) -> SimResult:
        return self.build(ml_backend=ml_backend).run()

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

    def sweep(self, **axes) -> List[SimResult]:
        """``run_sweep(self.grid(**axes))``; results in ``grid`` order."""
        return run_sweep(self.grid(**axes))

    def __repr__(self):
        flt = self.fleet.name if self.fleet is not None else "paper"
        ml = "" if self.ml is None else \
            f", ml={getattr(self.ml, 'name', self.ml)!r}"
        return (f"Scenario({self.name!r}: policy={self.policy.name!r}, "
                f"arrivals={self.arrivals.name!r}, fleet={flt!r}, "
                f"n_users={self.config.n_users}, "
                f"horizon_s={self.config.horizon_s}{ml})")


def run_sweep(scenarios) -> List[SimResult]:
    """Run many ``Scenario``s, one after another, each as its own
    ``Scenario.run()``; results in input order. (The JAX package batches
    same-shape points under one compiled scan; each of its results equals
    the point's own run, which is what this returns.)"""
    scenarios = list(scenarios)
    for sc in scenarios:
        if not isinstance(sc, Scenario):
            raise TypeError(
                f"run_sweep takes Scenarios, got {type(sc).__name__}; "
                "build one with Scenario(...) or Scenario.grid(...)")
    return [sc.run() for sc in scenarios]


def run_experiment(scenario: Optional[Scenario] = None, *,
                   ml_backend: Optional[BatchedMLBackend] = None,
                   **kwargs) -> SimResult:
    """Run a ``Scenario`` (or build one inline from kwargs) end to end."""
    if scenario is None:
        scenario = Scenario(**kwargs)
    elif kwargs:
        raise TypeError(
            f"pass either a Scenario or Scenario kwargs, not both "
            f"(got {sorted(kwargs)})")
    return scenario.run(ml_backend=ml_backend)
