"""The paper's primary contribution, ported: energy-aware scheduling of
asynchronous federated training (energy model, staleness metrics, the
paper's four schedulers — online Lyapunov, immediate, offline knapsack,
FedAvg sync — the aggregation rules, the async parameter server with the
K1 push-apply kernel and the FedAvg server, slotted-time simulator on the
numpy engine, real LeNet-5 training) behind the ``Scenario`` entry
point."""
from .aggregation import (AggregationRule, FedAsyncPolyRule, GapAwareRule,
                          HeteroAwareRule, ReplaceRule, configure_aggregation,
                          hetero_scales, register_aggregation,
                          registered_aggregations, resolve_aggregation)
from .arrivals import (ArrivalProcess, BernoulliArrivals, DiurnalArrivals,
                       MarkovModulatedArrivals, TraceArrivals,
                       register_arrival, registered_arrivals,
                       resolve_arrival)
from .dynamics import (DeviceDynamics, NoDynamics, register_dynamics,
                       registered_dynamics, resolve_dynamics)
from .energy import (APPS, DEVICE_NAMES, TESTBED, AppProfile, DeviceProfile,
                     DeviceTables, build_tables, catalog_tables, device_ids,
                     table2_savings)
from .engine_state import (EVENT_FIELDS, PLAN_CORUN, PLAN_HOLD, PLAN_SEP,
                           EngineState, PushLog)
from .fleet import (CustomCatalogFleet, Fleet, FleetSpec, PaperFleet,
                    SyntheticFleet, register_fleet, registered_fleets,
                    resolve_fleet)
from .lyapunov import (BatchDecision, OnlineScheduler, UserSlotState,
                       schedule_threshold)
from .offline import (knapsack_schedule, lemma1_lag_bounds,
                      lemma1_lag_bounds_loop, offline_schedule)
from .policies import (ImmediatePolicy, OfflinePolicy, OnlinePolicy, Policy,
                       SyncPolicy, plan_window, register_policy,
                       registered_policies, resolve_policy)
from .realml import (BatchedMLBackend, ImageClassifierBackend, LeNetBackend,
                     make_backend, register_ml_backend,
                     registered_ml_backends)
from .scenario import Scenario, run_experiment, run_sweep
from .server import AsyncParameterServer, PushResult, SyncServer
from .simulator import ENGINES, FederatedSim, SimConfig, SimResult
from .staleness import LagTracker, gradient_gap, momentum_scale, tree_l2_norm
