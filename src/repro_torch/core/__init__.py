"""The paper's primary contribution, ported: energy-aware scheduling of
asynchronous federated training (energy model, staleness metrics, the
paper's four schedulers — online Lyapunov, immediate, offline knapsack,
FedAvg sync — the greedy and eps_greedy extras, the aggregation rules,
Markov device churn, the async parameter server with the K1 push-apply
kernel and the FedAvg server, the slotted-time simulator on the loop
oracle and the numpy engine, real LeNet-5 and MLP training) behind the
``Scenario`` entry point."""
from .aggregation import (AggregationRule, FedAsyncPolyRule, GapAwareRule,
                          HeteroAwareRule, ReplaceRule, configure_aggregation,
                          hetero_scales, register_aggregation,
                          registered_aggregations, resolve_aggregation)
from .arrivals import (ArrivalProcess, BernoulliArrivals, DiurnalArrivals,
                       MarkovModulatedArrivals, TraceArrivals,
                       register_arrival, registered_arrivals,
                       resolve_arrival)
from .client import Client
from .dynamics import (DROPOUT_RULES, DeviceDynamics, DynEffects,
                       MarkovChurnDynamics, NoDynamics, dynamics_support,
                       register_dynamics, registered_dynamics,
                       resolve_dynamics)
from .energy import (APPS, DEVICE_NAMES, TESTBED, AppProfile, DeviceProfile,
                     DeviceTables, build_tables, catalog_tables, device_ids,
                     table2_savings)
from .engine_state import (EVENT_FIELDS, MODE_COOL, MODE_OFF, MODE_TRAIN,
                           MODE_WAIT, PLAN_CORUN, PLAN_HOLD, PLAN_SEP,
                           EngineState, PushLog)
from .fleet import (CustomCatalogFleet, Fleet, FleetSpec, PaperFleet,
                    SyntheticFleet, register_fleet, registered_fleets,
                    resolve_fleet)
from .lyapunov import (BatchDecision, OnlineScheduler, UserSlotState,
                       schedule_threshold)
from .offline import (knapsack_schedule, lemma1_lag_bounds,
                      lemma1_lag_bounds_loop, offline_schedule)
from .policies import (EpsGreedyPolicy, GreedyThresholdPolicy,
                       ImmediatePolicy, OfflinePolicy, OnlinePolicy, Policy,
                       SyncPolicy, engine_support, plan_window,
                       register_policy, registered_policies, resolve_policy)
from .realml import (BatchedMLBackend, ImageClassifierBackend, LeNetBackend,
                     MLPBackend, make_backend, make_ml_hooks,
                     register_ml_backend, registered_ml_backends)
from .scenario import Scenario, run_experiment, run_sweep
from .server import AsyncParameterServer, PushResult, SyncServer
from .simulator import (ENGINES, FederatedSim, SimConfig, SimResult,
                        UserState)
from .staleness import LagTracker, gradient_gap, momentum_scale, tree_l2_norm
