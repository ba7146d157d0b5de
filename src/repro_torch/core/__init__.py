"""The paper's primary contribution, ported: energy-aware scheduling of
asynchronous federated training (energy model, staleness metrics, online
Lyapunov scheduler, async parameter server with the K1 push-apply kernel,
slotted-time simulator on the numpy engine, real LeNet-5 training) behind
the ``Scenario`` entry point."""
from .aggregation import (AggregationRule, ReplaceRule, register_aggregation,
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
from .engine_state import EVENT_FIELDS, EngineState, PushLog
from .fleet import (CustomCatalogFleet, Fleet, FleetSpec, PaperFleet,
                    SyntheticFleet, register_fleet, registered_fleets,
                    resolve_fleet)
from .lyapunov import (BatchDecision, OnlineScheduler, UserSlotState,
                       schedule_threshold)
from .policies import (ImmediatePolicy, OnlinePolicy, Policy,
                       register_policy, registered_policies, resolve_policy)
from .realml import (BatchedMLBackend, ImageClassifierBackend, LeNetBackend,
                     make_backend, register_ml_backend,
                     registered_ml_backends)
from .scenario import Scenario
from .server import AsyncParameterServer, PushResult
from .simulator import ENGINES, FederatedSim, SimConfig, SimResult
from .staleness import LagTracker, gradient_gap, momentum_scale, tree_l2_norm
