from .monitor import (ElasticCohort, FleetMonitor, HeartbeatMonitor,
                      SlotClock, StragglerDetector, WorkerStats)

__all__ = ["ElasticCohort", "FleetMonitor", "HeartbeatMonitor",
           "SlotClock", "StragglerDetector"]
