from .monitor import HeartbeatMonitor, StragglerDetector, WorkerStats
