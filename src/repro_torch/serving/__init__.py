"""The plan-serving daemon: FLASH synthesis as a concurrent service.

This package turns the one-shot scheduler pipeline (Scheduler -> Plan ->
compiled executor) into a long-running daemon that many MoE jobs share:

  * ``server``    -- ``PlanServer``: the daemon (fast path, worker pool,
                     background upgrades, prewarming, fabric-event
                     re-repair, worker respawn).
  * ``client``    -- ``PlanClient``: a job's handle; retry with backoff,
                     deadline, inline fallback.
  * ``events``    -- ``FabricEvent``/``FabricMonitor``: topology change
                     as a versioned event stream.
  * ``queue``     -- priority tiers, admission control, staleness shedding.
  * ``policy``    -- TTL eviction and the drift predictor.
  * ``telemetry`` -- counters, latency percentiles, synthesis histograms.

See DESIGN.md section 2 ("The serving layer") for the architecture and
``examples/plan_server_demo.py`` for a runnable tour.
"""

from .client import PlanClient
from .events import FabricEvent, FabricMonitor
from .policy import DriftPredictor, TTLPolicy
from .queue import (
    AdmissionError,
    PlanRequest,
    PlanTicket,
    ServerClosed,
    TieredQueue,
    Tier,
    DEFAULT_STALE_AFTER,
)
from .server import PlanAnswer, PlanServer
from .telemetry import LatencyReservoir, Telemetry

__all__ = [
    "PlanServer",
    "PlanAnswer",
    "PlanClient",
    "Tier",
    "TieredQueue",
    "PlanRequest",
    "PlanTicket",
    "AdmissionError",
    "ServerClosed",
    "DEFAULT_STALE_AFTER",
    "FabricEvent",
    "FabricMonitor",
    "TTLPolicy",
    "DriftPredictor",
    "Telemetry",
    "LatencyReservoir",
]
