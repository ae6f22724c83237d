from repro_torch.serving.compile_cache import (
    COMPILE_STEPS, CompileEvent, TraceCounter, WidthVariantCompileCache,
    pow2_bucket, realized_exec_key,
)
from repro_torch.serving.engine import (
    AdmissionControl, BatchStats, Request, Result, ServeEngine,
    ServingWidthPlanner, TrafficClass, WidthPlan,
)
from repro_torch.serving.width_swap import (
    SWAP_STEPS, SwapEvent, WidthSwapper, serving_templates,
)
from repro_torch.serving.degradation import (
    DegradationController, DegradationLadder, LadderRung, Shift,
)
from repro_torch.serving.continuous import (
    Arrival, BoundaryEvent, ChunkEvent, ContinuousServeEngine, Ledger,
)
from repro_torch.serving.hedging import HedgeEvent, HedgePolicy
from repro_torch.serving.router import (
    HealthEvent, Replica, ReplicaRouter, RouterLedger,
)
from repro_torch.serving import chaos

__all__ = [
    "AdmissionControl", "BatchStats", "Request", "Result", "ServeEngine",
    "ServingWidthPlanner", "TrafficClass", "WidthPlan", "SWAP_STEPS",
    "SwapEvent", "WidthSwapper", "serving_templates",
    "DegradationController", "DegradationLadder", "LadderRung", "Shift",
    "COMPILE_STEPS",
    "CompileEvent", "TraceCounter", "WidthVariantCompileCache",
    "pow2_bucket", "realized_exec_key", "Arrival", "BoundaryEvent",
    "ChunkEvent", "ContinuousServeEngine", "Ledger", "HedgeEvent",
    "HedgePolicy", "HealthEvent", "Replica", "ReplicaRouter",
    "RouterLedger", "chaos",
]
