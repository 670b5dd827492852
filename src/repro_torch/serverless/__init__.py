from repro_torch.serverless.event_sim import AvailabilityMap, Event, EventSim, \
    ReadAheadWindow, Timeline, arrival_order
from repro_torch.serverless.faults import FaultModel, fault_model_from_env
from repro_torch.serverless.runtime import (
    FaultPlan,
    InjectedFault,
    InvocationRecord,
    LambdaContext,
    LambdaOOM,
    LambdaRuntime,
    LambdaTimeout,
    PhaseHandle,
    fn_family,
)

__all__ = ["AvailabilityMap", "Event", "EventSim", "FaultModel", "FaultPlan",
           "InjectedFault", "InvocationRecord", "LambdaContext", "LambdaOOM",
           "LambdaRuntime", "LambdaTimeout", "PhaseHandle",
           "ReadAheadWindow", "Timeline",
           "arrival_order", "fault_model_from_env", "fn_family"]
