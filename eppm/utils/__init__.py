from .guard import (
    FlowGuardError,
    FlowSanity,
    check_flow,
    flow_sanity,
)
from .timing import DeviceTimer, Timer, profile_trace, time_stage
