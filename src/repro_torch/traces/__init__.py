"""Traces (mirrors repro/traces/): requests, arrival processes, faults,
the published-statistics builders and the scenario library."""
from repro_torch.traces.workload import TraceRequest, Workload, merge_workloads
from repro_torch.traces.servegen import servegen_workload
from repro_torch.traces.azure import azure_workload
from repro_torch.traces.scenarios import (
    EnvelopeSpec,
    ScenarioSpec,
    StreamSpec,
    get_scenario,
    list_scenarios,
)

__all__ = [
    "TraceRequest",
    "Workload",
    "merge_workloads",
    "servegen_workload",
    "azure_workload",
    "EnvelopeSpec",
    "ScenarioSpec",
    "StreamSpec",
    "get_scenario",
    "list_scenarios",
]
