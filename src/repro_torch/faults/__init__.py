"""Fault injection and graceful degradation for the HFL engines.

``FaultSpec`` is the seeded, immutable description of an IoT fleet's failure
behaviour — availability churn, mid-round upload losses, per-EU energy
budgets, and time-varying channels; ``FaultState`` is the mutable per-run
runtime every engine consults (built once per ``Scenario.simulate`` call).
``faults=None`` keeps every engine on its fault-free code path.  Every
schedule is numpy from keyed generators, byte-equal to the reference
package's for the same spec; only the cost matrices are PyTorch.
"""
from repro_torch.faults.model import FaultSpec, FaultState, UploadPlan

__all__ = ["FaultSpec", "FaultState", "UploadPlan"]
