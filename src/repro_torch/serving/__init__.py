from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.traffic import ServeTraffic, TrafficSpec

__all__ = ["Request", "ServeEngine", "ServeTraffic", "TrafficSpec"]
