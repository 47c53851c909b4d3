"""The bigset query service (wire protocol, cursor leases, backpressure)
and the model serving engine.

PyTorch port of :mod:`repro.serve`.
"""
from .bigset_service import (Backpressure, BigsetClient, BigsetService, Page,
                             ServiceConfig, ServiceError)
from .engine import Request, ServeEngine

__all__ = [
    "Backpressure", "BigsetClient", "BigsetService", "Page", "Request",
    "ServeEngine", "ServiceConfig", "ServiceError",
]
