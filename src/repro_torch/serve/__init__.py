"""The bigset query service (wire protocol, cursor leases, backpressure).

PyTorch port of :mod:`repro.serve`, without ``engine`` (the model plane).
"""
from .bigset_service import (Backpressure, BigsetClient, BigsetService, Page,
                             ServiceConfig, ServiceError)

__all__ = [
    "Backpressure", "BigsetClient", "BigsetService", "Page", "ServiceConfig",
    "ServiceError",
]
