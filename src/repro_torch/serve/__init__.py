"""Serving surface of the port: the LM slot-table engine and the versioned
model snapshot."""
from .engine import Request, ServeConfig, ServingEngine
from .scheduler import ModelSnapshot, ServeRequest

__all__ = ["ModelSnapshot", "Request", "ServeConfig", "ServeRequest", "ServingEngine"]
