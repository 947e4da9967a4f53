"""Serving of the port: the continuous-batching engine on TAPA channels,
its overload layer (admission, breaker, metrics), the write-ahead journal
and seeded traffic — copies of the reference's ``serve`` package."""

from .admission import (AdmissionConfig, AdmissionController, BreakerOpen,
                        CircuitBreaker, ServeMetrics)
from .engine import (Request, RequestError, ServeConfig, ServingEngine,
                     serve_requests)
from .journal import ServeJournal
from .traffic import (TenantSpec, VirtualClock, make_trace,
                      noisy_neighbor_mix, trace_digest, uniform_mix)

__all__ = ["AdmissionConfig", "AdmissionController", "BreakerOpen",
           "CircuitBreaker", "Request", "RequestError", "ServeConfig",
           "ServeJournal", "ServeMetrics", "ServingEngine", "TenantSpec",
           "VirtualClock", "make_trace", "noisy_neighbor_mix",
           "serve_requests", "trace_digest", "uniform_mix"]
