"""Host-side utilities of the port: structured logging, spans, profiler
traces."""

from .logging import get_logger
from .profiling import Span, device_trace, recording, span, spans

__all__ = ["get_logger", "Span", "device_trace", "recording", "span", "spans"]
