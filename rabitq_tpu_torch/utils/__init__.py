"""Host-side utilities of the port: structured logging, timing, profiler
traces."""

from .logging import get_logger, timed
from .profiling import Timer, device_trace

__all__ = ["get_logger", "timed", "Timer", "device_trace"]
