"""Host utilities: stage telemetry and profiler hooks (trace.py), and the
allocator tuning of the one-shot codec paths (mem.py)."""

from .trace import get_telemetry, profile, telemetry_enabled, timed_stage

__all__ = ["get_telemetry", "profile", "telemetry_enabled", "timed_stage"]
