"""Event telemetry of the port: the engine's lane events and the recorder."""
from repro_torch.obs import events
from repro_torch.obs.recorder import NullRecorder, Recorder, current, recording

__all__ = ["NullRecorder", "Recorder", "current", "events", "recording"]
