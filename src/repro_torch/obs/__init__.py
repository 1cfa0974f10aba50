"""Event telemetry of the port: the reference's event registry, the
recorder, and JSONL export."""
from repro_torch.obs import events
from repro_torch.obs.export import read_jsonl, write_jsonl
from repro_torch.obs.recorder import NullRecorder, Recorder, current, recording

__all__ = ["NullRecorder", "Recorder", "current", "events", "read_jsonl", "recording",
           "write_jsonl"]
