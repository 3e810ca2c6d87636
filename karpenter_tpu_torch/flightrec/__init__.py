"""Decision flight recorder + deterministic replay engine.

The production-autoscaler black box: every provisioning `Solve()` and every
disruption decision is captured as a versioned, JSONL-serializable
`DecisionRecord` in a bounded in-memory ring (`recorder.FlightRecorder`),
dumpable through the ring's `dump()`. A dumped trace replays offline
(`replay.py`, `python -m karpenter_tpu_torch.flightrec`): the solver inputs
rebuild through the sidecar wire codec's encode paths, BOTH the tensor
solver (on the card unless the caller names another device) and the host
oracle re-run, and the decisions diff into a parity verdict — so any
production incident becomes a regression corpus entry alongside the
parity-fuzzer scenarios. The record format (schema version, JSON keys,
decision digest) is the JAX package's: a trace recorded by either package
replays on the other.
"""

from .record import (SCHEMA_VERSION, TraceVersionError, decision_digest,
                     decode_solve_payload, dumps_record, encode_solve_payload,
                     load_trace, loads_record)
from .recorder import FlightRecord, FlightRecorder
from .replay import ReplayReport, replay_record, replay_trace

__all__ = [
    "SCHEMA_VERSION", "TraceVersionError", "FlightRecord", "FlightRecorder",
    "ReplayReport", "decision_digest", "decode_solve_payload", "dumps_record",
    "encode_solve_payload", "load_trace", "loads_record", "replay_record",
    "replay_trace",
]
