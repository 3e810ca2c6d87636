"""encode_ms.spot: milliseconds a spot consolidation decision spends taking
its snapshot and encoding it, per decision (layer: disruption snapshot and
encode): the spans and the reading of ``encode_ms.decision``, whose reader
this one runs."""

from benchmark.harness import reader

read = reader("encode_ms.decision")
