"""The solver sidecar's wire formats: ``codec`` (the solve inputs and
outputs as JSON-able dicts) and ``wire`` (binary framing). The flight
recorder encodes its records through ``codec``."""
