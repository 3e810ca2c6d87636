"""Observability: the pass-level span tracer (``tracer``) and the fallback
cost ledger (``fallbacks``)."""
