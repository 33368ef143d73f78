"""Observability of the port: the device-time ledger (devledger.py).
Trace spans, the profiler route and the incident recorder are ROADMAP
A7a."""
