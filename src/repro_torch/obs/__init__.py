"""Telemetry of the port: the structured event bus (the rest of the
reference's ``obs`` package is not ported yet)."""
