"""Telemetry of the port: the structured event bus."""
