"""Utilities of the port: timing, logging, profiling."""
