"""Dates and section timers."""
