"""Dates, section timers and the CPU's vector-math warm-up."""
