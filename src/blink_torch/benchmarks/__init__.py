"""Benchmarks of blink_torch: the harness and the headline line."""
