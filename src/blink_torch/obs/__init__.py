"""Observability: JSONL and tensorboard metrics, profiler traces."""
