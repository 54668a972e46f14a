"""Observability: JSONL metrics logging."""
