"""Core math and random streams."""
