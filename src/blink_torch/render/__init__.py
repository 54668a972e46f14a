"""Rendering pipeline."""
