"""Light sampling."""
