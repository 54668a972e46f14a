"""Hit refinement and BRDF."""
