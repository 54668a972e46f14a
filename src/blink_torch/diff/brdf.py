"""Lambertian BRDF constants (counterpart of `blink.diff.brdf`; cosine
sampling comes with path tracing, ROADMAP.md queue 1)."""
from __future__ import annotations

import math

INV_PI = 1.0 / math.pi
