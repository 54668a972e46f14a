"""Central finite-difference gradients (counterpart of `blink.ref.fd`):
the oracle that gradients of the renderer at fixed hit topology are held
against. Works on any scalar function of a float64 parameter array;
choose the points away from visibility edges, where the loss is not
differentiable.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def fd_grad(
    f: Callable[[np.ndarray], float],
    x: np.ndarray,
    eps: float = 1e-3,
) -> np.ndarray:
    """Central differences: df/dx_i = (f(x+e_i) - f(x-e_i)) / (2 eps)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    flat = x.reshape(-1)
    gf = g.reshape(-1)
    for i in range(flat.shape[0]):
        xp = flat.copy()
        xm = flat.copy()
        xp[i] += eps
        xm[i] -= eps
        gf[i] = (
            float(f(xp.reshape(x.shape))) - float(f(xm.reshape(x.shape)))
        ) / (2.0 * eps)
    return g
