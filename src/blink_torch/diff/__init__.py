"""Hit refinement, BRDF, soft silhouettes and the gradient scatter."""
from blink_torch.diff.brdf import brdf_eval, brdf_pdf, sample_cosine
from blink_torch.diff.hitrefine import HitGeom, refine
from blink_torch.diff.scatter import scatter_grads, scatter_grads_masked

__all__ = [
    "brdf_eval", "brdf_pdf", "sample_cosine", "HitGeom", "refine",
    "scatter_grads", "scatter_grads_masked",
]
