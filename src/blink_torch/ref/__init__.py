"""The CPU reference: an independent numpy renderer and central
differences."""
from blink_torch.ref.fd import fd_grad
from blink_torch.ref.renderer import ref_render

__all__ = ["fd_grad", "ref_render"]
