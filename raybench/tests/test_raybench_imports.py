"""The check on loaded modules: top-level names compared whole, so the port
(`blink_torch`) passes and the JAX package (`blink`) and JAX fail; what the
harness loads holds none of them; run.py refuses without a card."""
import subprocess
import sys

import pytest

from raybench.lib import bench


@pytest.mark.parametrize("name,bad", [
    ("blink_torch", False), ("blink_torch.api", False), ("blinker", False),
    ("jaxtyping", False), ("raybench.lib.bench", False), ("blink", True),
    ("blink.kernels.api", True), ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True),
])
def test_top_level_names_compared_whole(name, bad):
    assert bench.forbidden_loaded({name: None, "torch": None}) == ([name] if bad else [])


def test_the_harness_and_the_port_load_no_jax(root):
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from raybench.lib import bench\n"
            "import blink_torch.api, blink_torch.kernels.api, blink_torch.render.api\n"
            "import blink_torch.diff.soft, blink_torch.scene.scene\n"
            "print(bench.forbidden_loaded())\n") % (str(root), str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(root):
    """No CUDA device: a non-zero exit and no result line. (A test on the
    card's machine would find one; this one needs none.)"""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "raybench/run.py", "--workload", "sponza1m.grad",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
