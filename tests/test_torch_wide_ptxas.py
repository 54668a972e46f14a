"""ptxas's register and spill report, as kernels/_build.py parses it and
chip_smoke.py reads it: the spills by kernel over nvcc's name forms
(a template in an anonymous namespace, an extern "C" name, a device
function, a whole-program build's internal namespace), and the mangled
names of all 16 wide kernels (wide_group_walk<any_hit, quant, mode>),
each picked alone by traverse_wide.kernel_symbol.
"""
import pytest

from blink_torch.kernels import _build
from blink_torch.kernels import traverse_wide as tw


ENTRY = "_ZN12_GLOBAL__N_115wide_group_walkILb1ELb1EEEvPKfS2_PfPiPbPKvS2_PKiPK6float4S8_if"


def ptxas_entry(name, stack, stores, loads, regs):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {stores} bytes spill stores, {loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 0 barriers, {stack} bytes cumulative "
            f"stack size\n")


@pytest.mark.parametrize("text, spills", [
    # a template kernel in an anonymous namespace, with spills
    (ptxas_entry(ENTRY, 768, 8, 12, 72), {ENTRY: 20}),
    # two entries, one of them an extern "C" name, and nvcc's other lines
    ("ptxas info    : 0 bytes gmem\n" + ptxas_entry("sphere_pass", 0, 0, 0, 29)
     + "ptxas info    : Compile time = 12.300 ms\n" + ptxas_entry(ENTRY, 768, 0, 0, 127),
     {"sphere_pass": 0, ENTRY: 0}),
    # a device function reported on its own is not a kernel
    ("ptxas info    : Function properties for _Z3fooi\n"
     "    16 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
     + ptxas_entry(ENTRY, 768, 0, 0, 127), {ENTRY: 0}),
    # nvcc's name for an anonymous namespace in a whole-program build
    (ptxas_entry("_ZN34_INTERNAL_0a1b2c3d_12_wide_walk_cu15wide_group_walkILb0ELb1EEEvPKf",
                 768, 0, 4, 128),
     {"_ZN34_INTERNAL_0a1b2c3d_12_wide_walk_cu15wide_group_walkILb0ELb1EEEvPKf": 4}),
    ("", {}),
], ids=["spills", "two-entries", "device-function", "internal-namespace", "empty"])
def test_ptxas_spills_by_kernel(text, spills):
    assert _build.ptxas_spills(text) == spills


#: nvcc's mangled names of the wide kernels: wide_group_walk<any_hit,
#: quant, mode> for group (0), row (1), stream (2) and skip (3).
GROUP_WALK = "_ZN12_GLOBAL__N_115wide_group_walkILb{}ELb{}ELi{}EEEvPKfS2_PfPiPbPKvS2_PKiPK6float4S9_S9_if"
NAMES = {(a, mo, q): GROUP_WALK.format(a, q, tw.LEAF_MODES.index(mo))
         for a in (0, 1) for q in (0, 1) for mo in tw.LEAF_MODES}


def test_ptxas_report_of_the_wide_kernels():
    """ptxas's report of all 16 wide kernels, one of them spilling: the
    spills by name, and kernel_symbol picks each variant's name alone."""
    text = "".join(ptxas_entry(k, 768, 4 if v == (1, "stream", 1) else 0, 0, 128)
                   for v, k in NAMES.items())
    spills = _build.ptxas_spills(text)
    assert spills == {k: 4 if v == (1, "stream", 1) else 0 for v, k in NAMES.items()}
    for (a, mo, q), k in NAMES.items():
        assert [x for x in spills if tw.kernel_symbol(bool(a), mo, bool(q)) in x] == [k]
