"""The sampler's hash kernel (csrc/sampler_hash.cu) and its routes.

On the CPU: the kernel's constants and shifts are core/sampler.py's, read
from both sources; a CPU key takes the plain route in every public
function, which counts its rows under `sampler_rows.plain` and builds
nothing; the wrapper's checks of what the kernel reads in place. On the card
(gpu marker): every public function against the plain mirror bit for bit,
one launch a call, every row on the kernel route.
"""
import inspect
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from blink_torch.core import sampler
from blink_torch.kernels import _build
from blink_torch.obs import profile as obs

SOURCE = Path(sampler.__file__).resolve().parent.parent / "csrc" / "sampler_hash.cu"
M32 = (1 << 32) - 1


def _shifts(text: str) -> list[int]:
    return [int(x) for x in re.findall(r">> (\d+)", text)]


def test_kernel_constants_and_shifts_are_the_plain_versions():
    cu = SOURCE.read_text()
    const = {k: int(v.rstrip("u"), 0) for k, v in
             re.findall(r"constexpr (?:unsigned|int) (k\w+) = (0x[0-9A-F]+u|\d+u?);", cu)}
    assert const["kGolden"] == sampler._GOLDEN
    assert const["kGolden2"] == sampler._GOLDEN2
    assert const["kDimStride"] == sampler._DIM_STRIDE
    assert const["kMaxWords"] == sampler.MAX_WORDS
    hex8 = r"0x[0-9A-F]{8}"
    fold_offsets = [int(x, 16) for x in re.findall(hex8, inspect.getsource(sampler.fold))]
    assert [const["kFoldLo"], const["kFoldHi"]] == fold_offsets
    for fn, a, b, name in ((sampler._mix, "kMixA", "kMixB", "mix"),
                           (sampler._mix2, "kMix2A", "kMix2B", "mix2")):
        src = inspect.getsource(fn)
        assert [const[a], const[b]] == [int(x, 16) for x in re.findall(hex8, src)]
        body = re.search(rf"unsigned {name}\(unsigned x\) \{{(.*?)\n\}}", cu, re.S).group(1)
        assert _shifts(body) == _shifts(src) and len(_shifts(src)) == 3


def _plain_calls():
    """(name, public call, its plain mirror, rows) on CPU keys."""
    root = sampler.fold_chain_plain(torch.zeros(2, dtype=torch.int64), (0, 9))
    pid = torch.tensor([0, 5, M32, 1 << 40, 77], dtype=torch.int64)
    keys = torch.cat([sampler.fold_chain_plain(root, (pid, 3)),
                      sampler.fold_chain_plain(root, (sampler._BLOCK_NS, pid // 7, 3))], 1)
    return {
        "seed_key": (lambda: sampler.seed_key(9), lambda: root, 1),
        "pixel_key": (lambda: sampler.pixel_key(root, pid, 3), lambda: keys[:, :2], 5),
        "block_key": (lambda: sampler.block_key(root, pid // 7, 3), lambda: keys[:, 2:], 5),
        "bounce_key": (lambda: sampler.bounce_key(keys[:, 2:4], 2),
                       lambda: sampler.fold_chain_plain(keys[:, 2:4], (2,)), 5),
        "uniform": (lambda: sampler.uniform(keys[:, :2], 3, dim=1),
                    lambda: sampler.uniform_plain(keys[:, :2], 3, 1), 5),
    }


@pytest.mark.parametrize("name", ["seed_key", "pixel_key", "block_key", "bounce_key", "uniform"])
def test_cpu_key_takes_the_plain_route(name, monkeypatch):
    """The plain route on a CPU key: the mirror's result, its rows counted
    under sampler_rows.plain while a profiler records, no launch, no build."""
    def no_build(*a, **k):
        raise AssertionError("a CPU key built a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    call, mirror, rows = _plain_calls()[name]
    sampler.reset_launches()
    obs.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        got = call()
    counts = obs.counts()
    obs.reset_counts()
    assert torch.equal(got, mirror())
    assert counts.get("sampler_rows.plain") == rows and "sampler_rows.kernel" not in counts
    assert sampler.LAUNCHES == {"sampler_fold": 0, "sampler_uniform": 0}


def test_kernel_wrapper_checks_what_it_reads_in_place():
    """Keys the kernel reads through a row stride, rows that agree, and 1
    to 3 words a launch."""
    keys = torch.zeros(6, 4, dtype=torch.int64)
    assert sampler._key_rows(keys[:, 2:4]) == (6, 4)
    assert sampler._key_rows(torch.zeros(2, dtype=torch.int64)) == (None, 0)
    for bad in (keys[:, :3], keys.t()[:2], keys[:, :2].to(torch.int32),
                torch.zeros(2, 3, 2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="sampler kernel"):
            sampler._key_rows(bad)
    assert sampler._launch_rows([None, 7, 7, None]) == 7
    assert sampler._launch_rows([None, None]) is None
    with pytest.raises(ValueError, match="differ"):
        sampler._launch_rows([6, 1])
    with pytest.raises(ValueError, match="1 to 3 words"):
        sampler._fold_kernel(None, (1, 2, 3, 4), torch.device("cpu"))


@pytest.mark.gpu
def test_sampler_kernel_matches_plain_on_gpu():
    """Every public function on a CUDA key against the plain mirror on the
    card, bit for bit: a (2,) root over 1 to 4,194,304 rows, scalar and
    per-row words (0, 2^32 - 1, int64 words of 2^32 and more, masked), the
    views keys[:, :2] and keys[:, 2:4], draws n = 1, 2, 3, 16 at dims 0-2;
    one launch a call, every row counted on the kernel route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)

    def ids(n, hi=1 << 32):
        x = torch.randint(0, hi, (n,), generator=gen, dtype=torch.int64)
        x[0], x[-1] = 0, M32 if hi == 1 << 32 else hi - 1
        return x.to(dev)

    def once(entry, fn, *args):
        before = dict(sampler.LAUNCHES)
        out = fn(*args)
        assert sampler.LAUNCHES == {**before, entry: before[entry] + 1}
        return out

    def same(got, want):
        assert got.device == want.device and got.shape == want.shape
        assert torch.equal(got, want)

    sampler.reset_launches()
    obs.reset_counts()
    rows = 0
    zero = torch.zeros(2, dtype=torch.int64, device=dev)
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in (0, 7, 2**31 + 5, 2**40 + 3):
            root = once("sampler_fold", sampler.seed_key, seed, dev)
            same(root, sampler.fold_chain_plain(zero, ((seed >> 32) & M32, seed & M32)))
            rows += 1
        for n in (1, 31, 33, 97, 333, 4_194_304):
            pid, big = ids(n), ids(n, hi=1 << 62)
            pk = once("sampler_fold", sampler.pixel_key, root, pid, 3)
            same(pk, sampler.fold_chain_plain(root, (pid, 3)))
            same(once("sampler_fold", sampler.pixel_key, root, pid, big),
                 sampler.fold_chain_plain(root, (pid, big)))
            bk = once("sampler_fold", sampler.block_key, root, pid // 7, M32)
            same(bk, sampler.fold_chain_plain(root, (sampler._BLOCK_NS, pid // 7, M32)))
            rows += 3 * n
            keys = torch.cat([pk, bk], 1)
            for view in (keys[:, :2], keys[:, 2:4]):
                for b in (0, 3, M32, 1 << 33, big):
                    same(once("sampler_fold", sampler.bounce_key, view, b),
                         sampler.fold_chain_plain(view, (b,)))
                    rows += n
                for draws in (1, 2, 3, 16):
                    for dim in (0, 1, 2):
                        same(once("sampler_uniform", sampler.uniform, view, draws, dim),
                             sampler.uniform_plain(view, draws, dim))
                        rows += n
        with pytest.raises(ValueError, match="alias"):
            sampler.uniform(keys[:, :2], 17)
    torch.cuda.synchronize()
    counts = obs.counts()
    obs.reset_counts()
    assert counts.get("sampler_rows.kernel") == rows and "sampler_rows.plain" not in counts
