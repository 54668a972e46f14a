"""Counter-based random streams, bit-identical to `blink.core.sampler`.

Every random decision is a pure function of (seed, pixel or block id,
sample, bounce, dimension): a murmur-finalizer hash chain over a two-word
uint32 state. Keys are (..., 2) int64 tensors holding values in [0, 2^32).

On a CUDA key each public function is one launch of `csrc/sampler_hash.cu`,
which runs the call's whole chain in registers on native uint32 words. On a
CPU key it runs the plain version (`fold_chain_plain`, `uniform_plain`),
which the kernel is held to bit for bit on the card. Torch has no usable
uint32 shifts and adds on the CPU, so there the words are int64 tensors,
reduced with `& 0xFFFFFFFF` after every add and multiply; a multiply goes in
two 16-bit halves so that no product leaves the int64 range.
"""
from __future__ import annotations

import ctypes

import torch

from blink_torch.obs.profile import count, span

_M32 = 0xFFFFFFFF
#: 2^32 * golden ratio — the Weyl increment decorrelating fold steps.
_GOLDEN = 0x9E3779B9
#: A second odd constant keying the high word independently.
_GOLDEN2 = 0x517CC1B7
#: Namespace constant separating block streams from pixel streams.
_BLOCK_NS = 0xB10C_B10C
#: Counter stride between logical dimensions of one stream.
_DIM_STRIDE = 16
#: Most words one launch of the kernel's fold entry takes (block_key's).
MAX_WORDS = 3

#: Kernel launches since the last reset_launches(), by entry of
#: csrc/sampler_hash.cu. The wrapper adds one where it launches the kernel
#: and nowhere else.
LAUNCHES = {"sampler_fold": 0, "sampler_uniform": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer, lowbias32 variant."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def _mix2(x: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer, murmur3 constants (independent of `_mix`)."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _u32(data, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(data, dtype=torch.int64, device=like.device) & _M32


def fold(key: torch.Tensor, data) -> torch.Tensor:
    """Mix `data` (broadcasting against key[..., 0]) into the two-word key
    (..., 2)."""
    d = _u32(data, key)
    lo = _mix(key[..., 0] ^ ((_mul(d, _GOLDEN) + 0x85EBCA6B) & _M32))
    hi = _mix2(key[..., 1] ^ ((_mul(d, _GOLDEN2) + 0x27220A95) & _M32) ^ lo)
    lo, hi = torch.broadcast_tensors(lo, hi)
    return torch.stack([lo, hi], dim=-1)


def fold_chain_plain(key: torch.Tensor, words) -> torch.Tensor:
    """`words` folded into `key` in order, in plain torch on key's device."""
    for w in words:
        key = fold(key, w)
    return key


def _to_unit(h: torch.Tensor) -> torch.Tensor:
    """uint32 -> [0, 1) float32 from the top 24 bits (exact in f32)."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform_plain(key: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """uniform's draws in plain torch on key's device."""
    ctr = dim * _DIM_STRIDE + torch.arange(n, device=key.device)
    return _to_unit(fold(key[..., None, :], ctr)[..., 1])


def _chain(key: torch.Tensor | None, words, device=None) -> torch.Tensor:
    """`words` folded into `key` in order (None: the zero state on
    `device`): one kernel launch on a CUDA device, the plain version on
    another."""
    dev = key.device if key is not None else torch.device(device or "cpu")
    if dev.type == "cuda":
        return _fold_kernel(key, words, dev)
    if key is None:
        key = torch.zeros(2, dtype=torch.int64, device=dev)
    out = fold_chain_plain(key, words)
    count("sampler_rows.plain", out.numel() // 2)
    return out


def seed_key(seed: int, device=None) -> torch.Tensor:
    """The (2,) root state of `blink`'s `_seed_key(jax.random.key(seed))`:
    the key data of a threefry key is [seed >> 32, seed & 0xFFFFFFFF],
    folded in order into the zero state."""
    with span("sampler"):
        return _chain(None, ((seed >> 32) & _M32, seed & _M32), device)


def pixel_key(root: torch.Tensor, pixel_id, sample_idx) -> torch.Tensor:
    """Key per (pixel, spp-sample) pair: (N, 2)."""
    with span("sampler"):
        return _chain(root, (pixel_id, sample_idx))


def bounce_key(pk: torch.Tensor, bounce) -> torch.Tensor:
    """Key for one path vertex of a pixel-sample stream."""
    with span("sampler"):
        return _chain(pk, (bounce,))


def block_key(root: torch.Tensor, block_id, sample_idx) -> torch.Tensor:
    """Key per (image-block, spp-sample) stream: (N, 2). Blocks of 4x32
    pixels share one NEE light sample (render.integrators)."""
    with span("sampler"):
        return _chain(root, (_BLOCK_NS, block_id, sample_idx))


def uniform(key: torch.Tensor, n: int = 1, dim: int = 0) -> torch.Tensor:
    """(..., n) uniform [0,1) draws of logical dimension `dim` of the
    streams `key` (..., 2)."""
    if n > _DIM_STRIDE:
        raise ValueError(
            f"uniform() draw of {n} > {_DIM_STRIDE} scalars would alias the "
            f"next dimension's counters; split across dims instead"
        )
    with span("sampler"):
        if key.is_cuda:
            return _uniform_kernel(key, n, dim)
        count("sampler_rows.plain", key.numel() // 2)
        return uniform_plain(key, n, dim)


# ---------------------------------------------------------------- kernel


def _lib():
    """sampler_hash.cu's library, built at first use, typed."""
    from blink_torch.kernels import _build

    return typed(_build.load("sampler_hash"))


def typed(lib):
    """`lib`, a loaded build of sampler_hash.cu, with its entry points'
    argument types set."""
    if not getattr(lib, "_blink_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.sampler_fold_launch.argtypes = [
            ptr, i64, ctypes.POINTER(ptr), ctypes.POINTER(i64), ctypes.POINTER(ctypes.c_uint),
            i32, ptr, i64, ptr]
        lib.sampler_uniform_launch.argtypes = [ptr, i64, i32, ctypes.c_uint, ptr, i64, ptr]
        lib.sampler_fold_launch.restype = lib.sampler_uniform_launch.restype = i32
        lib._blink_typed = True
    return lib


def _key_rows(key: torch.Tensor) -> tuple[int | None, int]:
    """(rows, row stride) of a key the kernel reads in place: (None, 0) for
    a (2,) root, (N, its stride) for (N, 2) rows of int64 words."""
    if key.dtype != torch.int64 or key.dim() not in (1, 2) or key.shape[-1] != 2 \
            or key.stride(-1) != 1:
        raise ValueError(f"sampler kernel: want an int64 key (2,) or (N, 2) with unit column "
                         f"stride, got {key.dtype} {tuple(key.shape)} strides {key.stride()}")
    return (None, 0) if key.dim() == 1 else (key.shape[0], key.stride(0))


def _launch_rows(sizes) -> int | None:
    """The rows of a launch whose key and words have `sizes` rows (None:
    one for all rows)."""
    sized = set(s for s in sizes if s is not None)
    if len(sized) > 1:
        raise ValueError(f"sampler kernel: rows {sorted(sized)} differ")
    return sized.pop() if sized else None


def _fold_kernel(key: torch.Tensor | None, words, dev: torch.device) -> torch.Tensor:
    """fold_chain_plain's key in one launch of the fold entry."""
    if not 1 <= len(words) <= MAX_WORDS:
        raise ValueError(f"sampler kernel: folds 1 to {MAX_WORDS} words, got {len(words)}")
    key_rows, key_stride = _key_rows(key) if key is not None else (None, 0)
    sizes, held = [key_rows], []
    for w in words:
        if torch.is_tensor(w):
            if w.dim() > 1:
                raise ValueError(f"sampler kernel: a word is a scalar or (N,), got "
                                 f"{tuple(w.shape)}")
            w = w.to(device=dev, dtype=torch.int64)
            sizes.append(w.shape[0] if w.dim() else None)
        held.append(w)
    n = _launch_rows(sizes)
    rows = 1 if n is None else n
    out = torch.empty((2,) if n is None else (n, 2), dtype=torch.int64, device=dev)
    if rows == 0:
        return out
    ptrs = (ctypes.c_void_p * MAX_WORDS)()
    strides = (ctypes.c_longlong * MAX_WORDS)()
    values = (ctypes.c_uint * MAX_WORDS)()
    for i, w in enumerate(held):
        if torch.is_tensor(w):
            ptrs[i] = w.data_ptr()
            strides[i] = w.stride(0) if w.dim() else 0
        else:
            values[i] = int(w) & _M32
    err = _lib().sampler_fold_launch(
        None if key is None else key.data_ptr(), key_stride, ptrs, strides, values, len(held),
        out.data_ptr(), rows, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sampler_fold launch failed: cudaError {err}")
    LAUNCHES["sampler_fold"] += 1
    count("sampler_rows.kernel", rows)
    return out


def _uniform_kernel(key: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """uniform_plain's draws in one launch of the uniform entry."""
    rows, stride = _key_rows(key)
    out = torch.empty((*key.shape[:-1], n), dtype=torch.float32, device=key.device)
    if out.numel() == 0:
        return out
    err = _lib().sampler_uniform_launch(key.data_ptr(), stride, n, dim & _M32, out.data_ptr(),
                                        rows or 1,
                                        torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sampler_uniform launch failed: cudaError {err}")
    LAUNCHES["sampler_uniform"] += 1
    count("sampler_rows.kernel", rows or 1)
    return out
