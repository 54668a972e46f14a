"""Counter-based random streams, bit-identical to `blink.core.sampler`.

Every random decision is a pure function of (seed, pixel or block id,
sample, bounce, dimension): a murmur-finalizer hash chain over a two-word
uint32 state. Torch has no usable uint32 shifts and multiplies, so words are
int64 tensors holding values in [0, 2^32), reduced with `& 0xFFFFFFFF`
after every add and multiply; a multiply goes in two 16-bit halves so that
no product leaves the int64 range. Keys are (..., 2) int64 tensors.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
#: 2^32 * golden ratio — the Weyl increment decorrelating fold steps.
_GOLDEN = 0x9E3779B9
#: A second odd constant keying the high word independently.
_GOLDEN2 = 0x517CC1B7
#: Namespace constant separating block streams from pixel streams.
_BLOCK_NS = 0xB10C_B10C
#: Counter stride between logical dimensions of one stream.
_DIM_STRIDE = 16


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


def seed_key(seed: int, device=None) -> torch.Tensor:
    """The (2,) root state of `blink`'s `_seed_key(jax.random.key(seed))`:
    the key data of a threefry key is [seed >> 32, seed & 0xFFFFFFFF],
    folded in order into the zero state."""
    acc = torch.zeros(2, dtype=torch.int64, device=device)
    for word in ((seed >> 32) & _M32, seed & _M32):
        acc = fold(acc, word)
    return acc


def pixel_key(root: torch.Tensor, pixel_id, sample_idx) -> torch.Tensor:
    """Key per (pixel, spp-sample) pair: (N, 2)."""
    return fold(fold(root, pixel_id), sample_idx)


def bounce_key(pk: torch.Tensor, bounce) -> torch.Tensor:
    """Key for one path vertex of a pixel-sample stream."""
    return fold(pk, bounce)


def block_key(root: torch.Tensor, block_id, sample_idx) -> torch.Tensor:
    """Key per (image-block, spp-sample) stream: (N, 2). Blocks of 4x32
    pixels share one NEE light sample (render.integrators)."""
    return fold(fold(fold(root, _BLOCK_NS), block_id), sample_idx)


def _to_unit(h: torch.Tensor) -> torch.Tensor:
    """uint32 -> [0, 1) float32 from the top 24 bits (exact in f32)."""
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform(key: torch.Tensor, n: int = 1, dim: int = 0) -> torch.Tensor:
    """(..., n) uniform [0,1) draws of logical dimension `dim` of the
    streams `key` (..., 2)."""
    if n > _DIM_STRIDE:
        raise ValueError(
            f"uniform() draw of {n} > {_DIM_STRIDE} scalars would alias the "
            f"next dimension's counters; split across dims instead"
        )
    ctr = dim * _DIM_STRIDE + torch.arange(n, device=key.device)
    return _to_unit(fold(key[..., None, :], ctr)[..., 1])
