"""Checkpoint and resume of a fit through safetensors (counterpart of
`blink.ckpt`): the parameters and the optimizer's state every K steps of
`fit`; a resumed fit equals an unbroken one, since the sampler is keyed by
seed and pixel, not by step.

Tensors are keyed by their path in the nested dicts and lists they come in
(`params.albedo`, `opt.state.0.exp_avg` from `torch.optim.Adam.state_dict()`,
`meta.step`), so loading into a template with another `optimize` tuple or
another optimizer fails on the missing key or the wrong shape instead of
filling the wrong tensor. Leaves that are not tensors (Adam's lr, betas,
eps) are hyperparameters: the template keeps its own. A checkpoint of
`blink` (optax's state) does not load here, nor one of this package in
`blink`: the two optimizers keep different state.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from safetensors.torch import load_file, save_file


def _flatten(tree: Any, prefix: str) -> dict[str, torch.Tensor]:
    if torch.is_tensor(tree):
        return {prefix: tree.detach().cpu().contiguous()}
    items = tree.items() if isinstance(tree, Mapping) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    flat: dict[str, torch.Tensor] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}.{k}"))
    return flat


def _unflatten(tree_like: Any, flat: dict[str, torch.Tensor], prefix: str) -> Any:
    if torch.is_tensor(tree_like):
        if prefix not in flat:
            raise KeyError(
                f"checkpoint is missing leaf '{prefix}' — saved with a "
                f"different param set / optimizer? (have: {sorted(flat)[:8]}…)"
            )
        t = flat[prefix]
        if t.shape != tree_like.shape:
            raise ValueError(
                f"checkpoint leaf '{prefix}' has shape {tuple(t.shape)}, template "
                f"expects {tuple(tree_like.shape)}"
            )
        return t.to(device=tree_like.device, dtype=tree_like.dtype)
    if isinstance(tree_like, Mapping):
        return type(tree_like)(
            (k, _unflatten(v, flat, f"{prefix}.{k}")) for k, v in tree_like.items())
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(
            _unflatten(v, flat, f"{prefix}.{i}") for i, v in enumerate(tree_like))
    return tree_like


def save_ckpt(path: str, step: int, params: Any, opt_state: Any) -> None:
    flat = {"meta.step": torch.tensor([step], dtype=torch.int64)}
    flat.update(_flatten(params, "params"))
    flat.update(_flatten(opt_state, "opt"))
    save_file(flat, path)


def load_ckpt(path: str, params_like: Any, opt_state_like: Any):
    """(step, params, opt_state) shaped like the templates: the file's
    tensors, checked key by key and shape by shape against the templates,
    on each template tensor's device and dtype."""
    flat = load_file(path)
    step = int(flat["meta.step"][0])
    return (step, _unflatten(params_like, flat, "params"),
            _unflatten(opt_state_like, flat, "opt"))
