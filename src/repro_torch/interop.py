"""Carry the JAX package's weights into the port.

The port cannot reproduce ``jax.random`` initialisation, so every parity
check starts from the JAX package's params, mapped to numpy by the
caller (``jax.tree.map(np.asarray, params)``), and hands them here.
This module imports neither ``jax`` nor ``repro``: it sees numpy arrays
only.

- Float arrays keep their dtype.  bf16 arrives as numpy's ``bfloat16``
  extension dtype and crosses as a ``uint16`` view, becoming
  ``torch.bfloat16`` through ``Tensor.view`` (bit-exact, as the JAX
  package's checkpoint store does it); float8_e4m3fn crosses the same way
  as a ``uint8`` view.  Integer arrays (``meta_packed`` uint8, indices)
  keep their dtype.
- Leaves that are already tensors (a loaded conversion artifact) pass
  through.
- A full model tree ``{"embed", "unembed", "final_norm", "stages"}``
  is unstacked: ``stages[s]["slot{j}"]`` leaves carry leading
  ``(count, repeat)`` dims, and the port's ``params["layers"]`` lists
  one dict per layer in the JAX scan order, super-block ``i``, then
  slot ``j``, then repeat ``r``: ``layers[k] = slot_j[i, r]``.  A
  stacked leaf's calibrated ``act_scale`` (one value per stacked layer,
  all equal) becomes each layer's own 0-dim scalar the same way.  An MoE
  layer's ``ffn`` keeps its fp32 ``router`` (d, E) and its expert stacks,
  whose leaves keep their leading E dim (a calibrated stack's
  ``act_scale`` becomes an (E,) vector, all equal).  Any other tree (a
  single linear leaf, a bare dict) converts leaf by leaf.
- ``calib_id`` leaves (the JAX package's calibration tags) are dropped:
  they exist only while a calibration forward runs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.quantize import _CALIB_KEY

__all__ = ["tensor_from_numpy", "params_from_numpy"]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (or scalar) -> tensor, bf16 and fp8 bit-exact."""
    if isinstance(a, torch.Tensor):
        return a if device is None else a.to(device)
    a = np.array(a)    # a writable, contiguous copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items() if k != _CALIB_KEY}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def _index(tree, i: int, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, i, r) for k, v in tree.items() if k != _CALIB_KEY}
    return tree[i, r]


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def params_from_numpy(tree: Any, device=None) -> Any:
    """The JAX package's param tree (numpy or tensor leaves) -> the port's."""
    if not (isinstance(tree, dict) and "stages" in tree):
        return _convert(tree, device)
    out = {k: _convert(v, device) for k, v in tree.items() if k != "stages"}
    layers = []
    for stage in tree["stages"]:
        slots = [stage[f"slot{j}"] for j in range(len(stage))]
        count = _first_leaf(slots[0]).shape[0]
        for i in range(count):
            for slot in slots:
                for r in range(_first_leaf(slot).shape[1]):
                    layers.append(_convert(_index(slot, i, r), device))
    out["layers"] = layers
    return out
