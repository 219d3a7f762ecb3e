"""Shared helpers for the parity tests of the PyTorch port
(``tests/test_torch_*.py``): numpy bridges, the tolerance convention of
``tests/test_kernels.py`` (error scaled by max |reference|), and the
JAX-config -> port-config mapping."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


def to_np(t) -> np.ndarray:
    """A torch tensor or JAX array as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def assert_scaled_close(got, want, tol: float) -> float:
    """max|got - want| / max|want| <= tol; returns the scaled error."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))
    assert err <= tol, f"scaled error {err:.3e} > {tol:.1e}"
    return err


def jnp_dtype(name: str):
    import jax.numpy as jnp
    return {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8,
            "float8_e4m3fn": jnp.float8_e4m3fn}[name]


def from_np(a: np.ndarray, dtype: str) -> torch.Tensor:
    """numpy float32 -> torch tensor of ``dtype`` (bf16 rounds the same
    way as ``jnp.asarray(a).astype(jnp.bfloat16)``: to nearest even)."""
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


def port_config(jax_cfg):
    """The port's ModelConfig for a JAX-package ModelConfig."""
    from repro_torch.core.sparse_linear import SparsityConfig
    from repro_torch.models.config import ModelConfig

    kw = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(ModelConfig)
          if f.name != "sparsity"}
    sp = jax_cfg.sparsity
    return ModelConfig(**kw, sparsity=SparsityConfig(n=sp.n, m=sp.m, mode=sp.mode))


def port_params(jax_params):
    """The JAX package's params carried into the port."""
    import jax

    from repro_torch.interop import params_from_numpy
    return params_from_numpy(jax.tree.map(np.asarray, jax_params))


@pytest.fixture
def cuda_device():
    """A CUDA device for tests of the hand-written kernels; skips when this
    machine has none (decided at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")
