"""The port's N:M format against ``repro.core.nm``: masks, values, meta and
packed meta are bitwise equal on random and on tied weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nm as jnm
from repro_torch.core import nm as tnm


def _weights(kind: str, seed: int, k: int = 64, o: int = 24) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((k, o)).astype(np.float32)
    # heavy ties: few distinct magnitudes, both signs, exact zeros
    return rng.integers(-2, 3, size=(k, o)).astype(np.float32)


CASES = [(kind, n, seed) for kind in ("random", "tied") for n in (1, 2, 4)
         for seed in (0, 1)]


@pytest.mark.parametrize("kind,n,seed", CASES)
def test_compress_bitwise(kind, n, seed):
    w = _weights(kind, seed)
    jc = jnm.compress_nm(jnp.asarray(w), n, 4)
    tc = tnm.compress_nm(torch.from_numpy(w), n, 4)
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(tc.meta.numpy(), np.asarray(jc.meta))
    assert tc.meta.dtype == torch.uint8
    np.testing.assert_array_equal(tnm.pack_meta(tc.meta).numpy(),
                                  np.asarray(jnm.pack_meta(jc.meta)))


@pytest.mark.parametrize("kind,n,seed", CASES)
def test_mask_and_prune_bitwise(kind, n, seed):
    w = _weights(kind, seed)
    jp, jmask = jnm.prune_nm(jnp.asarray(w), n, 4)
    tp, tmask = tnm.prune_nm(torch.from_numpy(w), n, 4)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_bf16_compress_bitwise(n):
    """bf16 weights (the serving dtype) compress to the same bits."""
    w = _weights("random", 3)
    jc = jnm.compress_nm(jnp.asarray(w).astype(jnp.bfloat16), n, 4)
    tc = tnm.compress_nm(torch.from_numpy(w).to(torch.bfloat16), n, 4)
    np.testing.assert_array_equal(tc.values.view(torch.int16).numpy(),
                                  np.asarray(jc.values).view(np.int16))
    np.testing.assert_array_equal(tc.meta.numpy(), np.asarray(jc.meta))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_unpack_and_decompress_match_reference(n):
    w = _weights("random", 4)
    jc = jnm.compress_nm(jnp.asarray(w), n, 4)
    packed = np.array(jnm.pack_meta(jc.meta))
    t_meta = tnm.unpack_meta(torch.from_numpy(packed))
    np.testing.assert_array_equal(t_meta.numpy(), np.asarray(jnm.unpack_meta(packed)))
    dense = tnm.decompress(torch.from_numpy(np.array(jc.values)), t_meta, n, 4)
    np.testing.assert_array_equal(
        dense.numpy(), np.asarray(jnm.decompress(jc.values, jc.meta, n, 4)))
    # lossless on already-pruned weights
    pruned, _ = tnm.prune_nm(torch.from_numpy(w), n, 4)
    np.testing.assert_array_equal(dense.numpy(), pruned.numpy())


def test_pack_meta_rejects_ragged_rows():
    with pytest.raises(ValueError):
        tnm.pack_meta(torch.zeros((6, 4), dtype=torch.uint8))
