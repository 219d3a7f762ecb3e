"""The port's quantizers against ``repro.core.quantize``.

Every code and scale is held bitwise: the port repeats the JAX
formulation operation for operation (fp32 absmax, divide by the floored
scale, clip to +-qmax before the cast, int8 round half to even), so the
int8 codes, the fp8 codes (compared as bytes) and the scales must be
identical, including all-zero rows and channels, exact .5 ties and
values beyond qmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core.sparse_linear import SparsityConfig as JSp
from repro.core.sparse_linear import convert_layout as j_convert
from repro_torch.core import quantize as tq
from repro_torch.core.sparse_linear import SparsityConfig as TSp
from repro_torch.core.sparse_linear import convert_layout as t_convert
from repro_torch.core.sparse_linear import is_linear_leaf

QDTYPES = {"int8": (jnp.int8, torch.int8), "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _bytes(a) -> np.ndarray:
    """Codes as raw bytes (numpy has no fp8 of its own)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy() if a.element_size() == 1 \
            else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _hard_rows(seed: int, k: int = 64) -> np.ndarray:
    """Rows that probe the edges: random, an all-zero row (an idle slot),
    exact .5 ties against a power-of-two absmax, and large outliers."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, k)).astype(np.float32)
    x[1] = 0.0
    # absmax 127 -> scale 1.0 exactly: codes are the values themselves,
    # so .5 ties round half to even (0.5 -> 0, 1.5 -> 2, -2.5 -> -2)
    x[2] = np.resize(np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 127.0],
                              np.float32), k)
    x[3] = rng.standard_normal(k).astype(np.float32) * 1e4
    x[4, :3] = [1e-30, -1e-30, 0.0]           # denormal-sized values
    x[4, 3:] = 0.0
    x[5] = rng.standard_normal(k).astype(np.float32) * 3e-3
    return x


@pytest.mark.parametrize("qname", list(QDTYPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bitwise(qname, seed):
    jdt, tdt = QDTYPES[qname]
    x = _hard_rows(seed)
    qj, sj = jq.quantize_rows(jnp.asarray(x), dtype=jdt)
    qt, st = tq.quantize_rows(torch.from_numpy(x), tdt)
    assert qt.dtype == tdt and st.dtype == torch.float32 and tuple(st.shape) == (6, 1)
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    if qname == "int8":
        assert qt[2, :5].tolist() == [0, 2, 2, 0, -2]      # half to even


@pytest.mark.parametrize("qname", list(QDTYPES))
@pytest.mark.parametrize("lead", [(), (3,), (2, 1)])
def test_quantize_per_channel_bitwise(qname, lead):
    jdt, tdt = QDTYPES[qname]
    w = np.random.default_rng(len(lead)).standard_normal(lead + (64, 32)).astype(np.float32)
    w[..., 5] = 0.0                            # an all-zero channel
    w[..., 0, 7] = 1e6                         # one huge weight in a channel
    qj, sj = jq.quantize_per_channel(jnp.asarray(w), jdt)
    qt, st = tq.quantize_per_channel(torch.from_numpy(w), tdt)
    assert tuple(st.shape) == lead + (32,)
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tq.dequantize(qt, st).numpy(),
                                  np.asarray(jq.dequantize(qj, sj)))


def test_values_beyond_qmax_are_clipped_before_the_cast():
    x = torch.tensor([[1000.0, -1000.0, 1.0, 0.0]])
    for tdt, top in ((torch.int8, 127), (torch.float8_e4m3fn, 448)):
        q = tq._cast_quantized(x, tdt).float()
        assert q[0, 0] == top and q[0, 1] == -top and torch.isfinite(q).all()
        want = jq._cast_quantized(jnp.asarray(x.numpy()), QDTYPES[
            "int8" if tdt == torch.int8 else "fp8"][0])
        np.testing.assert_array_equal(_bytes(tq._cast_quantized(x, tdt)), _bytes(want))


@pytest.mark.parametrize("mode,n", [("dense", 4), ("compressed", 2), ("compressed", 1)])
@pytest.mark.parametrize("qname", list(QDTYPES))
def test_convert_layout_quantize_matches_reference(mode, n, qname):
    w = np.random.default_rng(7).standard_normal((128, 64)).astype(np.float32)
    want = j_convert({"w": jnp.asarray(w)}, JSp(n=n, m=4, mode=mode), mode, quantize=qname)
    got = t_convert({"w": torch.from_numpy(w)}, TSp(n=n, m=4, mode=mode), mode,
                    quantize=qname)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(_bytes(got[k]), _bytes(want[k]))
    assert tq.quant_dtype(got) == QDTYPES[qname][1]
    assert is_linear_leaf(got) and tq.is_quantized(got)
    # idempotent: an already-quantized leaf passes through unchanged
    again = t_convert(got, TSp(n=n, m=4, mode=mode), mode, quantize=qname)
    assert all(again[k] is got[k] for k in got)


def test_quantize_tree_touches_only_linear_leaves():
    tree = {"embed": torch.randn(16, 8), "norm": {"gamma": torch.zeros(8)},
            "layers": [{"wq": {"w": torch.randn(8, 64)}}]}
    out = tq.quantize_tree(tree, "int8")
    assert out["embed"] is tree["embed"] and out["norm"]["gamma"] is tree["norm"]["gamma"]
    leaf = out["layers"][0]["wq"]
    assert leaf["w"].dtype == torch.int8 and tuple(leaf["scale"].shape) == (64,)
    assert tq.quant_dtype({"w": torch.randn(2, 2)}) is None


def test_qdtype_table():
    assert tq.canonical_qdtype("int8") is torch.int8
    assert tq.canonical_qdtype("fp8") is torch.float8_e4m3fn
    assert tq.qmax("int8") == jq.qmax("int8") and tq.qmax("fp8") == jq.qmax("fp8")
    with pytest.raises(ValueError, match="unknown quantize target"):
        tq.canonical_qdtype("int4")
    with pytest.raises(ValueError, match="not a quantized"):
        tq.canonical_qdtype(torch.float16)
    assert tq.is_quantized_dtype(torch.int8) and not tq.is_quantized_dtype(torch.bfloat16)
