"""The port's SSM (mamba2) and hybrid (jamba) families against
``repro.models.ssm``, ``repro.models.paged`` and the JAX Engine, fp32.

- ``_causal_conv``, ``_ssd_scan`` (chunks 4 / 16 / 64; also against
  ``test_ssd_oracle``'s naive recurrence) and ``decode_mamba_block``
  within 1e-6 of max|reference|; ``mamba_block`` at the mamba2 smoke
  config within 1e-5.
- ``paged_prefill_chunk`` on a slots-wide SSM state (a full chunk, then
  one with ``n_valid < C``, into slot 2 of 4): the valid rows' logits
  within 1e-5 of JAX's, the admitted row's state and conv within 1e-6,
  every other slot's rows bitwise unchanged; ``reset_slot_state`` zeroes
  one row only.
- ``forward`` logits within 1e-4 of JAX's on both smoke configs;
  ``build_layout`` equal to JAX's (``tests/test_torch_moe.py``).
- Engine token streams and counters equal the JAX Engine's at slots = 4:
  mamba2 dense, 2:4 and gather 2:4, jamba 2:4; ``Engine.kv_bytes`` equal
  to JAX's for internlm2, mamba2 and jamba.
- ``prepare``: int8 codes and scales bitwise JAX's, the static
  calibration's site count JAX's; a model axis > 1 refuses both families.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.configs import get_smoke_config
from repro.models import init_params
from repro.models import paged as jpaged
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro_torch import serving as tserving
from repro_torch.launch import shardings
from repro_torch.models import paged as tpaged
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from test_ssd_oracle import _naive_ssm
from torch_parity import assert_scaled_close, port_config, port_params

MAMBA, JAMBA = "mamba2_2_7b", "jamba_1_5_large_398b"


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), **{"dtype": "float32", **kw})


@functools.lru_cache(maxsize=None)
def _params(arch):
    """Seeded numpy weights in the JAX package's fp32 dense param tree of
    one smoke config (its shapes from ``jax.eval_shape``: compiling
    jamba's init takes seconds): a leaf of fan-in K drawn from N(0, 1/K),
    the norms' gammas, ``dt_bias`` and ``A_log`` 0 and ``D`` 1, as JAX
    initialises them.  ``prepare`` converts them to a serving layout."""
    cfg = _cfg(arch)
    shapes = jax.eval_shape(lambda key: init_params(key, cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    consts = {"gamma": 0.0, "dt_bias": 0.0, "A_log": 0.0, "D": 1.0}

    def leaf(path, sds):
        name = getattr(path[-1], "key", None)
        if name in consts:
            return jnp.full(sds.shape, consts[name], sds.dtype)
        fan_in = sds.shape[-1] if name == "embed" else sds.shape[-2]
        return jnp.asarray(rng.standard_normal(sds.shape) * fan_in ** -0.5, sds.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _mamba_params(cfg, seed):
    """One Mamba layer's JAX params with seeded dt_bias, A_log and D (JAX
    initialises them to constants), and the port's copy."""
    rng = np.random.default_rng(seed)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), cfg)
    nh = cfg.ssm_heads
    for k, v in (("dt_bias", rng.normal(size=nh)), ("A_log", rng.normal(size=nh) * 0.5),
                 ("D", rng.normal(size=nh))):
        jp[k] = jnp.asarray(v, jnp.float32)
    return jp, port_params(jp)


# ------------------------------------------------------------ the block
def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    xbc = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w))
    assert_scaled_close(tssm._causal_conv(_t(xbc), _t(w)), want, 1e-6)


@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_ssd_scan_matches_reference_and_naive(chunk):
    b, t, nh, hd, ds = 2, 64, 3, 8, 16
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((b, t, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((b, t, ds)).astype(np.float32)
    Cm = rng.standard_normal((b, t, ds)).astype(np.float32)
    ref_y, ref_h = _naive_ssm(x, dt, A, Bm, Cm)          # float64
    y, h = tssm._ssd_scan(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    jy, jh = jax.jit(jssm._ssd_scan, static_argnums=5)(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                                       chunk)
    # the port within 1e-6 of the float64 recurrence, and within 1e-6 of
    # JAX's fp32 scan plus JAX's own distance from it (at chunk 64 the
    # within-chunk cumsum reaches ~60 and XLA sums it in another order than
    # torch: JAX's scan is then 1.2e-6 off the float64 recurrence)
    for got, want, ref in ((y, jy, ref_y), (h, jh, ref_h)):
        assert_scaled_close(got, ref, 1e-6)
        assert_scaled_close(got, want, 1e-6 + assert_scaled_close(want, ref, 1e-4))
    # from a carried state: the second half after the first half's state
    first = [_t(a[:, :t // 2]) for a in (x, dt)] + [_t(A)] + [_t(a[:, :t // 2]) for a in (Bm, Cm)]
    second = [_t(a[:, t // 2:]) for a in (x, dt)] + [_t(A)] + [_t(a[:, t // 2:]) for a in (Bm, Cm)]
    y2, h2 = tssm._ssd_scan(*second, chunk, h0=tssm._ssd_scan(*first, chunk)[1])
    assert_scaled_close(y2, ref_y[:, t // 2:], 1e-6)
    assert_scaled_close(h2, ref_h, 1e-6)
    with pytest.raises(ValueError, match="not a multiple"):
        tssm._ssd_scan(*[a[:, :28] if a.ndim > 1 else a for a in first], 16)


def test_decode_mamba_block_matches_reference():
    cfg = _cfg(MAMBA)
    jp, tp = _mamba_params(cfg, 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    cache = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in tssm.init_ssm_cache(port_config(cfg), 3).items()}
    jo, jc = jax.jit(jssm.decode_mamba_block, static_argnums=3)(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()}, cfg)
    to, tc = tssm.decode_mamba_block(tp, _t(x), {k: _t(v) for k, v in cache.items()},
                                     port_config(cfg))
    assert_scaled_close(to, jo, 1e-6)
    for k in ("conv", "state"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert_scaled_close(tc[k], jc[k], 1e-6)


def test_mamba_block_matches_reference():
    cfg = _cfg(MAMBA)
    jp, tp = _mamba_params(cfg, 2)
    x = np.random.default_rng(2).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want = jax.jit(jssm.mamba_block, static_argnums=(2, 3))(jp, jnp.asarray(x), cfg, 16)
    assert_scaled_close(tssm.mamba_block(tp, _t(x), port_config(cfg), chunk=16), want, 1e-5)


# ------------------------------------------------------------ the paged model
SLOTS, SLOT, BLOCK_LEN, CHUNK = 4, 2, 8, 8


def _jax_layers(cfg):
    """(stage, slot key, super-block, repeat, slot) of every layer in the
    port's order: where its leaves sit in the JAX package's stacked caches."""
    for s, st in enumerate(jtr.build_layout(cfg)):
        for i in range(st.count):
            for j, slot in enumerate(st.slots):
                for r in range(slot.repeat):
                    yield s, f"slot{j}", i, r, slot


def _random_ssm_caches(cfg, jcaches, tcaches, rng):
    """Fill every Mamba layer's slots-wide state with seeded values, the
    same in the JAX package's caches and the port's; returns the JAX
    caches."""
    for (s, key, i, r, slot), tc in zip(_jax_layers(cfg), tcaches):
        if slot.mixer != "mamba":
            continue
        leaves = jcaches[s][key]
        for k in ("conv", "state"):
            v = rng.standard_normal(tc[k].shape).astype(np.float32)
            tc[k].copy_(_t(v))
            leaves[k] = leaves[k].at[i, r].set(jnp.asarray(v))
    return jcaches


def _index(jcaches, cfg):
    """The JAX caches' per-layer view in the port's order."""
    return [{k: np.asarray(v[i, r]) for k, v in jcaches[s][key].items()}
            for s, key, i, r, _ in _jax_layers(cfg)]


def test_paged_prefill_chunk_advances_only_its_slot():
    jcfg = _cfg(MAMBA)
    tcfg = port_config(jcfg)
    jp = _params(MAMBA)
    tp = port_params(jp)
    rng = np.random.default_rng(3)
    nb = 2 * SLOTS + 1
    tcaches = tpaged.init_paged_caches(tcfg, nb, BLOCK_LEN, SLOTS)
    jcaches = _random_ssm_caches(jcfg, jpaged.init_paged_caches(jcfg, nb, BLOCK_LEN, SLOTS),
                                 tcaches, rng)
    tokens = rng.integers(1, jcfg.vocab_size, 2 * CHUNK)
    table = np.array([[1, 2]], np.int32)
    for pos0, n_valid in ((0, CHUNK), (CHUNK, 5)):
        before = [{k: v.clone() for k, v in c.items()} for c in tcaches]
        tok = tokens[None, pos0:pos0 + CHUNK]
        jl, jcaches = jpaged.paged_prefill_chunk(
            jp, jcaches, jnp.asarray(tok), jnp.int32(pos0), jnp.asarray(table),
            jnp.int32(n_valid), jnp.int32(SLOT), jcfg, BLOCK_LEN)
        tl, tcaches = tpaged.paged_prefill_chunk(
            tp, tcaches, torch.from_numpy(tok), pos0, torch.from_numpy(table), n_valid,
            tcfg, BLOCK_LEN, slot_idx=SLOT)
        assert_scaled_close(tl[0, :n_valid], jl[0, :n_valid], 1e-5)
        for slot, got, old, want in zip(ttr.layer_slots(tcfg), tcaches, before,
                                        _index(jcaches, jcfg)):
            if slot.mixer != "mamba":
                continue
            others = [r for r in range(SLOTS) if r != SLOT]
            for k in ("conv", "state"):
                assert torch.equal(got[k][others], old[k][others])
                assert_scaled_close(got[k][SLOT], want[k][SLOT], 1e-6)
    with pytest.raises(ValueError, match="slot_idx"):
        tpaged.paged_prefill_chunk(tp, tcaches, torch.from_numpy(tokens[None, :CHUNK]), 0,
                                   torch.from_numpy(table), CHUNK, tcfg, BLOCK_LEN)


def test_reset_slot_state_zeroes_one_row():
    cfg = port_config(_cfg(JAMBA))
    caches = tpaged.init_paged_caches(cfg, 3, BLOCK_LEN, SLOTS)
    for c in caches:
        for v in c.values():
            v.normal_()
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    caches = tpaged.reset_slot_state(caches, 1)
    for slot, c, old in zip(ttr.layer_slots(cfg), caches, before):
        for k, v in c.items():
            if slot.mixer == "mamba":
                assert not v[1].any()
                assert torch.equal(v[[0, 2, 3]], old[k][[0, 2, 3]])
            else:
                assert torch.equal(v, old[k])      # block pools: untouched


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_forward_matches_reference(arch):
    jcfg = _cfg(arch)
    jp = _params(arch)
    tokens = np.random.default_rng(4).integers(1, jcfg.vocab_size, (2, 16))
    want = jax.jit(jtr.forward, static_argnums=1)(jp, jcfg, jnp.asarray(tokens))
    got = ttr.forward(port_params(jp), port_config(jcfg), torch.from_numpy(tokens))
    assert_scaled_close(got, want, 1e-4)


# ------------------------------------------------------------ serving
def _prepared(arch, **spec_kw):
    base = dict(slots=SLOTS, max_len=64, block_len=BLOCK_LEN, prefill_chunk=8)
    base.update(spec_kw)
    jspec = jserving.ServingSpec(**base)
    jcfg = jspec.apply_to(_cfg(arch))
    jp = _params(arch)
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**base),
                             cfg=port_config(jcfg), device="cpu")
    return jserving.prepare(jp, jspec, cfg=jcfg), tprep


def _counters(rep):
    return (rep.total, rep.completed, rep.model_calls, rep.prefill_chunks,
            rep.decode_calls, rep.evictions, rep.max_blocks_in_use, rep.num_blocks,
            [(s.rid, s.prompt_len, s.new_tokens, s.done_iter) for s in rep.stats])


@pytest.mark.parametrize("arch,layout,sparsity", [
    (MAMBA, "dense", None), (MAMBA, "compressed", (2, 4)), (MAMBA, "gather", (2, 4)),
    (JAMBA, "compressed", (2, 4))])
def test_engine_token_streams_equal_reference(arch, layout, sparsity):
    jprep, tprep = _prepared(arch, layout=layout, sparsity=sparsity)
    vocab = tprep.cfg.vocab_size
    # whole chunks: one prefill shape for the JAX package's jit to compile
    trace = dict(seed=0, num_requests=6, vocab_size=vocab, prompt_mix=((8, 0.5), (16, 0.5)))
    jrep = jserving.Engine(jprep).run(jserving.make_poisson_trace(**trace))
    trep = tserving.Engine(tprep).run(tserving.make_poisson_trace(**trace))
    assert [s.tokens for s in trep.stats] == [s.tokens for s in jrep.stats]
    assert _counters(trep) == _counters(jrep)


@pytest.mark.parametrize("arch", ["internlm2_1_8b", MAMBA, JAMBA])
def test_kv_bytes_equal_reference(arch):
    jprep, tprep = _prepared(arch, layout="dense")
    jeng, teng = jserving.Engine(jprep), tserving.Engine(tprep)
    assert teng.kv_bytes() == jeng.kv_bytes() > 0
    with tprep.activate():
        made = teng._fresh_caches()
    assert teng.kv_bytes() == sum(t.numel() * t.element_size() for c in made
                                  for t in c.values())


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flat(v, path + (i,))]
    return [(path, tree)]


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_prepare_quantizes_and_calibrates_like_the_reference(arch):
    """Static int8 2:4: every leaf's int8 codes and scales bitwise JAX
    ``prepare``'s, JAX's calibrated site count, every act_scale within 1e-5
    of JAX's."""
    spec = dict(layout="compressed", sparsity=(2, 4), qdtype="int8", static_scales=True,
                slots=SLOTS, max_len=64, block_len=BLOCK_LEN)
    jcfg = jserving.ServingSpec(**spec).apply_to(_cfg(arch))
    jp = _params(arch)
    tokens = np.random.default_rng(5).integers(1, jcfg.vocab_size, (SLOTS, 16))
    jprep = jserving.prepare(jp, jserving.ServingSpec(**spec), cfg=jcfg,
                             calib_tokens=jnp.asarray(tokens))
    tprep = tserving.prepare(port_params(jp), tserving.ServingSpec(**spec),
                             cfg=port_config(jcfg), calib_tokens=torch.from_numpy(tokens),
                             device="cpu")
    assert tprep.calibrated_sites == jprep.calibrated_sites > 0
    want, got = _flat(port_params(jprep.params)), _flat(tprep.params)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert sum(g.dtype == torch.int8 for _, g in got) > 0
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype, k
        if k[-1] == "act_scale":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, err_msg=str(k))
        else:
            assert torch.equal(g, w), k


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_mesh_refuses_the_ssm_families(arch):
    with pytest.raises(ValueError, match="Queue 1 item 12"):
        shardings.check_config(port_config(_cfg(arch)), 2)
    shardings.check_config(port_config(_cfg("internlm2_1_8b")), 2)
