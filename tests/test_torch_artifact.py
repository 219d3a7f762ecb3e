"""The port's artifact loader and artifact serving against the JAX package.

The JAX CLI (``python -m repro.launch.convert``) writes the 2:4/int8
artifact of the committed ``tests/fixtures/hf_tiny`` checkpoint into a
tmp dir, as ``tests/test_checkpoint_golden.py`` does.  Then:

- the port's ``load_artifact`` returns the same tree, tensor for tensor
  bitwise (bf16 and fp8 decoded through integer views, no ml_dtypes),
  and ``prepare_from_artifact`` takes the fp8 artifact;
- its loader raises ``ArtifactError`` on a flipped byte, a missing or a
  stray tensor, and a missing or unknown version;
- ``prepare_from_artifact`` + ``Engine`` on the CPU torch tier
  reproduce the golden transcript ``hf_tiny_2_4_int8.json``, up to one
  recorded bf16 tie: at request 0's 7th generated token the JAX logits
  of tokens 103 and 152 are equal in bf16 (top-2 gap 0.0, checked here
  against the JAX engine), JAX's argmax takes the lower id and the port,
  whose bf16 logits differ by up to ~2e-2 of max|logit| (roundings in
  other places), takes 152; every other token equals the golden one.
"""

import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_artifact as j_load_artifact
from repro.launch import convert as convert_cli
from repro_torch import serving as tserving
from repro_torch.checkpoint import ArtifactError, artifact_manifest, load_artifact

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "hf_tiny"
GOLDEN = pathlib.Path(__file__).parent / "fixtures" / "golden" / "hf_tiny_2_4_int8.json"
TRACE_KW = dict(seed=0, num_requests=4, rate=1.0)
# request id -> (generated-token index, the two token ids tied there in
# the JAX bf16 logits)
TIES = {"0": (6, (103, 152))}


def _convert(out, quantize="int8"):
    rc = convert_cli.main(["--input", str(FIXTURE), "--output", str(out),
                           "--arch", "internlm2_1_8b", "--smoke", "--mode", "compressed",
                           "--sparsity", "2:4", "--quantize", quantize])
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _convert(tmp_path_factory.mktemp("golden") / "art")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_load_artifact_is_bitwise_the_reference(artifact):
    jtree, jman = j_load_artifact(artifact)
    ttree, tman = load_artifact(artifact)
    assert tman == jman
    want, got = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert sorted(got) == sorted(want)
    dtypes = set()
    for k, t in got.items():
        a = np.asarray(jax.device_get(want[k]))
        assert isinstance(t, torch.Tensor) and list(t.shape) == list(a.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype), k
        assert t.reshape(-1).view(torch.uint8).numpy().tobytes() == a.tobytes(), k
        dtypes.add(str(t.dtype))
    assert {"torch.bfloat16", "torch.int8", "torch.uint8", "torch.float32"} <= dtypes


def test_fp8_storage_decodes_through_a_byte_view(tmp_path):
    art = _convert(tmp_path / "fp8", quantize="fp8")
    jtree, _ = j_load_artifact(art)
    ttree, _ = load_artifact(art)
    want, got = dict(_leaves(jtree)), dict(_leaves(ttree))
    fp8 = [k for k, t in got.items() if t.dtype == torch.float8_e4m3fn]
    assert fp8
    for k in fp8:
        assert got[k].view(torch.uint8).numpy().tobytes() == \
            np.asarray(want[k]).view(np.uint8).tobytes()
    # the fp8 class is served (tests/test_torch_fp8.py holds its tokens)
    prepared = tserving.prepare_from_artifact(art, device="cpu")
    assert prepared.spec.qdtype == "fp8"
    leaves = [t for _, t in _leaves(prepared.params) if t.dtype == torch.float8_e4m3fn]
    assert len(leaves) == len(fp8) * prepared.cfg.num_layers   # one per stacked layer


def _rewrite(src, dst, *, arrays=None, manifest=None):
    shutil.copytree(src, dst)
    if arrays is not None:
        with np.load(dst / "arrays.npz") as z:
            stored = {k: z[k] for k in z.files}
        np.savez(dst / "arrays.npz", **arrays(stored))
    if manifest is not None:
        m = json.loads((dst / "manifest.json").read_text())
        manifest(m)
        (dst / "manifest.json").write_text(json.dumps(m))
    return dst


def _flip(stored):
    k = sorted(stored)[0]
    a = stored[k].copy()
    a.reshape(-1).view(np.uint8)[0] ^= 0x01
    return {**stored, k: a}


@pytest.mark.parametrize("case,match", [
    ("flipped", "corrupted"), ("missing", "truncated"), ("stray", "does not record"),
    ("version", "reads only version"), ("no_version", "no 'artifact_version'"),
    ("garbage", "unreadable"),
])
def test_loader_raises_on_a_damaged_artifact(artifact, tmp_path, case, match):
    dst = tmp_path / case
    if case == "flipped":
        _rewrite(artifact, dst, arrays=_flip)
    elif case == "missing":
        _rewrite(artifact, dst, arrays=lambda s: {k: v for k, v in s.items()
                                                  if k != sorted(s)[-1]})
    elif case == "stray":
        _rewrite(artifact, dst, arrays=lambda s: {**s, "stray": np.zeros(3)})
    elif case == "version":
        _rewrite(artifact, dst, manifest=lambda m: m.update(artifact_version=2))
    elif case == "no_version":
        _rewrite(artifact, dst, manifest=lambda m: m.pop("artifact_version"))
    else:
        _rewrite(artifact, dst)
        (dst / "arrays.npz").write_bytes(b"not a zip")
    with pytest.raises(ArtifactError, match=match):
        load_artifact(dst)
    with pytest.raises(ArtifactError):
        artifact_manifest(tmp_path / "nowhere")


@pytest.mark.parametrize("key,value", [("static_scales", True), ("kv_qdtype", "int8"),
                                       ("mesh", [1, 2]), ("autotune", True)])
def test_unported_spec_keys_are_refused(artifact, key, value):
    """kv_qdtype and autotune are refused away from their defaults;
    static_scales is ported and becomes the spec's own axis, and so is mesh
    with a model axis only: [1, 2] is accepted, [2, 1] (a data axis) is
    refused."""
    m = artifact_manifest(artifact)
    assert tserving.spec_from_manifest(m) == tserving.ServingSpec(
        layout="compressed", sparsity=(2, 4), qdtype="int8")
    m["spec"][key] = value
    if key in ("static_scales", "mesh"):
        assert tserving.spec_from_manifest(m) == tserving.ServingSpec(
            layout="compressed", sparsity=(2, 4), qdtype="int8",
            **{key: tuple(value) if key == "mesh" else value})
        if key == "mesh":
            m["spec"]["mesh"] = [2, 1]
            with pytest.raises(ValueError, match="data axis > 1 is not ported"):
                tserving.spec_from_manifest(m)
        return
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tserving.spec_from_manifest(m)


def _tokens(engine_cls, prepared, trace):
    return {str(s.rid): [int(t) for t in s.tokens] for s in engine_cls(prepared).run(trace).stats}


def test_port_serves_the_golden_transcript(artifact):
    prepared = tserving.prepare_from_artifact(artifact, device="cpu")
    assert prepared.spec.qdtype == "int8" and prepared.cfg.num_layers == 2
    assert all("torch-reference" in ln for ln in prepared.dispatch_report())
    got = _tokens(tserving.Engine, prepared, tserving.make_poisson_trace(
        vocab_size=prepared.cfg.vocab_size, **TRACE_KW))
    golden = json.loads(GOLDEN.read_text())
    assert golden["trace"] == TRACE_KW
    want = golden["tokens"]
    assert sorted(got) == sorted(want)
    for rid, toks in want.items():
        at, pair = TIES.get(rid, (len(toks), ()))
        assert got[rid][:at] == toks[:at], rid
        if rid in TIES:
            assert toks[at] == min(pair) and got[rid][at] in pair
            assert len(got[rid]) == len(toks)


def test_the_recorded_tie_is_a_tie_in_the_reference(artifact, monkeypatch):
    """The JAX engine's own logits at the recorded position: the two
    token ids are exactly equal in bf16 (top-2 gap 0)."""
    import repro.models.paged as jpaged
    from repro import serving as jserving

    seen = []
    real = jpaged.paged_decode_step

    def spy(params, caches, tokens, *rest, **kw):
        logits, caches = real(params, caches, tokens, *rest, **kw)
        seen.append(np.asarray(logits[:, 0].astype(jnp.float32)))
        return logits, caches

    monkeypatch.setattr(jpaged, "paged_decode_step", spy)
    prepared = jserving.prepare_from_artifact(artifact)
    got = _tokens(jserving.Engine, prepared, jserving.make_poisson_trace(
        vocab_size=prepared.cfg.vocab_size, **TRACE_KW))
    assert got == json.loads(GOLDEN.read_text())["tokens"]
    (rid, (at, (a, b))), = TIES.items()
    # the request's decode logits, slot by slot: find the row whose argmax
    # produced the tied token and whose top-2 are the recorded pair
    tied = [row for logits in seen for row in logits
            if set(np.argsort(row)[-2:].tolist()) == {a, b} and row[a] == row[b]]
    assert tied, "no decode step shows the recorded exact tie"
