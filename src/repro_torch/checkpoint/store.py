"""Load conversion artifacts (port of the load side of
``repro.checkpoint.store``).

An artifact is what ``python -m repro.launch.convert`` writes: a
directory holding ``arrays.npz`` (every tensor of the prepared params
tree under an ``a::b::#2::w`` path key) and a versioned
``manifest.json`` (model config recipe, the ``ServingSpec`` dict, and
each tensor's true dtype, shape and crc32).  npz cannot hold bfloat16 or
fp8, so those are stored as same-width unsigned integer views; this
module turns them straight into torch dtypes through ``Tensor.view``
(``uint16`` -> ``bfloat16``, ``uint8`` -> ``float8_e4m3fn``), with no
``ml_dtypes``.

Every failure is a loud :class:`ArtifactError`: missing or invalid
manifest, missing or unknown version, unreadable arrays, tensors missing
from or extra to the manifest, a crc32 mismatch, a wrong shape, or a
dtype this loader does not know.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["ARTIFACT_VERSION", "ArtifactError", "artifact_manifest", "load_artifact"]

ARTIFACT_VERSION = 1
ARTIFACT_MANIFEST = "manifest.json"
ARTIFACT_ARRAYS = "arrays.npz"

_PSEP = "::"           # artifact tree-path separator
_IDX = "#"             # list-index marker within a path component

# true dtypes stored as an unsigned integer view of the same width
_VIEW_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


class ArtifactError(RuntimeError):
    """An artifact failed validation at load time."""


def _crc(v: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(v).tobytes())


def _decode(key: str, arr: np.ndarray, true_dt: str) -> torch.Tensor:
    """A stored array -> the tensor of its true dtype, bit for bit."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if true_dt is None or str(arr.dtype) == true_dt:
        return t
    dt = _VIEW_DTYPES.get(true_dt)
    if dt is None or dt.itemsize != arr.dtype.itemsize or arr.dtype.kind != "u":
        raise ArtifactError(f"artifact tensor {key!r}: cannot decode {arr.dtype} "
                            f"storage as {true_dt}")
    return t.view(dt)


def _unflatten_named(flat: Dict[str, Any]) -> Any:
    """``a::b::#2::w`` keys -> the nested dict / list tree they name."""
    root: Dict[str, Any] = {}
    for key in sorted(flat):
        parts = key.split(_PSEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = flat[key]

    def _fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith(_IDX) for k in node):
            idx = sorted(int(k[len(_IDX):]) for k in node)
            if idx != list(range(len(node))):
                raise ArtifactError(f"artifact list indices {idx} are not "
                                    f"contiguous — truncated artifact?")
            return [_fix(node[f"{_IDX}{i}"]) for i in idx]
        return {k: _fix(v) for k, v in node.items()}

    return _fix(root)


def artifact_manifest(path) -> Dict[str, Any]:
    """Read and validate (version only) an artifact's manifest."""
    path = Path(path)
    mf = path / ARTIFACT_MANIFEST
    if not mf.exists():
        raise ArtifactError(f"{path} is not an artifact: no {ARTIFACT_MANIFEST}")
    try:
        manifest = json.loads(mf.read_text())
    except json.JSONDecodeError as e:
        raise ArtifactError(f"artifact manifest {mf} is corrupted "
                            f"(invalid JSON: {e})") from e
    if "artifact_version" not in manifest:
        raise ArtifactError(
            f"artifact manifest {mf} has no 'artifact_version' field — "
            f"not a conversion artifact, or written by a broken tool")
    v = manifest["artifact_version"]
    if v != ARTIFACT_VERSION:
        raise ArtifactError(
            f"artifact {path} has version {v}; this build reads only "
            f"version {ARTIFACT_VERSION} — re-run the converter")
    return manifest


def load_artifact(path) -> Tuple[Any, Dict[str, Any]]:
    """Load a conversion artifact -> ``(params, manifest)``.

    ``params`` keeps the artifact's own tree (the JAX package's layout:
    ``stages`` leaves carry the stacked ``(count, repeat)`` dims), with
    CPU tensors as leaves; ``serving.prepare_from_artifact`` unstacks it
    into the port's per-layer list."""
    path = Path(path)
    manifest = artifact_manifest(path)
    expected = manifest.get("tensors", {})
    try:
        with np.load(path / ARTIFACT_ARRAYS, allow_pickle=False) as z:
            stored = {k: z[k] for k in z.files}
    except Exception as e:  # zipfile/OSError/ValueError: all mean corrupt
        raise ArtifactError(
            f"artifact arrays {path / ARTIFACT_ARRAYS} are unreadable "
            f"({type(e).__name__}: {e}) — corrupted or truncated") from e
    missing = sorted(set(expected) - set(stored))
    if missing:
        raise ArtifactError(
            f"artifact {path} is truncated: manifest lists tensors the "
            f"arrays file lacks: {missing[:5]}{'...' if len(missing) > 5 else ''}")
    extra = sorted(set(stored) - set(expected))
    if extra:
        raise ArtifactError(
            f"artifact {path} carries tensors the manifest does not "
            f"record: {extra[:5]}{'...' if len(extra) > 5 else ''}")
    flat = {}
    for k, rec in expected.items():
        arr = stored[k]
        if _crc(arr) != rec["crc32"]:
            raise ArtifactError(f"artifact tensor {k!r} is corrupted: stored bytes "
                                f"do not match the manifest crc32")
        t = _decode(k, arr, rec.get("dtype"))
        if list(t.shape) != rec["shape"]:
            raise ArtifactError(f"artifact tensor {k!r} has shape {list(t.shape)}, "
                                f"manifest says {rec['shape']}")
        flat[k] = t
    return _unflatten_named(flat), manifest
