"""Checkpoints: the load side of the conversion artifacts (port of
``repro.checkpoint``; conversion and the training store are not ported
yet)."""

from .store import (ARTIFACT_VERSION, ArtifactError, artifact_manifest,
                    load_artifact)

__all__ = ["ARTIFACT_VERSION", "ArtifactError", "artifact_manifest", "load_artifact"]
