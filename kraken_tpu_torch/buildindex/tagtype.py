"""Tag semantics per namespace: dependency resolution for replication.

Mirrors uber/kraken ``build-index/tagtype`` (``docker`` tags depend on the
manifest's referenced blobs so a remote cluster can pre-fetch them;
``default`` tags have no dependencies) -- upstream path, unverified;
SURVEY.md SS2.4. The port's copy of ``kraken_tpu.buildindex.tagtype``.
"""

from __future__ import annotations

import json

from kraken_tpu_torch.core.digest import Digest


def docker_manifest_dependencies(manifest_bytes: bytes) -> list[Digest]:
    """Blob digests referenced by a docker image manifest (config + layers;
    for manifest lists, the per-platform manifest digests)."""
    doc = json.loads(manifest_bytes)
    deps: list[Digest] = []
    if "layers" in doc:  # schema2 manifest
        if "config" in doc:
            deps.append(Digest.parse(doc["config"]["digest"]))
        deps.extend(Digest.parse(l["digest"]) for l in doc["layers"])
    elif "manifests" in doc:  # manifest list
        deps.extend(Digest.parse(m["digest"]) for m in doc["manifests"])
    return deps


class DependencyResolver:
    """Resolve a tag's blob dependency list given its manifest digest.

    ``kind="docker"``: fetch the manifest blob from the origin cluster and
    parse its references. ``kind="default"``: the tagged digest itself is
    the only dependency.
    """

    def __init__(self, origin_cluster=None, kind: str = "docker"):
        if kind not in ("docker", "default"):
            raise ValueError(f"unknown tag type {kind!r}")
        self.kind = kind
        self.origin_cluster = origin_cluster

    async def resolve(self, namespace: str, tag: str, d: Digest) -> list[Digest]:
        if self.kind == "default" or self.origin_cluster is None:
            return [d]
        try:
            manifest = await self.origin_cluster.download(namespace, d)
            return [d, *docker_manifest_dependencies(manifest)]
        except Exception:
            return [d]
