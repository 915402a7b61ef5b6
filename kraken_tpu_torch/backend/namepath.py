"""Blob-name -> backend-path mapping policies (the port's copy of
``kraken_tpu.backend.namepath``).

Mirrors uber/kraken ``lib/backend/namepath`` (``identity``, ``docker_tag``,
``sharded_docker_blob``) -- upstream path, unverified; SURVEY.md SS2.3.
"""

from __future__ import annotations

_PATHERS = {}


def register_pather(name: str):
    def deco(fn):
        _PATHERS[name] = fn
        return fn

    return deco


def get_pather(name: str):
    return _PATHERS[name]


@register_pather("identity")
def identity(root: str, name: str) -> str:
    return f"{root}/{name}" if root else name


@register_pather("sharded_docker_blob")
def sharded_docker_blob(root: str, name: str) -> str:
    """``<root>/<hex[:2]>/<hex[2:4]>/<hex>`` -- spreads blobs across
    prefixes for object stores that shard by key prefix."""
    prefix = f"{root}/" if root else ""
    return f"{prefix}{name[:2]}/{name[2:4]}/{name}"


@register_pather("docker_tag")
def docker_tag(root: str, name: str) -> str:
    """``repo:tag`` -> ``<root>/<repo>/_manifests/tags/<tag>/current/link``."""
    repo, sep, tag = name.rpartition(":")
    if not sep:
        raise ValueError(f"tag name must be repo:tag, got {name!r}")
    prefix = f"{root}/" if root else ""
    return f"{prefix}{repo}/_manifests/tags/{tag}/current/link"
