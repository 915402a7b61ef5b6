"""Tracker: peer membership + metainfo proxy.

The port's copy of ``kraken_tpu.tracker``.

Mirrors uber/kraken ``tracker/`` (trackerserver announce endpoint,
Redis-backed peerstore with TTL, peerhandoutpolicy, metainfo proxy caching
origin responses) -- upstream paths, unverified; SURVEY.md SS2.4/SS3.4.
"""
