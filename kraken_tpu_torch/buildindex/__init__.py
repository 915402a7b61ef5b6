"""Build-index: tag -> manifest-digest mapping + cross-cluster replication.

Mirrors uber/kraken ``build-index/`` (tagserver HTTP API, tagstore with
disk cache + backend writeback, durable tag replication to remote
clusters, tag-type dependency resolution) -- upstream paths, unverified;
SURVEY.md SS2.4. The port's copy of ``kraken_tpu.buildindex``, served by
the port's own HTTP/1.1 (``utils/http_lite``); its tag files, retry
database and backend layout are the reference's.
"""
