"""Docker registry frontend: the v2 API over kraken transfer semantics.

Mirrors uber/kraken ``lib/dockerregistry`` (+ ``transfer``): the agent
serves ``docker pull`` against the P2P plane; the proxy serves ``docker
push`` against the origin cluster + build-index -- upstream paths,
unverified; SURVEY.md SS2.4/SS3.1/SS3.2. The port's copy of
``kraken_tpu.dockerregistry``, served by the port's own HTTP/1.1
(``utils/http_lite``).
"""
