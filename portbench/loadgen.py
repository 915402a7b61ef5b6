"""A dockerd-like client on the standard library's HTTP: an open loop of
image pulls through the agent's blob API, each image's layers requested
at once, each body hashed as it streams in.

A pull is timed from when it was due, not from when it was sent, so a
late generator shows in the latency; how late it ran is reported beside.
An image is taken from a pool of free images when it is due, and goes
back to the pool only once the agent has evicted it (``free``).
"""

from __future__ import annotations

import collections
import hashlib
import http.client
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor, wait

CHUNK = 1 << 20


def get_layer(addr: str, namespace: str, digest: str, timeout: float) -> dict:
    """GET one blob through the agent; the body's SHA-256, its length and
    the status, with the monotonic time the last byte arrived."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    h, n, status = hashlib.sha256(), 0, None
    try:
        conn.request("GET", f"/namespace/{urllib.parse.quote(namespace, safe='')}"
                            f"/blobs/sha256:{digest}")
        resp = conn.getresponse()
        status = resp.status
        while chunk := resp.read(CHUNK):
            h.update(chunk)
            n += len(chunk)
    except OSError as e:
        return {"status": None, "end": None, "bytes": n, "digest": None, "error": repr(e)}
    finally:
        conn.close()
    return {"status": status, "end": time.monotonic(), "bytes": n, "digest": h.hexdigest()}


class LoadGen:
    """``images[k]`` lists image ``k``'s layers as (digest hex, size);
    ``done(k)`` is called once both of an image's layers were served."""

    def __init__(self, addr: str, namespace: str, images: list[list[tuple[str, int]]], done):
        self.addr, self.namespace, self.images, self._done = addr, namespace, images, done
        self._lock = threading.Lock()
        self._free: collections.deque[int] = collections.deque()

    def free(self, k: int) -> None:
        with self._lock:
            self._free.append(k)

    def pull_images(self, ks: list[int], timeout: float) -> list[dict]:
        """Every layer of images ``ks`` at once, untimed (warm-up)."""
        layers = [layer for k in ks for layer in self.images[k]]
        with ThreadPoolExecutor(len(layers)) as ex:
            return list(ex.map(lambda layer: get_layer(self.addr, self.namespace, layer[0],
                                                       timeout), layers))

    def window(self, t0: float, dues: list[float], pool: list[int], seconds: float,
               grace: float) -> tuple[list[dict], list[float]]:
        """Offer each due image at ``t0 + due``; wait for the pulls up to
        ``grace`` seconds past the window's close. Returns a record for
        every layer pull due (times from ``t0``) and how late each image
        was offered."""
        with self._lock:
            self._free = collections.deque(pool)
        records: list[dict] = []
        late: list[float] = []
        futures = []
        timeout = seconds + grace
        ex = ThreadPoolExecutor(2 * max(len(l) for l in self.images) * max(1, len(pool)))

        def pull(rec: dict, remaining: list[int]) -> None:
            got = get_layer(self.addr, self.namespace, rec["digest_want"], timeout)
            rec.update(status=got["status"], bytes=got["bytes"], digest=got["digest"],
                       end=None if got["end"] is None else got["end"] - t0)
            with self._lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last and all(r["status"] == 200 for r in rec["siblings"]):
                self._done(rec["image"])

        for due in dues:
            delay = t0 + due - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            late.append(time.monotonic() - t0 - due)
            with self._lock:
                k = self._free.popleft() if self._free else None
            layers = self.images[k] if k is not None else self.images[0]
            recs = [{"image": k, "layer": j, "due": due, "size": size, "digest_want": d,
                     "status": None, "end": None, "bytes": 0, "digest": None}
                    for j, (d, size) in enumerate(layers)]
            records.extend(recs)
            if k is None:  # no free image: the pull fails (the pool is too small)
                continue
            remaining = [len(recs)]
            for rec in recs:
                rec["siblings"] = recs
                futures.append(ex.submit(pull, rec, remaining))
        wait(futures, timeout=max(0.0, t0 + seconds + grace - time.monotonic()))
        ex.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            out = [{k: v for k, v in r.items() if k not in ("siblings", "digest_want")}
                   for r in records]
        return out, late
