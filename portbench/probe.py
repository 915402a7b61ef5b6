"""How loaded a process was over a span: its CPU seconds over the wall
(one core is 1.0), and how late a short sleep on its event loop woke."""

from __future__ import annotations

import asyncio
import sys
import time

from portbench.readers import rank

PERIOD_S = 0.05


class LoadProbe:
    """``start()`` and ``stop()`` on the loop it watches."""

    def start(self) -> None:
        self._cpu0, self._t0 = time.process_time(), time.monotonic()
        self._lags: list[float] = []
        self._task = asyncio.ensure_future(self._watch())

    async def _watch(self) -> None:
        while True:
            t = time.monotonic()
            await asyncio.sleep(PERIOD_S)
            self._lags.append(time.monotonic() - t - PERIOD_S)

    def stop(self) -> dict:
        self._task.cancel()
        wall = time.monotonic() - self._t0
        cpu = time.process_time() - self._cpu0
        lags = self._lags or [0.0]
        return {"cpu_s": cpu, "wall_s": wall, "cpu_share": cpu / wall,
                "loop_lag_p99_s": rank(lags, 0.99), "loop_lag_max_s": max(lags)}


def top_modules() -> list[str]:
    """The top-level names of every module this process has loaded."""
    return sorted({m.split(".")[0] for m in list(sys.modules)})
