"""Capped exponential backoff with jitter for retry loops (the JAX
package's ``datasource/backoff.py``; the port keeps its own copy).

* The delay grows ``base x factor^n`` a consecutive failure, capped.
* Jitter REDUCES each delay by up to ``jitter`` of it: retries spread
  across a fleet and never exceed the cap.
* One success resets the streak to the base delay.

The random source is injectable for deterministic tests.
"""

from __future__ import annotations

import random
from typing import Optional


class Backoff:
    """Capped exponential backoff with subtractive jitter.

    Not thread-safe: each retry loop owns one instance and calls it from
    its one thread.
    """

    def __init__(
        self,
        base_s: float,
        cap_s: float = 30.0,
        factor: float = 2.0,
        jitter: float = 0.25,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.base = max(float(base_s), 0.001)
        self.cap = max(float(cap_s), self.base)
        self.factor = max(float(factor), 1.0)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self._rng = rng if rng is not None else random.Random()
        self._failures = 0

    @property
    def failures(self) -> int:
        """Consecutive failures so far (0 after a reset)."""
        return self._failures

    def next_delay(self) -> float:
        """The delay before the next retry; advances the streak. The
        exponent stops growing once the undithered delay reaches the cap:
        an unbounded ``factor ** n`` overflows after some 1,024 failures."""
        raw = self.base * self.factor ** self._failures
        d = min(self.cap, raw)
        if raw < self.cap:
            self._failures += 1
        if self.jitter > 0.0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d

    def reset(self) -> None:
        self._failures = 0
