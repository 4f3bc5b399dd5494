"""Retry policy: exponential backoff, jitter and a deadline.

Counterpart of `horovod_tpu/faults/retry.py` (own copy).  Env tuning,
global defaults overridable per site::

    HOROVOD_RETRY_MAX_ATTEMPTS / HOROVOD_<SITE>_RETRY_MAX_ATTEMPTS
    HOROVOD_RETRY_BASE_DELAY   / HOROVOD_<SITE>_RETRY_BASE_DELAY    (s)
    HOROVOD_RETRY_MAX_DELAY    / HOROVOD_<SITE>_RETRY_MAX_DELAY     (s)
    HOROVOD_RETRY_MULTIPLIER   / HOROVOD_<SITE>_RETRY_MULTIPLIER
    HOROVOD_RETRY_JITTER       / HOROVOD_<SITE>_RETRY_JITTER  (fraction)
    HOROVOD_RETRY_DEADLINE     / HOROVOD_<SITE>_RETRY_DEADLINE      (s)

The elastic reset (`elastic._reset`) runs its re-rendezvous under
`RetryPolicy.from_env("RESET", ...)`.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Callable, Dict, Optional, Tuple, Type

from ..common import util
from ..common.exceptions import HorovodInternalError

logger = logging.getLogger("horovod_tpu_torch.faults.retry")


def _generic_env() -> Dict[str, Optional[str]]:
    """HOROVOD_RETRY_*: the values every site shares unless it has its
    own."""
    return {"MAX_ATTEMPTS": util.getenv("RETRY_MAX_ATTEMPTS"),
            "BASE_DELAY": util.getenv("RETRY_BASE_DELAY"),
            "MAX_DELAY": util.getenv("RETRY_MAX_DELAY"),
            "MULTIPLIER": util.getenv("RETRY_MULTIPLIER"),
            "JITTER": util.getenv("RETRY_JITTER"),
            "DEADLINE": util.getenv("RETRY_DEADLINE")}


@dataclasses.dataclass
class RetryPolicy:
    """Attempt k (0-based) sleeps ``min(base_delay * multiplier**k,
    max_delay)`` plus up to ``jitter`` of that, for at most
    ``max_attempts`` tries and an optional wall-clock ``deadline`` over
    the whole loop."""

    max_attempts: int = 5
    base_delay: float = 0.5
    max_delay: float = 30.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    seed: Optional[int] = None

    @classmethod
    def from_env(cls, site: str = "", **defaults) -> "RetryPolicy":
        """Most specific wins: HOROVOD_<SITE>_RETRY_* > HOROVOD_RETRY_* >
        `defaults` > the dataclass defaults.  A value that does not parse
        is ignored, as the JAX package's env readers ignore it."""
        base = cls(**defaults)
        generic = _generic_env()

        def read(knob: str, cur, parse):
            site_raw = (util.getenv(f"{site.upper()}_RETRY_{knob}")
                        if site else None)
            for raw in (site_raw, generic[knob]):
                if raw is None:
                    continue
                try:
                    return parse(raw)
                except ValueError:
                    continue  # unparsable: the next source decides
            return cur

        deadline = read("DEADLINE", base.deadline
                        if base.deadline is not None else -1.0, float)
        return cls(
            max_attempts=read("MAX_ATTEMPTS", base.max_attempts, int),
            base_delay=read("BASE_DELAY", base.base_delay, float),
            max_delay=read("MAX_DELAY", base.max_delay, float),
            multiplier=read("MULTIPLIER", base.multiplier, float),
            jitter=read("JITTER", base.jitter, float),
            deadline=None if deadline < 0 else deadline,
            seed=base.seed)

    def backoff(self, attempt: int) -> float:
        """The jitter-free delay after 0-based `attempt`."""
        return min(self.base_delay * self.multiplier ** attempt,
                   self.max_delay)

    def delays(self, rng: Optional[random.Random] = None):
        """The sleeps between attempts (max_attempts - 1 of them)."""
        rng = rng or random.Random(self.seed)
        for k in range(max(0, self.max_attempts - 1)):
            d = self.backoff(k)
            yield d + d * self.jitter * rng.random()

    def run(self, fn: Callable,
            retry_on: Tuple[Type[BaseException], ...] = (Exception,),
            give_up_on: Tuple[Type[BaseException], ...] = (),
            site: str = "retry",
            sleep: Callable[[float], None] = time.sleep):
        """Call `fn()` under this policy.  `give_up_on` errors propagate
        at once; `retry_on` ones are retried until the attempts or the
        deadline run out, and then the last one is raised."""
        start = time.monotonic()
        rng = random.Random(self.seed)
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.max_attempts)):
            try:
                return fn()
            except give_up_on:
                raise
            except retry_on as e:
                last = e
                if attempt >= self.max_attempts - 1:
                    break
                d = self.backoff(attempt)
                d += d * self.jitter * rng.random()
                if (self.deadline is not None
                        and time.monotonic() - start + d > self.deadline):
                    logger.debug("%s: deadline %.1fs exhausted after "
                                 "attempt %d", site, self.deadline,
                                 attempt + 1)
                    break
                logger.warning("%s: attempt %d failed (%s); retrying in "
                               "%.2fs", site, attempt + 1, e, d)
                sleep(d)
        if last is None:
            raise HorovodInternalError(
                f"{site}: retry loop exited with no exception captured")
        raise last
