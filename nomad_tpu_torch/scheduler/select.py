"""Selection iterators: candidate limiting + max-score pick.

Capability parity with reference scheduler/select.go.
"""
from __future__ import annotations

from typing import Optional

from .rank import RankedNode


class LimitIterator:
    """Caps how many ranked options are scanned (power-of-two-choices)."""

    def __init__(self, ctx, source, limit: int) -> None:
        self.ctx = ctx
        self.source = source
        self.limit = limit
        self.seen = 0

    def set_limit(self, limit: int) -> None:
        self.limit = limit

    def next(self) -> Optional[RankedNode]:
        if self.seen == self.limit:
            return None
        option = self.source.next()
        if option is None:
            return None
        self.seen += 1
        return option

    def reset(self) -> None:
        self.source.reset()
        self.seen = 0


class MaxScoreIterator:
    """Consumes the stream and returns only the argmax option."""

    def __init__(self, ctx, source) -> None:
        self.ctx = ctx
        self.source = source
        self.max: Optional[RankedNode] = None

    def next(self) -> Optional[RankedNode]:
        if self.max is not None:
            return None
        while True:
            option = self.source.next()
            if option is None:
                return self.max
            if self.max is None or option.score > self.max.score:
                self.max = option

    def reset(self) -> None:
        self.source.reset()
        self.max = None
