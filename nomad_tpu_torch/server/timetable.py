"""TimeTable: raft-index <-> wall-time mapping for GC cutoffs.

Capability parity with reference nomad/timetable.go: a bounded ring of
(index, time) witnesses at a minimum granularity, answering "what was the
newest index at or before time T".  Serialized into FSM snapshots.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional


class TimeTable:
    def __init__(self, granularity: float = 300.0, limit: int = 864) -> None:
        # Defaults mirror the reference: 5 min granularity, 72 h window.
        self.granularity = granularity
        self.limit = limit
        self._lock = threading.Lock()
        self._table: deque = deque()  # newest first: (index, when)

    def witness(self, index: int, when: float) -> None:
        with self._lock:
            if self._table and \
                    self._table[0][1] + self.granularity > when:
                return
            if self._table and index <= self._table[0][0]:
                return
            self._table.appendleft((index, when))
            while len(self._table) > self.limit:
                self._table.pop()

    def nearest_index(self, when: float) -> int:
        """Newest index witnessed at or before `when` (0 if none)."""
        with self._lock:
            for index, t in self._table:
                if t <= when:
                    return index
        return 0

    def nearest_time(self, index: int) -> float:
        """Oldest known time for an index >= the given one (0 if none)."""
        with self._lock:
            for idx, t in self._table:
                if idx <= index:
                    return t
        return 0.0

    # -- snapshot support -------------------------------------------------
    def serialize(self) -> list:
        with self._lock:
            return [[i, t] for i, t in self._table]

    def deserialize(self, rows: Optional[list]) -> None:
        with self._lock:
            self._table.clear()
            for i, t in rows or []:
                self._table.append((i, t))
