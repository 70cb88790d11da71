from .store import StateRestore, StateSnapshot, StateStore, StateWatch  # noqa: F401
