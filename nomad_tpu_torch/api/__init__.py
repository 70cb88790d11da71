"""Typed HTTP API client.

Capability parity with reference api/: query/write options, blocking
queries, and wrappers for Jobs/Nodes/Evaluations/Allocations/Agent/Status.
"""
from .client import (  # noqa: F401
    APIClient,
    APIError,
    QueryMeta,
    QueryOptions,
)
