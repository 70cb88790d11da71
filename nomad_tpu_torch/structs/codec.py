"""Type-prefixed msgpack encoding for the replicated log and RPC plane.

Capability parity with reference nomad/structs/structs.go:21-43 and
:1530-1543 — a one-byte MessageType prefix followed by msgpack payload, with
an ignore-unknown-type flag bit for forward compatibility.
"""
from __future__ import annotations

import msgpack

# MessageTypes (reference: structs.go:21-43)
NODE_REGISTER_REQUEST = 0
NODE_DEREGISTER_REQUEST = 1
NODE_UPDATE_STATUS_REQUEST = 2
NODE_UPDATE_DRAIN_REQUEST = 3
JOB_REGISTER_REQUEST = 4
JOB_DEREGISTER_REQUEST = 5
EVAL_UPDATE_REQUEST = 6
EVAL_DELETE_REQUEST = 7
ALLOC_UPDATE_REQUEST = 8
ALLOC_CLIENT_UPDATE_REQUEST = 9
# Group-commit extension (no reference analogue): one log entry carrying
# the accepted alloc sets of a whole plan window, applied in eval order
# by one batched FSM pass (server/plan_apply.py group commit).
PLAN_BATCH_APPLY_REQUEST = 10

# Upper bit: apply must not error on unknown type (structs.go:40-43)
IGNORE_UNKNOWN_TYPE_FLAG = 128


def encode(msg_type: int, payload: dict) -> bytes:
    """Encode a raft log entry: 1-byte type + msgpack body."""
    return bytes([msg_type]) + msgpack.packb(payload, use_bin_type=True)


def decode(buf: bytes) -> tuple[int, dict, bool]:
    """Decode a raft log entry into (msg_type, payload, ignore_unknown).

    The ignore flag is masked off the type byte so dispatch can compare
    against the bare message-type constants; callers that hit an unknown
    type must only error when ignore_unknown is False.
    """
    if not buf:
        raise ValueError("empty log entry")
    raw = buf[0]
    ignorable = bool(raw & IGNORE_UNKNOWN_TYPE_FLAG)
    msg_type = raw & ~IGNORE_UNKNOWN_TYPE_FLAG
    payload = msgpack.unpackb(buf[1:], raw=False, strict_map_key=False)
    return msg_type, payload, ignorable
