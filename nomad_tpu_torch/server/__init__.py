"""Server core: broker, plan queue, plan applier, FSM, raft, worker.

Counterpart of ``nomad_tpu/server/`` for the single-server path:
leader-side in-memory queues feeding scheduler workers, a group-commit
plan applier with optimistic-concurrency semantics, a replicated-log FSM
over the MVCC state store, and the state->device bridge keeping the
fleet tensors on the card in sync with commits.  ``Server`` runs on
``ServerConfig.device`` (``cuda`` unless the caller passes ``"cpu"``).
"""
from .eval_broker import EvalBroker  # noqa: F401
from .fsm import NomadFSM  # noqa: F401
from .plan_apply import PlanApplier, evaluate_plan  # noqa: F401
from .plan_queue import PlanQueue  # noqa: F401
from .raft import FileLogStore, InmemRaft, SnapshotStore  # noqa: F401
from .server import Server, ServerConfig  # noqa: F401
from .timetable import TimeTable  # noqa: F401
from .worker import BatchWorker, Worker  # noqa: F401
