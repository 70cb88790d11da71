"""Scheduler layer: pure placement logic behind the State/Planner seams.

Registry carries the sequential ``service``/``batch`` schedulers, the
device backend ``torch-binpack`` / ``torch-binpack-batch``, and the
system schedulers: ``system`` is the vectorized one (system_vec.py),
``system-seq`` the sequential iterator chain it is held against.
``BatchEvalRunner`` fuses a storm of evals into one kernel launch and
``VerifyingPlanner`` verifies and group-commits their plans.
"""
from .interfaces import (  # noqa: F401
    BUILTIN_SCHEDULERS,
    Factory,
    Planner,
    Scheduler,
    SetStatusError,
    State,
    new_scheduler,
    register_scheduler,
)
from .context import EvalContext  # noqa: F401
from .generic import (  # noqa: F401
    GenericScheduler,
    new_batch_scheduler,
    new_service_scheduler,
)
from .batch import BatchEvalRunner, pad_lanes  # noqa: F401
from .harness import Harness, RejectPlan, VerifyingPlanner  # noqa: F401
from .stack import GenericStack, SystemStack  # noqa: F401
from .system import SystemScheduler, new_system_scheduler  # noqa: F401
from .system_vec import (  # noqa: F401
    VectorSystemScheduler,
    new_vector_system_scheduler,
)
from .torch_binpack import (  # noqa: F401
    TorchBinPackScheduler,
    new_torch_binpack_batch_scheduler,
    new_torch_binpack_scheduler,
)

register_scheduler("service", new_service_scheduler)
register_scheduler("batch", new_batch_scheduler)
register_scheduler("torch-binpack", new_torch_binpack_scheduler)
register_scheduler("torch-binpack-batch", new_torch_binpack_batch_scheduler)
register_scheduler("system", new_vector_system_scheduler)
register_scheduler("system-seq", new_system_scheduler)
