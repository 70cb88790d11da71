"""Task environment variables.

Capability parity with reference client/driver/environment/vars.go:
NOMAD_ALLOC_DIR, NOMAD_TASK_DIR, NOMAD_MEMORY_LIMIT, NOMAD_CPU_LIMIT,
NOMAD_IP, NOMAD_PORT_<label>, NOMAD_META_<key>, plus user env.
"""
from __future__ import annotations

from typing import Optional

from nomad_tpu_torch.structs import Resources, Task


def task_environment(task: Task, alloc_dir: Optional[str] = None,
                     task_dir: Optional[str] = None,
                     resources: Optional[Resources] = None,
                     meta: Optional[dict] = None) -> dict:
    env: dict = {}
    if alloc_dir:
        env["NOMAD_ALLOC_DIR"] = alloc_dir
    if task_dir:
        env["NOMAD_TASK_DIR"] = task_dir
    resources = resources or task.resources
    if resources is not None:
        env["NOMAD_MEMORY_LIMIT"] = str(resources.memory_mb)
        env["NOMAD_CPU_LIMIT"] = str(resources.cpu)
        if resources.networks:
            net = resources.networks[0]
            if net.ip:
                env["NOMAD_IP"] = net.ip
            for label, port in net.map_dynamic_ports().items():
                env[f"NOMAD_PORT_{label}"] = str(port)
    for key, value in (meta or task.meta or {}).items():
        env[f"NOMAD_META_{key.upper()}"] = str(value)
    env.update(task.env or {})
    return env
