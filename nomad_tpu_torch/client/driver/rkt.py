"""rkt driver: run appc (ACI) images via the rkt CLI.

Capability parity with reference client/driver/rkt.go: root-only
fingerprint parsing ``rkt version`` (rkt + appc versions advertised as
node attributes), task env injected via ``--set-env``,
``--insecure-skip-verify`` unless a ``trust_prefix`` was installed with
``rkt trust``, command override via ``--exec`` and user args after
``--``.  The handle is the supervising pid (reference rktPID re-attach).

rkt itself is discontinued upstream (CNCF-archived 2020); the driver is
kept for inventory parity and simply fingerprints absent on hosts
without the binary.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import subprocess

from .base import Driver

logger = logging.getLogger("nomad_tpu_torch.client.driver.rkt")

RE_RKT_VERSION = re.compile(r"rkt [Vv]ersion[:]? (\d[.\d]+)")
RE_APPC_VERSION = re.compile(r"appc [Vv]ersion[:]? (\d[.\d]+)")


class RktDriver(Driver):
    name = "rkt"

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        # Root-only, like the reference (rkt.go Fingerprint).
        if os.name != "nt" and os.geteuid() != 0:
            return False
        if shutil.which("rkt") is None:
            return False
        try:
            # faultlint-ok(uninjectable-io): fingerprint probe — any
            # failure means "driver absent", the degraded mode itself.
            out = subprocess.run(["rkt", "version"], capture_output=True,
                                 text=True, timeout=5)
        except Exception:
            return False
        rkt_m = RE_RKT_VERSION.search(out.stdout)
        appc_m = RE_APPC_VERSION.search(out.stdout)
        if out.returncode != 0 or not rkt_m or not appc_m:
            return False
        node.attributes["driver.rkt"] = "1"
        node.attributes["driver.rkt.version"] = rkt_m.group(1)
        node.attributes["driver.rkt.appc.version"] = appc_m.group(1)
        return True

    def start(self, task):
        image = task.config.get("image")
        if not image:
            raise ValueError("rkt driver requires config.image (ACI)")

        argv = ["rkt"]
        from nomad_tpu_torch.client.task_env import task_environment

        # Task env rides --set-env; alloc/local dirs aren't mounted into
        # the pod (reference clears them too).
        env = task_environment(task, alloc_dir="", task_dir="")
        for key, value in env.items():
            if key.startswith("NOMAD_") and not value:
                continue
            argv.append(f"--set-env={key}={value}")

        trust_prefix = task.config.get("trust_prefix")
        if trust_prefix:
            # faultlint-ok(uninjectable-io): rkt CLI trust setup; a
            # nonzero exit raises a driver error — the cluster chaos
            # seam is driver.start at the task_runner.
            out = subprocess.run(
                ["rkt", "trust", f"--prefix={trust_prefix}"],
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(
                    f"rkt trust failed: {out.stderr.strip()}")
        else:
            argv.append("--insecure-skip-verify")

        argv += ["run", "--mds-register=false", image]
        command = task.config.get("command")
        if command:
            argv.append(f"--exec={command}")
        args = task.config.get("args", "")
        if isinstance(args, str):
            import shlex

            args = shlex.split(args) if args else []
        if args:
            argv.append("--")
            argv += [str(a) for a in args]

        return self.spawn(task, argv, kind="rkt")
