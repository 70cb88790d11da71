"""java driver: run a jar under the JVM.

Capability parity with reference client/driver/java.go: fingerprints
the JVM version; config carries jar_path (local) or artifact_source /
jar_source (downloaded into the task dir before launch, reference
java.go:96-130), plus jvm_options/args and an optional checksum.
"""
from __future__ import annotations

import shutil
import subprocess

from nomad_tpu_torch.client.artifact import fetch_task_artifact

from .base import Driver


class JavaDriver(Driver):
    name = "java"

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        java = shutil.which("java")
        if java is None:
            return False
        try:
            # faultlint-ok(uninjectable-io): fingerprint probe — any
            # failure means "driver absent", the degraded mode itself.
            out = subprocess.run([java, "-version"], capture_output=True,
                                 text=True, timeout=5)
            version_line = (out.stderr or out.stdout).splitlines()[0]
        except Exception:
            return False
        node.attributes["driver.java"] = "1"
        node.attributes["driver.java.version"] = \
            version_line.split('"')[1] if '"' in version_line else "unknown"
        return True

    def start(self, task):
        jar = task.config.get("jar_path")
        source = task.config.get("artifact_source") or \
            task.config.get("jar_source")
        if not jar and source:
            # Deployment path: the jar ships over HTTP into the task's
            # local dir (reference java.go:96-130), with optional
            # checksum verification.
            jar = fetch_task_artifact(self.ctx, task, source)
        if not jar:
            raise ValueError(
                "java driver requires config.jar_path or artifact_source")
        jvm_options = task.config.get("jvm_options", [])
        if isinstance(jvm_options, str):
            jvm_options = jvm_options.split()
        args = task.config.get("args", [])
        if isinstance(args, str):
            args = args.split()
        argv = ["java"] + list(jvm_options) + ["-jar", jar] + list(args)
        return self.spawn(task, argv, kind="java")
