"""qemu driver: run VM images under qemu-kvm.

Capability parity with reference client/driver/qemu.go: fingerprints
the qemu binary; config carries image_path (local) or artifact_source
(VM image downloaded into the task dir with sha256 verification,
reference qemu.go:95-150), accelerator/port_map; guest memory sized from
the task's memory limit; user-net port forwards built from the task's
network resources.
"""
from __future__ import annotations

import re
import shutil
import subprocess

from nomad_tpu_torch.client.artifact import fetch_task_artifact

from .base import Driver


class QemuDriver(Driver):
    name = "qemu"

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        qemu = shutil.which("qemu-system-x86_64")
        if qemu is None:
            return False
        try:
            # faultlint-ok(uninjectable-io): fingerprint probe — any
            # failure means "driver absent", the degraded mode itself.
            out = subprocess.run([qemu, "--version"], capture_output=True,
                                 text=True, timeout=5)
            m = re.search(r"version ([\d.]+)", out.stdout)
        except Exception:
            return False
        node.attributes["driver.qemu"] = "1"
        if m:
            node.attributes["driver.qemu.version"] = m.group(1)
        return True

    def start(self, task):
        image = task.config.get("image_path")
        source = task.config.get("artifact_source")
        if not image and source:
            # Deployment path: the VM image ships over HTTP into the
            # task's local dir, verified against the configured (or
            # URL-borne ?checksum=) digest before boot (reference
            # qemu.go:95-150).
            image = fetch_task_artifact(self.ctx, task, source)
        if not image:
            raise ValueError(
                "qemu driver requires config.image_path or "
                "artifact_source")
        mem = max(task.resources.memory_mb, 128)
        argv = [
            "qemu-system-x86_64",
            "-machine", "type=pc,accel=" +
            task.config.get("accelerator", "tcg"),
            "-name", task.name,
            "-m", f"{mem}M",
            "-drive", f"file={image}",
            "-nographic",
        ]
        # User-net port forwards from the port map.
        port_map = task.config.get("port_map", {})
        if port_map and task.resources.networks:
            net = task.resources.networks[0]
            fwds = []
            assigned = net.map_dynamic_ports()
            for label, guest_port in port_map.items():
                host_port = assigned.get(label)
                if host_port:
                    fwds.append(f"hostfwd=tcp::{host_port}-:{guest_port}")
            if fwds:
                argv += ["-netdev", "user,id=n0," + ",".join(fwds),
                         "-device", "virtio-net,netdev=n0"]
        return self.spawn(task, argv, kind="qemu")
