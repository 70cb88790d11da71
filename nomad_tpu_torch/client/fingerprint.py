"""Node fingerprinting: detect attributes, resources and links.

Capability parity with reference client/fingerprint/: an ordered
chain of detectors filling Node.attributes / resources / links — arch, cpu
(cores x MHz), host (kernel/os/hostname), memory, storage, network (iface +
speed), env_aws/env_gce (cloud metadata), consul link.  Cloud detectors are
gated on reachability with short timeouts and default off in tests
(options: "fingerprint.denylist").

Accelerator addition: an accelerator fingerprint exposing the devices
torch sees as ``accel.*`` attributes so jobs can constrain on them.
"""
from __future__ import annotations

import logging
import os
import platform
import shutil
import socket
from typing import Callable

from nomad_tpu_torch.structs import NetworkResource, Node, Resources

logger = logging.getLogger("nomad_tpu_torch.client.fingerprint")


def arch_fingerprint(cfg, node: Node) -> bool:
    node.attributes["arch"] = platform.machine() or "unknown"
    return True


def host_fingerprint(cfg, node: Node) -> bool:
    node.attributes["kernel.name"] = platform.system().lower()
    node.attributes["kernel.version"] = platform.release()
    node.attributes["os.name"] = platform.system().lower()
    node.attributes["os.version"] = platform.version()
    node.attributes["unique.hostname"] = socket.gethostname()
    if not node.name:
        node.name = socket.gethostname()
    return True


def cpu_fingerprint(cfg, node: Node) -> bool:
    cores = os.cpu_count() or 1
    node.attributes["cpu.numcores"] = str(cores)
    mhz = 1000.0
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.lower().startswith("cpu mhz"):
                    mhz = float(line.split(":")[1])
                    break
    except (OSError, ValueError):
        pass
    node.attributes["cpu.frequency"] = f"{mhz:.0f}"
    total = int(cores * mhz)
    node.attributes["cpu.totalcompute"] = str(total)
    if node.resources.cpu == 0:
        node.resources.cpu = total
    return True


def memory_fingerprint(cfg, node: Node) -> bool:
    total_mb = 0
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal"):
                    total_mb = int(line.split()[1]) // 1024
                    break
    except (OSError, ValueError):
        pass
    if total_mb:
        node.attributes["memory.totalbytes"] = str(total_mb * 1024 * 1024)
        if node.resources.memory_mb == 0:
            node.resources.memory_mb = total_mb
    return True


def storage_fingerprint(cfg, node: Node) -> bool:
    path = cfg.alloc_dir or "/"
    try:
        usage = shutil.disk_usage(path)
    except OSError:
        return False
    node.attributes["storage.volume"] = path
    node.attributes["storage.bytestotal"] = str(usage.total)
    node.attributes["storage.bytesfree"] = str(usage.free)
    if node.resources.disk_mb == 0:
        node.resources.disk_mb = usage.free // (1024 * 1024)
    return True


def network_fingerprint(cfg, node: Node) -> bool:
    """Default-route interface + IP; speed from options or 100 Mbit
    heuristic (reference network_unix.go)."""
    ip = cfg.read("network.ip") or _default_ip()
    if not ip:
        return False
    node.attributes["unique.network.ip-address"] = ip
    speed = int(cfg.read("network.speed", "0") or 0)
    if speed == 0:
        speed = 1000 if ip != "127.0.0.1" else 100
    if not node.resources.networks:
        node.resources.networks.append(NetworkResource(
            device="eth0", cidr=f"{ip}/32", ip=ip, mbits=speed))
    return True


def _default_ip() -> str:
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            # No packets are sent; picks the default-route source address.
            # faultlint-ok(uninjectable-io): routing-table lookup, no
            # traffic; OSError already falls back to loopback below.
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        return "127.0.0.1"


def accel_fingerprint(cfg, node: Node) -> bool:
    """Accelerator detection via torch (framework-native extension).

    The keys and values are those of JAX's backends: on a CUDA host the
    platform is ``gpu`` (the name of JAX's CUDA backend) and each card
    counts under its device name; on a host without CUDA the node has
    one ``cpu`` device, as JAX's CPU backend reports by default."""
    if cfg.read_bool("fingerprint.skip_accel"):
        return False
    import torch

    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        platform_name = "gpu"
    else:
        names = ["cpu"]
        platform_name = "cpu"
    if not names:
        return False
    kinds: dict = {}
    for name in names:
        kinds[name] = kinds.get(name, 0) + 1
    node.attributes["accel.count"] = str(len(names))
    node.attributes["accel.platform"] = platform_name
    for kind, count in kinds.items():
        key = kind.lower().replace(" ", "-")
        node.attributes[f"accel.kind.{key}"] = str(count)
    return True


def consul_fingerprint(cfg, node: Node) -> bool:
    addr = cfg.read("consul.address")
    if not addr:
        return False
    node.links["consul"] = f"{node.name}.{node.datacenter}"
    return True


def env_aws_fingerprint(cfg, node: Node) -> bool:
    """AWS metadata service probe; off unless explicitly enabled (zero
    egress in tests; reference env_aws.go probes 169.254.169.254).
    The endpoint is overridable for tests, the same trick the
    reference's env_aws_test.go plays with a local httptest server."""
    if not cfg.read_bool("fingerprint.env_aws"):
        return False
    url = cfg.read("fingerprint.env_aws.url") or \
        "http://169.254.169.254"
    return _probe_metadata(cfg, node, url, "platform.aws")


def env_gce_fingerprint(cfg, node: Node) -> bool:
    if not cfg.read_bool("fingerprint.env_gce"):
        return False
    url = cfg.read("fingerprint.env_gce.url") or \
        "http://metadata.google.internal"
    return _probe_metadata(cfg, node, url, "platform.gce")


def _probe_metadata(cfg, node: Node, url: str, prefix: str) -> bool:
    import urllib.request

    try:
        req = urllib.request.Request(url, headers={
            "Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=0.5):
            pass
    except Exception:
        return False
    node.attributes[f"{prefix}.detected"] = "true"
    return True


# Ordered chain (reference fingerprint.go:13-35 BuiltinFingerprints).
BUILTIN_FINGERPRINTS: list[tuple[str, Callable]] = [
    ("arch", arch_fingerprint),
    ("cpu", cpu_fingerprint),
    ("host", host_fingerprint),
    ("memory", memory_fingerprint),
    ("storage", storage_fingerprint),
    ("network", network_fingerprint),
    ("accel", accel_fingerprint),
    ("env_aws", env_aws_fingerprint),
    ("env_gce", env_gce_fingerprint),
    ("consul", consul_fingerprint),
]


def fingerprint_node(cfg, node: Node) -> list:
    """Run the chain; returns the names that applied."""
    denylist = set((cfg.read("fingerprint.denylist") or "").split(","))
    applied = []
    for name, fn in BUILTIN_FINGERPRINTS:
        if name in denylist:
            continue
        try:
            if fn(cfg, node):
                applied.append(name)
        except Exception:
            logger.exception("fingerprint %s failed", name)
    return applied
