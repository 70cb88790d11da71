"""docker driver: containerized execution via the docker CLI.

Capability parity with reference client/driver/docker.go:
pull-if-absent (always re-pull ``:latest``, docker.go:285-330) with the
handle carrying the resolved image id; container-side port mapping —
numeric dynamic-port labels map host->label port, non-numeric map 1:1,
static ports 1:1 (docker.go:185-218), plus an explicit ``port_map``
config like the qemu driver's; ``network_mode`` pass-through
(docker.go:169-184); cleanup knobs ``docker.cleanup.container`` /
``docker.cleanup.image`` from the client options (docker.go:270-282,
both default true); CPU shares + memory limits; the shared alloc dir
bind-mounted at the reference's container paths; re-attach by container
id after agent restart.  Uses the docker CLI rather than the API socket
client.
"""
from __future__ import annotations

import logging
import shutil
import subprocess
from typing import Optional

from .base import Driver, DriverHandle

logger = logging.getLogger("nomad_tpu_torch.client.driver.docker")


class DockerHandle(DriverHandle):
    def __init__(self, container_id: str, image_id: str = "",
                 cleanup_container: bool = True,
                 cleanup_image: bool = True) -> None:
        self.container_id = container_id
        self.image_id = image_id
        self.cleanup_container = cleanup_container
        self.cleanup_image = cleanup_image

    def id(self) -> str:
        # '|' separators: image ids contain ':' (sha256:...).
        flags = f"{int(self.cleanup_container)}{int(self.cleanup_image)}"
        return f"docker:{self.container_id}|{self.image_id}|{flags}"

    @classmethod
    def from_id(cls, payload: str) -> "DockerHandle":
        parts = payload.split("|")
        if len(parts) == 3:
            cid, image_id, flags = parts
            return cls(cid, image_id, flags[0] == "1", flags[1] == "1")
        return cls(parts[0])

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            # faultlint-ok(uninjectable-io): out-of-process docker CLI
            # control command; failure surfaces as exit-code handling
            # below — the cluster chaos seam is driver.start upstream.
            out = subprocess.run(["docker", "wait", self.container_id],
                                 capture_output=True, text=True,
                                 timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        try:
            return int(out.stdout.strip())
        except ValueError:
            # `docker wait` failed (container removed out-of-band, daemon
            # restart): a container that is not running is dead, not
            # still-waiting.
            return 125 if not self.is_running() else None

    def is_running(self) -> bool:
        # faultlint-ok(uninjectable-io): docker CLI liveness probe;
        # a failed inspect reads as not-running, which is the safe
        # answer — chaos rides driver.start upstream.
        out = subprocess.run(
            ["docker", "inspect", "-f", "{{.State.Running}}",
             self.container_id], capture_output=True, text=True)
        return out.stdout.strip() == "true"

    def update(self, task) -> None:
        pass

    def kill(self) -> None:
        # faultlint-ok(uninjectable-io): best-effort docker stop on
        # teardown; cleanup failures are logged, never retried into
        # the serving plane.
        subprocess.run(["docker", "stop", "-t", "5", self.container_id],
                       capture_output=True)
        if self.cleanup_container:
            self._cleanup(["docker", "rm", "-f", self.container_id])
        if self.cleanup_image and self.image_id:
            # With cleanup_container=false the kept container still
            # references the image and docker refuses — surfaced below.
            self._cleanup(["docker", "rmi", self.image_id])

    @staticmethod
    def _cleanup(argv: list) -> None:
        # faultlint-ok(uninjectable-io): best-effort rm/rmi teardown;
        # a failure is logged and leaves a stale container/image, not
        # cluster state.
        out = subprocess.run(argv, capture_output=True, text=True)
        if out.returncode != 0:
            logger.warning("%s failed: %s", " ".join(argv[:2]),
                           out.stderr.strip())


class DockerDriver(Driver):
    name = "docker"

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        docker = shutil.which("docker")
        if docker is None:
            return False
        try:
            # faultlint-ok(uninjectable-io): fingerprint probe — any
            # failure means "driver absent", exactly the degraded mode
            # a chaos plan would induce.
            out = subprocess.run(["docker", "version", "--format",
                                  "{{.Server.Version}}"],
                                 capture_output=True, text=True, timeout=5)
        except Exception:
            return False
        if out.returncode != 0:
            return False
        node.attributes["driver.docker"] = "1"
        node.attributes["driver.docker.version"] = out.stdout.strip()
        return True

    @staticmethod
    def _image_id(image: str) -> Optional[str]:
        # faultlint-ok(uninjectable-io): docker CLI metadata probe;
        # None on failure routes to the pull/cached fallback chain.
        out = subprocess.run(["docker", "image", "inspect", "-f",
                              "{{.Id}}", image],
                             capture_output=True, text=True)
        return out.stdout.strip() if out.returncode == 0 else None

    def _ensure_image(self, image: str) -> str:
        """Pull-if-absent; for ``:latest`` (explicit or implied) a
        refresh pull is attempted on every start.  DELIBERATE DIVERGENCE
        from the reference (docker.go:285-310, which fails the task when
        the pull fails even if the image is cached locally): here the
        freshness pull is best-effort and a locally cached image still
        runs, so offline/rate-limited nodes keep serving (also noted in
        PARITY.md).  Returns the image id."""
        tag = image.rsplit(":", 1)[1] if ":" in image.split("/")[-1] \
            else "latest"
        image_id = None if tag == "latest" else self._image_id(image)
        if image_id is None:
            # faultlint-ok(uninjectable-io): registry pull is already
            # failure-tolerant (cached-image fallback below); the
            # cluster chaos seam is driver.start at the task_runner.
            pull = subprocess.run(["docker", "pull", image],
                                  capture_output=True, text=True)
            if pull.returncode != 0:
                # Unreachable/rate-limited registry: a locally cached
                # image still runs (matters most for ":latest", whose
                # freshness pull is best-effort, not a correctness
                # requirement).
                cached = self._image_id(image)
                if cached is not None:
                    logger.warning(
                        "pull of %r failed (%s); using cached image %s",
                        image, pull.stderr.strip(), cached)
                    return cached
                raise RuntimeError(
                    f"failed to pull {image!r}: {pull.stderr.strip()}")
            image_id = self._image_id(image)
            if image_id is None:
                raise RuntimeError(
                    f"failed to determine image id for {image!r}")
        return image_id

    def start(self, task):
        image = task.config.get("image")
        if not image:
            raise ValueError("docker driver requires config.image")
        image_id = self._ensure_image(image)

        argv = ["docker", "run", "-d",
                "--name", f"nomad-{self.ctx.alloc_id[:8]}-{task.name}"]
        network_mode = task.config.get("network_mode", "")
        if network_mode:
            argv += ["--net", network_mode]
        res = task.resources
        if res.cpu:
            argv += ["--cpu-shares", str(res.cpu)]
        if res.memory_mb:
            argv += ["--memory", f"{res.memory_mb}m"]
        # Shared alloc dir at the reference's mount points.
        argv += ["-v", f"{self.ctx.alloc_dir.shared_dir}:/alloc"]
        task_dir = self.ctx.alloc_dir.task_dirs.get(task.name)
        if task_dir:
            argv += ["-v", f"{task_dir}/local:/local"]
        if res.networks:
            net = res.networks[0]
            port_map = task.config.get("port_map", {})
            for port in net.list_static_ports():
                argv += ["-p", f"{port}:{port}"]
            for label, host_port in net.map_dynamic_ports().items():
                # Container-side resolution (docker.go:199-216 + the
                # port_map convention): explicit port_map first, then a
                # numeric label names the container port, else 1:1 and
                # the task reads its NOMAD_PORT_<label> env.
                if label in port_map:
                    container = int(port_map[label])
                elif str(label).isdigit():
                    container = int(label)
                else:
                    container = host_port
                argv += ["-p", f"{host_port}:{container}"]
        argv.append(image)
        command = task.config.get("command")
        if command:
            argv.append(command)
            args = task.config.get("args", [])
            if isinstance(args, str):
                args = args.split()
            argv += list(args)
        # faultlint-ok(uninjectable-io): the docker-run exec; the
        # injectable boundary is driver.start consulted at the
        # task_runner seam one frame above (dynamic registry edge the
        # resolved-edge walk cannot see).
        out = subprocess.run(argv, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"docker run failed: {out.stderr.strip()}")
        return DockerHandle(
            out.stdout.strip(), image_id=image_id,
            cleanup_container=self.ctx.read_bool(
                "docker.cleanup.container", True),
            cleanup_image=self.ctx.read_bool("docker.cleanup.image",
                                             True))

    def open(self, handle_id: str) -> DockerHandle:
        _kind, payload = handle_id.split(":", 1)
        handle = DockerHandle.from_id(payload)
        if not handle.is_running():
            raise ProcessLookupError(
                f"container {handle.container_id} is not running")
        return handle
