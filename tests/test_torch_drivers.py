"""The port's task drivers (nomad_tpu_torch/client/driver): the JAX
package's driver tests (tests/test_client.py's fingerprint, rkt, java,
qemu, exec and artifact cases; tests/test_docker_driver.py against a
fake ``docker``) run against the port, then parity: each of the six
drivers, fingerprinted and started by both packages with the same fake
binaries on the same alloc dir, reports equal node attributes and logs
equal invocations (argv, and the task's ``NOMAD_*`` environment where
the driver execs the task itself).  The exec driver's chroot and cgroup
steps are the twin tests' part; its parity case compares the argv it
hands to ``spawn`` (the re-exec shim and the task command).  exec and
rkt are root-only, as in the JAX suite.
"""
from __future__ import annotations

import importlib
import os

import pytest

from nomad_tpu_torch.client import ClientConfig
from nomad_tpu_torch.client.allocdir import AllocDir
from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS
from nomad_tpu_torch.client.driver.base import ExecContext
from nomad_tpu_torch.structs import NetworkResource, Node, Resources, Task

ROOT = os.geteuid() == 0


# -- tests/test_client.py's driver cases ------------------------------------


def test_driver_fingerprints():
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    cfg = ClientConfig(options={"driver.raw_exec.enable": "1"})
    node = Node(attributes={"kernel.name": "linux"})
    assert BUILTIN_DRIVERS["raw_exec"].fingerprint(cfg, node)
    assert node.attributes["driver.raw_exec"] == "1"
    assert BUILTIN_DRIVERS["exec"].fingerprint(cfg, node)
    assert node.attributes["driver.exec"] == "1"
    # raw_exec off by default
    node2 = Node()
    assert not BUILTIN_DRIVERS["raw_exec"].fingerprint(ClientConfig(),
                                                       node2)


@pytest.mark.skipif(os.geteuid() != 0, reason="rkt driver is root-only")
def test_rkt_driver_fingerprint_and_start(tmp_path, fake_bin):
    install, fake_log = fake_bin
    install("rkt",
            'if [ "$1" = "version" ]; then '
            'echo "rkt Version: 1.30.0"; '
            'echo "appc Version: 0.8.11"; fi')
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    node = Node(attributes={"kernel.name": "linux"})
    assert BUILTIN_DRIVERS["rkt"].fingerprint(ClientConfig(), node)
    assert node.attributes["driver.rkt"] == "1"
    assert node.attributes["driver.rkt.version"] == "1.30.0"
    assert node.attributes["driver.rkt.appc.version"] == "0.8.11"

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="pod", driver="rkt",
                config={"image": "coreos.com/etcd:v2.0.4",
                        "command": "/etcd", "args": "--version"},
                resources=Resources(cpu=100, memory_mb=64))
    ad.build([task])
    drv = BUILTIN_DRIVERS["rkt"](ExecContext(ad, "alloc-rkt"))
    handle = drv.start(task)
    assert handle.wait(10) == 0
    line = [l for l in fake_log.read_text().splitlines()
            if " run " in l][-1]
    assert "--insecure-skip-verify" in line
    assert "run --mds-register=false coreos.com/etcd:v2.0.4" in line
    assert "--exec=/etcd" in line and line.endswith("-- --version")


def test_rkt_driver_fingerprint_absent_without_binary(monkeypatch,
                                                      tmp_path):
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    empty = tmp_path / "emptybin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    node = Node(attributes={"kernel.name": "linux"})
    assert not BUILTIN_DRIVERS["rkt"].fingerprint(ClientConfig(), node)
    assert "driver.rkt" not in node.attributes


@pytest.fixture
def fake_bin(tmp_path, monkeypatch):
    """Install fake binaries on PATH; returns (bindir, invocation log)."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    log = tmp_path / "invocations.log"
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")

    def install(name: str, body: str = ""):
        exe = bindir / name
        exe.write_text(f'#!/bin/sh\necho "{name} $@" >> {log}\n{body}\n')
        exe.chmod(0o755)
        return exe

    return install, log


def test_java_driver_fingerprint_and_start(tmp_path, fake_bin):
    install, log = fake_bin
    install("java",
            'if [ "$1" = "-version" ]; then '
            'echo \'openjdk version "21.0.2" 2024\' >&2; fi')
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    node = Node(attributes={"kernel.name": "linux"})
    assert BUILTIN_DRIVERS["java"].fingerprint(ClientConfig(), node)
    assert node.attributes["driver.java"] == "1"
    assert node.attributes["driver.java.version"] == "21.0.2"

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="jvm", driver="java",
                config={"jar_path": "/srv/app.jar",
                        "jvm_options": "-Xmx128m", "args": "serve"},
                resources=Resources(cpu=100, memory_mb=256))
    ad.build([task])
    drv = BUILTIN_DRIVERS["java"](ExecContext(ad, "alloc-j"))
    handle = drv.start(task)
    assert handle.wait(10) == 0
    line = [l for l in log.read_text().splitlines() if "-jar" in l][-1]
    assert line == "java -Xmx128m -jar /srv/app.jar serve"


def test_qemu_driver_fingerprint_and_start(tmp_path, fake_bin):
    install, log = fake_bin
    install("qemu-system-x86_64",
            'if [ "$1" = "--version" ]; then '
            'echo "QEMU emulator version 8.2.1"; fi')
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    node = Node(attributes={"kernel.name": "linux"})
    assert BUILTIN_DRIVERS["qemu"].fingerprint(ClientConfig(), node)
    assert node.attributes["driver.qemu.version"] == "8.2.1"

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="vm", driver="qemu",
                config={"image_path": "/srv/disk.img",
                        "accelerator": "tcg",
                        "port_map": {"ssh": 22}},
                resources=Resources(
                    cpu=500, memory_mb=512,
                    networks=[NetworkResource(
                        ip="10.0.0.1", dynamic_ports=["ssh"],
                        reserved_ports=[31022])]))
    # map_dynamic_ports pairs labels with assigned reserved ports.
    ad.build([task])
    drv = BUILTIN_DRIVERS["qemu"](ExecContext(ad, "alloc-q"))
    handle = drv.start(task)
    assert handle.wait(10) == 0
    line = [l for l in log.read_text().splitlines()
            if "qemu-system" in l][-1]
    assert "-m 512M" in line and "file=/srv/disk.img" in line
    assert "hostfwd=tcp::31022-:22" in line


@pytest.mark.skipif(os.geteuid() != 0, reason="requires root")
def test_exec_driver_drops_privileges(tmp_path):
    """Root exec tasks run as nobody after chroot (reference
    client/executor/exec_linux.go privilege drop)."""
    import pwd

    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="iduid", driver="exec",
                config={"command": "/usr/bin/id", "args": "-u"},
                resources=Resources(cpu=100, memory_mb=64))
    ad.build([task])
    drv = BUILTIN_DRIVERS["exec"](ExecContext(ad, "alloc-priv"))
    handle = drv.start(task)
    assert handle.wait(30) == 0
    out = open(ad.log_path("iduid", "stdout")).read().strip()
    assert out == str(pwd.getpwnam("nobody").pw_uid)


@pytest.mark.skipif(os.geteuid() != 0, reason="requires root")
def test_exec_driver_user_override_keeps_root(tmp_path):
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="idroot", driver="exec",
                config={"command": "/usr/bin/id", "args": "-u",
                        "user": "root"},
                resources=Resources(cpu=100, memory_mb=64))
    ad.build([task])
    drv = BUILTIN_DRIVERS["exec"](ExecContext(ad, "alloc-priv2"))
    handle = drv.start(task)
    assert handle.wait(30) == 0
    out = open(ad.log_path("idroot", "stdout")).read().strip()
    assert out == "0"


@pytest.mark.skipif(os.geteuid() != 0, reason="requires root")
def test_exec_driver_unknown_user_fails_closed(tmp_path):
    """A typo'd `user` must fail the task start, not silently run as
    root (chroot contents are hardlinked host inodes)."""
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="typo", driver="exec",
                config={"command": "/usr/bin/id", "args": "-u",
                        "user": "no-such-user-xyz"},
                resources=Resources(cpu=100, memory_mb=64))
    ad.build([task])
    drv = BUILTIN_DRIVERS["exec"](ExecContext(ad, "alloc-typo"))
    with pytest.raises(RuntimeError, match="does not exist"):
        drv.start(task)


@pytest.fixture
def artifact_server(tmp_path):
    """Local HTTP server serving tmp_path/artifacts (no egress here)."""
    import http.server
    import threading as _threading

    adir = tmp_path / "artifacts"
    adir.mkdir()

    class Handler(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(adir), **kw)

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    _threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield adir, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def test_java_driver_downloads_artifact(tmp_path, fake_bin,
                                        artifact_server):
    """jar_source over HTTP lands in the task's local dir before launch
    (reference client/driver/java.go:96-130)."""
    import hashlib

    install, log = fake_bin
    install("java")
    adir, base = artifact_server
    (adir / "app.jar").write_bytes(b"PK\x03\x04 fake jar")
    digest = hashlib.sha256(b"PK\x03\x04 fake jar").hexdigest()

    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="jvm", driver="java",
                config={"artifact_source": f"{base}/app.jar",
                        "checksum": f"sha256:{digest}", "args": "serve"},
                resources=Resources(cpu=100, memory_mb=256))
    ad.build([task])
    drv = BUILTIN_DRIVERS["java"](ExecContext(ad, "alloc-dl"))
    handle = drv.start(task)
    assert handle.wait(10) == 0
    local_jar = os.path.join(ad.task_dirs["jvm"], "local", "app.jar")
    assert open(local_jar, "rb").read() == b"PK\x03\x04 fake jar"
    line = [l for l in log.read_text().splitlines() if "-jar" in l][-1]
    assert line == f"java -jar {local_jar} serve"


def test_qemu_driver_artifact_url_checksum(tmp_path, fake_bin,
                                           artifact_server):
    """?checksum= on the artifact URL is honored (go-getter convention,
    reference client/driver/qemu.go:95-150)."""
    import hashlib

    install, log = fake_bin
    install("qemu-system-x86_64")
    adir, base = artifact_server
    (adir / "disk.img").write_bytes(b"qcow2-bytes")
    digest = hashlib.sha256(b"qcow2-bytes").hexdigest()

    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="vm", driver="qemu",
                config={"artifact_source":
                        f"{base}/disk.img?checksum=sha256:{digest}"},
                resources=Resources(cpu=500, memory_mb=256))
    ad.build([task])
    drv = BUILTIN_DRIVERS["qemu"](ExecContext(ad, "alloc-qdl"))
    handle = drv.start(task)
    assert handle.wait(10) == 0
    img = os.path.join(ad.task_dirs["vm"], "local", "disk.img")
    assert os.path.exists(img)
    line = [l for l in log.read_text().splitlines()
            if "qemu-system" in l][-1]
    assert f"file={img}" in line


def test_artifact_checksum_mismatch_fails_task(tmp_path, fake_bin,
                                               artifact_server):
    """A bad digest rejects the artifact: no file left behind, start
    raises (surfaced as a task error by the TaskRunner)."""
    from nomad_tpu_torch.client.artifact import ArtifactError
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    install, _log = fake_bin
    install("qemu-system-x86_64")
    adir, base = artifact_server
    (adir / "disk.img").write_bytes(b"tampered-bytes")

    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="vm", driver="qemu",
                config={"artifact_source": f"{base}/disk.img",
                        "checksum": "sha256:" + "0" * 64},
                resources=Resources(cpu=500, memory_mb=256))
    ad.build([task])
    drv = BUILTIN_DRIVERS["qemu"](ExecContext(ad, "alloc-bad"))
    with pytest.raises(ArtifactError, match="checksum mismatch"):
        drv.start(task)
    assert not os.path.exists(
        os.path.join(ad.task_dirs["vm"], "local", "disk.img"))


def test_artifact_fetch_error_is_task_error(tmp_path, fake_bin,
                                            artifact_server):
    from nomad_tpu_torch.client.artifact import ArtifactError
    from nomad_tpu_torch.client.driver import BUILTIN_DRIVERS

    install, _log = fake_bin
    install("java")
    _adir, base = artifact_server
    ad = AllocDir(str(tmp_path / "alloc"))
    task = Task(name="jvm", driver="java",
                config={"artifact_source": f"{base}/missing.jar"},
                resources=Resources(cpu=100, memory_mb=128))
    ad.build([task])
    drv = BUILTIN_DRIVERS["java"](ExecContext(ad, "alloc-404"))
    with pytest.raises(ArtifactError, match="failed to fetch"):
        drv.start(task)


def test_artifact_keeps_presigned_query(tmp_path, artifact_server):
    """Only the checksum query parameter is stripped from the download
    URL — presigned/tokenized query strings survive."""
    import hashlib
    import http.server
    import threading as _threading

    from nomad_tpu_torch.client.artifact import fetch_artifact

    seen = {}

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            seen["path"] = self.path
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"payload")

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    _threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        digest = hashlib.sha256(b"payload").hexdigest()
        url = (f"http://127.0.0.1:{httpd.server_address[1]}/f.bin"
               f"?X-Amz-Signature=tok123&checksum=sha256:{digest}")
        dest = fetch_artifact(url, str(tmp_path / "dl"))
        assert open(dest, "rb").read() == b"payload"
        assert "X-Amz-Signature=tok123" in seen["path"]
        assert "checksum" not in seen["path"]
    finally:
        httpd.shutdown()


# -- tests/test_docker_driver.py, against a fake docker ----------------------


@pytest.fixture
def fake_docker(tmp_path, monkeypatch):
    """A scripted `docker` CLI: logs every invocation; `image inspect`
    succeeds only after a `pull` created the image marker."""
    bindir = tmp_path / "fakebin"
    bindir.mkdir()
    state = tmp_path / "docker-state"
    state.mkdir()
    log = tmp_path / "invocations.log"
    exe = bindir / "docker"
    exe.write_text(f"""#!/bin/sh
echo "docker $@" >> {log}
state={state}
case "$1" in
  version) echo "24.0.7" ;;
  image)
    # image inspect -f {{.Id}} IMG -> image name is $5
    img=$(echo "$5" | tr '/:' '__')
    if [ -f "$state/$img" ]; then echo "sha256:id-$img"; else exit 1; fi ;;
  pull)
    img=$(echo "$2" | tr '/:' '__')
    touch "$state/$img" ;;
  run) echo "cid-12345" ;;
  stop|rm|rmi) : ;;
  inspect) echo "true" ;;
esac
""")
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return log


def _start(tmp_path, config, resources=None, options=None,
           name="web") -> tuple:
    ad = AllocDir(str(tmp_path / f"alloc-{name}"))
    task = Task(name=name, driver="docker", config=config,
                resources=resources or Resources(cpu=250, memory_mb=128))
    ad.build([task])
    drv = BUILTIN_DRIVERS["docker"](
        ExecContext(ad, "a1b2c3d4e5f6", options=options))
    return drv.start(task), ad


def _run_line(log) -> str:
    return [ln for ln in log.read_text().splitlines()
            if ln.startswith("docker run")][-1]


def test_run_argv_static_dynamic_mapped_ports(tmp_path, fake_docker):
    net = NetworkResource(
        ip="10.0.0.1",
        # static 8080; dynamic labels: "http" (no mapping), "6379"
        # (numeric -> container 6379), "db" (explicit port_map -> 5432)
        reserved_ports=[8080, 20100, 20200, 20300],
        dynamic_ports=["http", "6379", "db"])
    handle, ad = _start(
        tmp_path,
        {"image": "redis:7.2", "port_map": {"db": 5432},
         "command": "redis-server", "args": "--appendonly yes"},
        Resources(cpu=250, memory_mb=128, networks=[net]))
    line = _run_line(fake_docker)
    expected = (
        "docker run -d --name nomad-a1b2c3d4-web "
        "--cpu-shares 250 --memory 128m "
        f"-v {ad.shared_dir}:/alloc -v {ad.task_dirs['web']}/local:/local "
        "-p 8080:8080 "        # static 1:1
        "-p 20100:20100 "      # non-numeric label, no mapping: 1:1
        "-p 20200:6379 "       # numeric label names the container port
        "-p 20300:5432 "       # explicit port_map wins
        "redis:7.2 redis-server --appendonly yes")
    assert line == expected
    assert handle.container_id == "cid-12345"
    assert handle.image_id == "sha256:id-redis_7.2"


def test_pull_if_absent_and_cache_hit(tmp_path, fake_docker):
    _start(tmp_path, {"image": "redis:7.2"}, name="a")
    lines = fake_docker.read_text().splitlines()
    assert any(ln.startswith("docker pull redis:7.2") for ln in lines)
    fake_docker.write_text("")
    _start(tmp_path, {"image": "redis:7.2"}, name="b")
    lines = fake_docker.read_text().splitlines()
    # Cached tag: inspect hits, no second pull.
    assert not any(ln.startswith("docker pull") for ln in lines)


def test_latest_always_repulled(tmp_path, fake_docker):
    _start(tmp_path, {"image": "redis"}, name="a")
    fake_docker.write_text("")
    _start(tmp_path, {"image": "redis"}, name="b")
    lines = fake_docker.read_text().splitlines()
    assert any(ln.startswith("docker pull redis") for ln in lines), \
        "implied :latest must re-pull every start"


def test_network_mode_passthrough(tmp_path, fake_docker):
    net = NetworkResource(ip="10.0.0.1", reserved_ports=[20100],
                          dynamic_ports=["http"])
    _start(tmp_path, {"image": "redis:7.2", "network_mode": "host"},
           Resources(cpu=100, memory_mb=64, networks=[net]))
    line = _run_line(fake_docker)
    assert "--net host" in line


def test_cleanup_knobs_from_client_options(tmp_path, fake_docker):
    handle, _ad = _start(
        tmp_path, {"image": "redis:7.2"},
        options={"docker.cleanup.container": "false",
                 "docker.cleanup.image": "false"})
    assert handle.cleanup_container is False
    assert handle.cleanup_image is False
    fake_docker.write_text("")
    handle.kill()
    lines = fake_docker.read_text().splitlines()
    assert any(ln.startswith("docker stop") for ln in lines)
    assert not any(ln.startswith("docker rm ") for ln in lines)
    assert not any(ln.startswith("docker rmi") for ln in lines)


def test_cleanup_defaults_remove_container_and_image(tmp_path,
                                                     fake_docker):
    handle, _ad = _start(tmp_path, {"image": "redis:7.2"})
    fake_docker.write_text("")
    handle.kill()
    lines = fake_docker.read_text().splitlines()
    assert any(ln.startswith("docker rm -f cid-12345") for ln in lines)
    assert any(ln.startswith("docker rmi sha256:id-redis_7.2")
               for ln in lines)


def test_reattach_roundtrip_carries_image_and_flags(tmp_path,
                                                    fake_docker):
    handle, _ad = _start(tmp_path, {"image": "redis:7.2"})
    drv = BUILTIN_DRIVERS["docker"](ExecContext(None, "x"))
    re = drv.open(handle.id())
    assert re.container_id == handle.container_id
    assert re.image_id == handle.image_id
    assert re.cleanup_container is True and re.cleanup_image is True


def test_latest_pull_failure_falls_back_to_cache(tmp_path, fake_docker,
                                                 monkeypatch):
    """An unreachable registry must not fail a task whose image is in
    the local cache (':latest' freshness pull is best-effort)."""
    # Prime the cache, then make pulls fail.
    _start(tmp_path, {"image": "redis"}, name="prime")
    state = tmp_path / "docker-state"
    bindir = tmp_path / "fakebin"
    exe = bindir / "docker"
    script = exe.read_text().replace(
        'pull)\n    img=$(echo "$2" | tr \'/:\' \'__\')\n    touch "$state/$img" ;;',
        'pull) echo "registry unreachable" >&2; exit 1 ;;')
    assert "registry unreachable" in script, "fake rewrite failed"
    exe.write_text(script)
    handle, _ad = _start(tmp_path, {"image": "redis"}, name="offline")
    assert handle.container_id == "cid-12345"
    assert handle.image_id == "sha256:id-redis"


# -- parity with the JAX package ---------------------------------------------

PACKAGES = ("nomad_tpu", "nomad_tpu_torch")
ALLOC_ID = "a1b2c3d4e5f6-parity"
# A fake of each driver's binary: it logs its argv (``$@``), and the
# task's NOMAD_* environment when it is the task itself.
FAKES = {
    "java": 'if [ "$1" = "-version" ]; then '
            'echo \'openjdk version "21.0.2" 2024\' >&2; fi',
    "qemu-system-x86_64": 'if [ "$1" = "--version" ]; then '
                          'echo "QEMU emulator version 8.2.1"; fi',
    "rkt": 'if [ "$1" = "version" ]; then echo "rkt Version: 1.30.0"; '
           'echo "appc Version: 0.8.11"; fi',
    "tool": 'env | grep "^NOMAD_" | sort >> "$LOG"',
}
NET = {"ip": "10.0.0.1", "mbits": 10, "reserved_ports": [8080, 20100, 20200],
       "dynamic_ports": ["http", "6379"]}
TASKS = {
    "raw_exec": dict(config={"command": "{bin}/tool",
                             "args": "alpha 'beta gamma' --flag=1"},
                     meta={"owner": "ops"}, env={"MODE": "fast"}),
    "exec": dict(config={"command": "/usr/bin/id", "args": "-u -n"}),
    "java": dict(config={"jar_path": "/srv/app.jar",
                         "jvm_options": "-Xmx128m -Dx=1",
                         "args": "serve --port 8080"}),
    "qemu": dict(config={"image_path": "/srv/disk.img",
                         "accelerator": "tcg", "port_map": {"http": 80}},
                 networks=[NET]),
    "docker": dict(config={"image": "redis:7.2", "port_map": {"http": 5432},
                           "command": "redis-server",
                           "args": "--appendonly yes"},
                   networks=[NET]),
    "rkt": dict(config={"image": "coreos.com/etcd:v2.0.4",
                        "command": "/etcd", "args": "--version"}),
}


def _modules(package):
    get = importlib.import_module
    return dict(
        AllocDir=get(f"{package}.client.allocdir").AllocDir,
        ExecContext=get(f"{package}.client.driver.base").ExecContext,
        drivers=get(f"{package}.client.driver").BUILTIN_DRIVERS,
        exec_mod=get(f"{package}.client.driver.exec_driver"),
        ClientConfig=get(f"{package}.client").ClientConfig,
        structs=get(f"{package}.structs"))


def _task(structs, driver, bindir):
    spec = TASKS[driver]
    config = {k: (v.format(bin=bindir) if isinstance(v, str) else v)
              for k, v in spec["config"].items()}
    nets = [structs.NetworkResource(**n) for n in spec.get("networks", [])]
    return structs.Task(
        name="task", driver=driver, config=config,
        meta=dict(spec.get("meta", {})), env=dict(spec.get("env", {})),
        resources=structs.Resources(cpu=250, memory_mb=128, networks=nets))


def _drive(package, driver, root, bindir, log, monkeypatch):
    """Fingerprint and start ``driver`` from ``package`` on a fake
    docker with no image pulled; returns what the node and the fake
    binaries saw."""
    state = bindir.parent / "docker-state"
    for image in state.iterdir():
        image.unlink()
    m = _modules(package)
    cls = m["drivers"][driver]
    node = m["structs"].Node(attributes={"kernel.name": "linux"})
    options = {"driver.raw_exec.enable": "1"}
    found = cls.fingerprint(m["ClientConfig"](options=options), node)
    task = _task(m["structs"], driver, bindir)
    ad = m["AllocDir"](root)
    ad.build([task])
    spawned = []
    if driver == "exec":
        ex = m["exec_mod"].ExecDriver
        monkeypatch.setattr(ex, "_populate_chroot", lambda self, t: None)
        monkeypatch.setattr(ex, "_make_cgroup", lambda self, t: "")
        monkeypatch.setattr(ex, "spawn", lambda self, t, argv, kind: (
            spawned.append((list(argv), kind)) or "spawned"))
    drv = cls(m["ExecContext"](ad, ALLOC_ID, options=options))
    handle = drv.start(task)
    if driver == "docker":
        handle_id = handle.id()
        handle.kill()
    elif driver == "exec":
        handle_id = handle
    else:
        assert handle.wait(10) == 0
        handle_id = handle.id().split(":")[0]  # kind:pid
    logged = ""
    if log.exists():  # the exec case spawns nothing
        logged = log.read_text()
        log.unlink()
    ad.destroy()
    return dict(found=found, attributes=node.attributes, handle=handle_id,
                logged=logged, spawned=spawned)


@pytest.mark.parametrize("driver", [
    "raw_exec", "java", "qemu", "docker",
    pytest.param("exec", marks=pytest.mark.skipif(
        not ROOT, reason="exec isolation is root-only")),
    pytest.param("rkt", marks=pytest.mark.skipif(
        not ROOT, reason="rkt driver is root-only"))])
def test_driver_logs_the_jax_drivers_invocations(driver, tmp_path,
                                                 fake_docker, monkeypatch):
    bindir = tmp_path / "fakebin"  # fake_docker's, first on PATH
    log = tmp_path / "invocations.log"
    monkeypatch.setenv("LOG", str(log))
    for name, body in FAKES.items():
        exe = bindir / name
        exe.write_text(f'#!/bin/sh\necho "{name} $@" >> {log}\n{body}\n')
        exe.chmod(0o755)
    root = str(tmp_path / "alloc")
    jax_side = _drive("nomad_tpu", driver, root, bindir, log, monkeypatch)
    port_side = _drive("nomad_tpu_torch", driver, root, bindir, log,
                       monkeypatch)
    assert port_side == jax_side
    assert port_side["found"] and port_side["attributes"][f"driver.{driver}"]
    assert port_side["logged"] or port_side["spawned"]
