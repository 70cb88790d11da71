"""exec driver: isolated execution via cgroups v2 + chroot.

Capability parity with reference client/driver/exec.go +
reference client/executor/exec_linux.go: root-only; places the task
in its own cgroup (cpu.weight from cpu shares, memory.max from the memory
limit) and chroots into the task directory populated with a minimal system
image.  Falls back to plain subprocess isolation when not root (the
reference's universal executor, executor/exec_universal.go).
"""
from __future__ import annotations

import logging
import os
import shutil

from .base import Driver, ProcessHandle, parse_command

logger = logging.getLogger("nomad_tpu_torch.client.driver.exec")

CGROUP_ROOT = "/sys/fs/cgroup"

# Host paths copied into the task chroot (reference executor chroot env).
CHROOT_ENV = {
    "/bin": "/bin",
    "/usr/bin": "/usr/bin",
    "/lib": "/lib",
    "/lib64": "/lib64",
    "/usr/lib": "/usr/lib",
    "/etc/ld.so.cache": "/etc/ld.so.cache",
    "/etc/ld.so.conf": "/etc/ld.so.conf",
    "/etc/passwd": "/etc/passwd",
}


def _cgroup2_available() -> bool:
    return os.path.isfile(os.path.join(CGROUP_ROOT, "cgroup.controllers"))


class ExecDriver(Driver):
    name = "exec"

    @classmethod
    def fingerprint(cls, cfg, node) -> bool:
        if node.attributes.get("kernel.name") != "linux":
            return False
        node.attributes["driver.exec"] = "1"
        return True

    def start(self, task):
        argv = parse_command(task)
        if os.geteuid() != 0:
            # Universal fallback: no privileged isolation available.
            return self.spawn(task, argv, kind="exec")

        task_dir = self.ctx.alloc_dir.task_dirs[task.name]
        # Resolve the run-as user FIRST: an unknown user fails in
        # microseconds, before paying chroot population or leaving a
        # cgroup dir behind.
        uid, gid = self._drop_identity(task)
        self._populate_chroot(task)
        cgroup = self._make_cgroup(task)

        # Re-exec through a shim that joins the cgroup, chroots, then drops
        # privileges (setgid/setgroups/setuid — reference executor drops to
        # user `nobody` after chroot, client/executor/exec_linux.go) before
        # exec'ing the task command.
        import sys

        shim = [
            sys.executable, "-c",
            ("import os,sys;"
             "cg=sys.argv[1];root=sys.argv[2];"
             "uid=int(sys.argv[3]);gid=int(sys.argv[4]);"
             "cg and open(cg+'/cgroup.procs','w').write(str(os.getpid()));"
             "os.chroot(root);os.chdir('/');"
             "gid>=0 and (os.setgroups([]),os.setgid(gid));"
             "uid>=0 and os.setuid(uid);"
             "os.execvp(sys.argv[5], sys.argv[5:])"),
            cgroup or "", task_dir, str(uid), str(gid),
        ] + argv
        handle = self.spawn(task, shim, kind="exec")
        return handle

    def _drop_identity(self, task) -> tuple:
        """Resolve the unprivileged identity to run the task as.

        Defaults to ``nobody`` (reference exec_linux.go); the task config's
        ``user`` overrides it; ``user = "root"`` keeps root.  Returns
        (-1, -1) when the drop is disabled (explicit root, or no pwd
        database on the platform); raises RuntimeError for an unknown
        user — fail closed, never silently run as root.
        """
        user = task.config.get("user") or "nobody"
        if user == "root":
            return -1, -1
        try:
            import pwd
        except ImportError:  # pragma: no cover - non-POSIX host
            logger.warning("no pwd database on this platform; exec "
                           "privilege drop unavailable, keeping root")
            return -1, -1
        try:
            ent = pwd.getpwnam(user)
        except KeyError:
            # Fail CLOSED: chroot contents are hardlinked host inodes, so
            # silently running as root would hand a typo'd `user` write
            # access to host system files.  Root must be asked for by
            # name (user = "root").
            raise RuntimeError(
                f"exec task user {user!r} does not exist on this node; "
                "set user = \"root\" explicitly to run as root")
        # chown the task dir so the dropped user can write its cwd/logs.
        task_dir = self.ctx.alloc_dir.task_dirs[task.name]
        try:
            os.chown(task_dir, ent.pw_uid, ent.pw_gid)
            local = os.path.join(task_dir, "local")
            if os.path.isdir(local):
                os.chown(local, ent.pw_uid, ent.pw_gid)
        except OSError:
            pass
        return ent.pw_uid, ent.pw_gid

    def _populate_chroot(self, task) -> None:
        embed = {src: dst for src, dst in CHROOT_ENV.items()
                 if os.path.exists(src)}
        self.ctx.alloc_dir.embed(task.name, embed)
        task_dir = self.ctx.alloc_dir.task_dirs[task.name]
        for d in ("proc", "tmp", "dev"):
            os.makedirs(os.path.join(task_dir, d), exist_ok=True)

    def _make_cgroup(self, task) -> str:
        if not _cgroup2_available():
            return ""
        name = f"nomad-{self.ctx.alloc_id[:8]}-{task.name}"
        path = os.path.join(CGROUP_ROOT, name)
        try:
            os.makedirs(path, exist_ok=True)
            res = task.resources
            if res.memory_mb:
                with open(os.path.join(path, "memory.max"), "w") as fh:
                    fh.write(str(res.memory_mb * 1024 * 1024))
            if res.cpu:
                # cpu.weight 1-10000; scale MHz shares into the range.
                weight = max(1, min(10000, res.cpu * 10 // 100))
                with open(os.path.join(path, "cpu.weight"), "w") as fh:
                    fh.write(str(weight))
        except OSError as e:
            logger.warning("cgroup setup failed (%s); running without", e)
            return ""
        return path
