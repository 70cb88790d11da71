"""Allocation directory tree.

Capability parity with reference client/allocdir/alloc_dir.go: per
allocation a shared ``alloc/{logs,tmp,data}`` tree plus a private ``local/``
dir per task; tasks see the shared dir via symlink (the portable analogue of
the reference's bind-mount/copy; chroot embedding lives in the exec driver).
"""
from __future__ import annotations

import os
import shutil

SHARED_ALLOC_NAME = "alloc"
SHARED_DIRS = ("logs", "tmp", "data")
TASK_LOCAL = "local"


class AllocDir:
    def __init__(self, alloc_root: str) -> None:
        self.alloc_dir = alloc_root
        self.shared_dir = os.path.join(alloc_root, SHARED_ALLOC_NAME)
        self.task_dirs: dict = {}

    def build(self, tasks: list) -> None:
        os.makedirs(self.shared_dir, exist_ok=True)
        for sub in SHARED_DIRS:
            os.makedirs(os.path.join(self.shared_dir, sub), exist_ok=True)
        for task in tasks:
            task_dir = os.path.join(self.alloc_dir, task.name)
            os.makedirs(os.path.join(task_dir, TASK_LOCAL), exist_ok=True)
            link = os.path.join(task_dir, SHARED_ALLOC_NAME)
            if not os.path.islink(link) and not os.path.exists(link):
                os.symlink(self.shared_dir, link)
            self.task_dirs[task.name] = task_dir

    def embed(self, task_name: str, entries: dict) -> None:
        """Populate a task dir with host paths (chroot population,
        reference alloc_dir.go Embed).

        The reference bind-mounts on Linux; here regular files are
        hardlinked when the alloc dir shares a filesystem with the host
        path (near-free for a multi-GB /usr/lib) and copied otherwise.
        Like bind mounts, hardlinks share the host inode — containment
        relies on the exec driver's privilege drop (tasks run as nobody,
        which cannot write the root-owned system files embedded here).
        """
        task_dir = self.task_dirs[task_name]
        for host_path, rel_dest in entries.items():
            dest = os.path.join(task_dir, rel_dest.lstrip("/"))
            if os.path.isdir(host_path):
                self._embed_tree(host_path, dest)
            elif os.path.isfile(host_path):
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                self._embed_file(host_path, dest)

    @staticmethod
    def _embed_file(src: str, dest: str) -> None:
        try:
            if os.path.exists(dest):
                st, dt = os.stat(src), os.stat(dest)
                if st.st_ino == dt.st_ino or (
                        st.st_size == dt.st_size
                        and st.st_mtime <= dt.st_mtime):
                    return
                os.unlink(dest)
            os.link(src, dest)
        except OSError:
            shutil.copy2(src, dest)

    def _embed_tree(self, src: str, dest: str) -> None:
        for root, dirs, files in os.walk(src):
            rel = os.path.relpath(root, src)
            target = dest if rel == "." else os.path.join(dest, rel)
            os.makedirs(target, exist_ok=True)
            for name in files + [d for d in dirs if os.path.islink(
                    os.path.join(root, d))]:
                s = os.path.join(root, name)
                d = os.path.join(target, name)
                if os.path.islink(s):
                    # Re-embed refreshes retargeted links; a same-target
                    # link is left alone.
                    link = os.readlink(s)
                    if os.path.lexists(d):
                        if os.path.islink(d) and os.readlink(d) == link:
                            continue
                        if os.path.isdir(d) and not os.path.islink(d):
                            continue  # don't replace a populated dir
                        os.unlink(d)
                    os.symlink(link, d)
                else:
                    # Dest is a symlink (dangling or not — lstat, don't
                    # follow) or a directory where the source now has a
                    # regular file: clear it so the refresh lands.
                    if os.path.islink(d):
                        os.unlink(d)
                    elif os.path.isdir(d):
                        shutil.rmtree(d, ignore_errors=True)
                    # _embed_file refreshes stale copies itself
                    # ((size, mtime) comparison; hardlinks short-circuit
                    # on inode equality).
                    self._embed_file(s, d)

    def log_path(self, task_name: str, kind: str) -> str:
        return os.path.join(self.shared_dir, "logs",
                            f"{task_name}.{kind}")

    def destroy(self) -> None:
        shutil.rmtree(self.alloc_dir, ignore_errors=True)
