"""Task artifact fetching: download driver payloads into the task dir.

Capability parity with the reference's driver-side artifact handling
(reference client/driver/java.go:96-130 — jar downloaded into the
task dir before launch — and qemu.go:95-150 — VM image downloaded with
checksum verification).  The checksum rides either the config or a
``?checksum=sha256:<hex>`` query parameter on the source URL, the
reference's go-getter convention.

Failures raise ArtifactError, which driver ``start`` surfaces as a task
error (the TaskRunner records it and applies restart policy).
"""
from __future__ import annotations

import hashlib
import os
import shutil
import urllib.parse
import urllib.request

FETCH_TIMEOUT = 300.0


class ArtifactError(Exception):
    """Artifact download or verification failed (task error)."""


def _parse_checksum(spec: str) -> tuple[str, str]:
    """"sha256:<hex>" (or bare hex, sha256 implied) -> (algo, hexdigest)."""
    if ":" in spec:
        algo, _, digest = spec.partition(":")
    else:
        algo, digest = "sha256", spec
    algo = algo.lower()
    if algo not in hashlib.algorithms_available:
        raise ArtifactError(f"unsupported checksum algorithm {algo!r}")
    return algo, digest.lower()


def _verify(path: str, spec: str) -> None:
    algo, want = _parse_checksum(spec)
    h = hashlib.new(algo)
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    got = h.hexdigest()
    if got != want:
        os.unlink(path)
        raise ArtifactError(
            f"artifact checksum mismatch: got {algo}:{got}, "
            f"want {algo}:{want}")


def fetch_artifact(source: str, dest_dir: str, checksum: str = "") -> str:
    """Materialize ``source`` under ``dest_dir`` and return its path.

    - ``http(s)://`` URLs are downloaded (atomically: temp file +
      rename), honoring a ``?checksum=`` query parameter when no
      explicit ``checksum`` is given;
    - ``file://`` URLs and plain local paths are copied in;
    - ``checksum`` ("algo:hex" or bare sha256 hex) is verified against
      the materialized file; mismatch removes it and raises.
    """
    parsed = urllib.parse.urlparse(source)
    query_pairs = urllib.parse.parse_qsl(parsed.query)
    if not checksum:
        for k, v in query_pairs:
            if k == "checksum":
                checksum = v
                break
    name = os.path.basename(parsed.path) or "artifact"
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, name)

    if parsed.scheme in ("http", "https"):
        # Strip ONLY the checksum parameter: the rest of the query may
        # be load-bearing (presigned URLs, auth tokens).
        kept = urllib.parse.urlencode(
            [(k, v) for k, v in query_pairs if k != "checksum"])
        fetch_url = urllib.parse.urlunparse(parsed._replace(query=kept))
        tmp = f"{dest}.tmp.{os.getpid()}"
        try:
            with urllib.request.urlopen(fetch_url,
                                        timeout=FETCH_TIMEOUT) as resp, \
                    open(tmp, "wb") as out:
                shutil.copyfileobj(resp, out)
            # faultlint-ok(uninjectable-io): local artifact staging —
            # failures surface as ArtifactError and the fetch path is
            # driven directly in tests.
            os.replace(tmp, dest)
        except Exception as e:
            raise ArtifactError(
                f"failed to fetch artifact {fetch_url!r}: {e}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    else:
        if parsed.scheme == "file":
            # Percent-decoded filesystem path ("file:///a%20b.jar").
            src = urllib.request.url2pathname(parsed.path)
        elif checksum and parsed.query:
            # Plain path whose ?checksum= query we consumed: the path
            # component is the file.
            src = parsed.path
        else:
            src = source
        # Local path (plain or file://): copy into the task dir so the
        # task owns a stable, chroot-visible instance.
        try:
            shutil.copy2(src, dest)
        except OSError as e:
            raise ArtifactError(
                f"failed to copy artifact {src!r}: {e}") from e

    if checksum:
        _verify(dest, checksum)
    return dest


def fetch_task_artifact(ctx, task, source: str) -> str:
    """Driver-shared deployment path: materialize ``source`` in the
    task's local dir, honoring ``task.config['checksum']`` (or a
    URL-borne ``?checksum=``)."""
    dest = os.path.join(ctx.alloc_dir.task_dirs[task.name], "local")
    return fetch_artifact(source, dest, task.config.get("checksum", ""))
