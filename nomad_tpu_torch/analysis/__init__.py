"""Static analysis and runtime sanitizers for ``nomad_tpu_torch/``.

Counterpart of ``nomad_tpu/analysis/``: the repo's ``go vet`` + ``-race``
analogue, pointed at the port.  ``python -m nomad_tpu_torch.cli lint``
runs every static pass over ``nomad_tpu_torch/`` and gates on
``LINT_ALLOWLIST_TORCH.txt`` at the repo root (the JAX package's ledger,
``LINT_ALLOWLIST.txt``, is never read here).  The passes and their JAX
counterparts:

  - ``lockcheck`` (same name): guarded-attribute discipline and the
    syntactic lock-order graph.  Same rules, same keys.
  - ``callgraph`` (same name): the whole-program call graph the
    interprocedural passes ride.  Same resolution rules.
  - ``blocking`` (same name): blocking-under-lock, cross-function lock
    order and thread/future/event lifecycle.  Its device round trips
    gain the port's: ``devices.fetch_host``, ``torch.cuda.synchronize``
    / ``Event.synchronize`` / ``Stream.synchronize``, and ``.item()`` /
    ``.cpu()`` / ``.tolist()`` on a value a CUDA tensor may reach.
  - ``consensuslint`` (same name): FSM apply determinism, leadership
    fencing and the endpoint read-consistency contract.  Same rules.
  - ``faultlint`` (same name): deadline propagation, fault-injectability
    coverage and retry safety.  Same rules.
  - ``torchlint`` (for ``jaxlint``): ``concretize`` and
    ``tensor-branch`` (for ``traced-branch``) over every kernel wrapper
    (a function that reaches ``kernels.library`` / ``kernels.check``)
    and the in-package functions it calls.  ``impure-call``,
    ``attr-mutation`` and ``global-mutation`` are left out: under
    ``jax.jit`` those effects run once at trace time and freeze into
    the compiled kernel, but a wrapper is eager Python that runs every
    call, so they describe nothing here.
  - ``devlint`` (same name): ``mesh-bypass``, ``sharding-mix``,
    ``resident-bypass`` (a raw ``.to(cuda)`` / ``.cuda()`` /
    ``torch.as_tensor(..., device=)`` / ``torch.tensor(..., device=)``
    outside ``parallel/devices.py`` and the counted seams),
    ``transfer-under-lock`` and ``transfer-in-hot-loop``, with the
    wrappers as kernels.  ``recompile-churn`` is left out: the port
    compiles each ``.cu`` source once under a digest of the source and
    the flags, and shapes are launch arguments, so no cache grows with
    them.
  - ``sanitizers`` (same name): ``LockOrderWitness``,
    ``ReplicaDivergenceSanitizer``, ``BudgetWitnessSanitizer`` and a
    torch ``TransferGuardSanitizer`` (a thread-local
    ``TorchFunctionMode`` entered inside each dispatch seam).
    ``RecompileSentinel`` is left out for the reason given under
    ``recompile-churn``.

The AST passes import no torch; only the sanitizers do.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterable, Optional

__all__ = [
    "Finding", "run_lint", "load_allowlist", "partition_findings",
    "default_package_root", "default_allowlist_path",
]

# The port's allowlist, at the repo root beside the JAX package's.
ALLOWLIST_NAME = "LINT_ALLOWLIST_TORCH.txt"


@dataclass(frozen=True)
class Finding:
    """One analyzer finding.

    ``key`` (the allowlist identity) deliberately excludes line numbers so
    entries survive unrelated edits; ``line`` is for humans.
    """

    rule: str         # e.g. "bare-write", "lock-cycle", "tensor-branch"
    path: str         # repo-relative file path
    where: str        # Class.attr, Class.method, or function qualname
    message: str
    line: int = 0
    severity: str = "error"   # "error" gates CI; "info" is advisory

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.where}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.where}: {self.message}"


def default_package_root() -> str:
    """``nomad_tpu_torch/``, the package these passes lint."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def default_allowlist_path() -> str:
    """``LINT_ALLOWLIST_TORCH.txt`` beside the package."""
    root = default_package_root()
    return os.path.join(os.path.dirname(root), ALLOWLIST_NAME)


def load_allowlist(path: str) -> dict:
    """Parse the allowlist: one ``finding-key # justification`` per line.

    Every entry MUST carry a justification comment — an allowlist is a
    reviewed ledger of accepted risk, not a mute button; entries without
    one are rejected so they can't slip through review.
    """
    entries: dict = {}
    if not os.path.exists(path):
        return entries
    with open(path) as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, why = line.partition("#")
            key = key.strip()
            why = why.strip()
            if not sep or not why:
                raise ValueError(
                    f"{path}:{lineno}: allowlist entry {key!r} has no "
                    f"justification comment (format: 'key  # why')")
            entries[key] = why
    return entries


def run_lint(package_dir: Optional[str] = None,
             strict: bool = False,
             coverage_out: Optional[dict] = None,
             scan=None, graph=None) -> list:
    """Run every static pass over a package tree; returns [Finding].

    The tree is parsed once for lockcheck (``scan_package``) and once
    for the call graph; pass ``scan`` and ``graph`` to reuse a parse
    (tests lint one tree from several checks).  The interprocedural
    passes (blocking.py) ride both, AFTER lockcheck so its syntactic
    lock-order results are known and not double-reported.  Pass a dict
    as ``coverage_out`` to receive the call graph's self-coverage and
    the device-, consensus- and failure-plane passes' coverage blocks.
    """
    from . import (blocking, callgraph, consensuslint, devlint, faultlint,
                   lockcheck, torchlint)

    package_dir = package_dir or default_package_root()
    if not os.path.isdir(package_dir):
        raise FileNotFoundError(package_dir)
    if scan is None:
        scan = lockcheck.scan_package(package_dir)
    _pkg, trees, err = scan
    if graph is None:
        graph = callgraph.CallGraph.build(
            package_dir, parsed=trees if err is None else None)
    findings: list = []
    findings.extend(lockcheck.analyze_package(package_dir, strict=strict,
                                              scan=scan))
    findings.extend(blocking.analyze_package(package_dir, graph=graph,
                                             scan=scan))
    findings.extend(torchlint.analyze_package(package_dir, graph=graph))
    dev_cov: dict = {}
    findings.extend(devlint.analyze_package(package_dir, graph=graph,
                                            scan=scan,
                                            coverage_out=dev_cov))
    cons_cov: dict = {}
    findings.extend(consensuslint.analyze_package(package_dir, graph=graph,
                                                  scan=scan,
                                                  coverage_out=cons_cov))
    fault_cov: dict = {}
    findings.extend(faultlint.analyze_package(package_dir, graph=graph,
                                              scan=scan,
                                              coverage_out=fault_cov))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if coverage_out is not None:
        coverage_out.update(graph.coverage())
        coverage_out["devlint"] = dev_cov
        coverage_out["consensuslint"] = cons_cov
        coverage_out["faultlint"] = fault_cov
    return findings


def partition_findings(findings: Iterable[Finding], allowlist: dict
                       ) -> tuple[list, list, list]:
    """Split findings into (gating, allowlisted, stale_allowlist_keys).

    ``stale`` entries — allowlist keys matching no current finding — are
    surfaced so the ledger shrinks as real fixes land instead of
    accreting dead waivers.
    """
    gating: list = []
    allowed: list = []
    seen: set = set()
    for f in findings:
        if f.key in allowlist:
            seen.add(f.key)
            allowed.append(f)
        elif f.severity == "error":
            gating.append(f)
    stale = [k for k in allowlist if k not in seen]
    return gating, allowed, stale
