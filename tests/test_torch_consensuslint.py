"""The port's consensus-plane lint against the JAX package's.

1. Every synthetic package of ``tests/test_consensuslint.py`` gives the
   same findings (and the same endpoint-contract coverage) from the JAX
   package's five shared passes and the port's.
2. The five shared passes over the whole of ``nomad_tpu_torch/`` (one
   parse for the module): the port's give the JAX passes' findings
   plus only the port's own device round trips, and the same
   consensus-plane coverage — the endpoint read-consistency contract
   of the port's server is the JAX server's.
"""
from __future__ import annotations

import os

import pytest

from tests import torch_lint_cases as cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = cases.harvest("test_consensuslint.py")


@pytest.mark.parametrize("files", [c[1] for c in CASES],
                         ids=[c[0].split("::")[1] for c in CASES])
def test_jax_suite_package_reads_alike(files, tmp_path):
    cases.assert_reads_alike(tmp_path, files)


@pytest.fixture(scope="module")
def port_tree():
    from nomad_tpu_torch.analysis import lockcheck

    tree = os.path.join(REPO, "nomad_tpu_torch")
    scan = lockcheck.scan_package(tree)
    jax_cov: dict = {}
    torch_cov: dict = {}
    jax = cases.shared_findings("jax", tree, coverage_out=jax_cov)
    port = cases.shared_findings("torch", tree, scan=scan,
                                 coverage_out=torch_cov)
    return jax, port, jax_cov, torch_cov


def test_port_tree_reads_alike(port_tree):
    jax, port, _jc, _tc = port_tree
    jax_keys = {f.key for f in jax}
    extra = [f for f in port if f.key not in jax_keys]
    assert extra and all(cases.is_torch_round_trip(f) for f in extra), \
        [f.render() for f in extra]
    assert cases.keyed([f for f in port if f not in extra]) == \
        cases.keyed(jax)


def test_port_tree_torch_round_trips_are_the_rigs(port_tree):
    """The one place the port holds a lock across a device round trip
    is the test rig's VerifyingPlanner (allowlisted with its reason)."""
    jax, port, _jc, _tc = port_tree
    jax_keys = {f.key for f in jax}
    assert sorted({f.key for f in port if f.key not in jax_keys}) == [
        "blocking-under-lock:nomad_tpu_torch/scheduler/harness.py:"
        "VerifyingPlanner.submit_plans[?._lock]"]


def test_port_tree_consensus_coverage_alike(port_tree):
    _j, _p, jax_cov, torch_cov = port_tree
    assert torch_cov["consensuslint"] == jax_cov["consensuslint"]
    assert torch_cov["consensuslint"]["endpoint_contract"]


def test_port_tree_failure_coverage_alike(port_tree):
    _j, _p, jax_cov, torch_cov = port_tree
    assert torch_cov["faultlint"] == jax_cov["faultlint"]
    assert torch_cov["faultlint"]["covered_fraction"] == 1.0


def test_port_endpoint_contract_matches_the_jax_servers(port_tree):
    """The port's endpoint classification (stale-safe / leader-only /
    write / server-local) is the JAX server's, method for method."""
    from nomad_tpu.analysis import consensuslint as jax_cons

    _j, _p, _jc, torch_cov = port_tree
    cov: dict = {}
    jax_cons.analyze_package(os.path.join(REPO, "nomad_tpu"),
                             coverage_out=cov)
    assert torch_cov["consensuslint"]["endpoint_contract"] == \
        cov["endpoint_contract"]
