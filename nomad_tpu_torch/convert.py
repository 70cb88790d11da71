"""Carry cluster state from the JAX package into the port.

This system has no weights: what the two packages must share to be
compared is the cluster itself (nodes, jobs, allocations).  The
functions here take objects of the JAX package ``nomad_tpu`` (or any
objects with the same ``to_dict()`` wire shape) and rebuild the port's
own objects with ``from_dict``.  The module imports nothing of
``nomad_tpu``: it reads only the plain dicts, so one mock cluster can be
loaded into both packages.
"""
from __future__ import annotations

from typing import Iterable

from nomad_tpu_torch.structs import Allocation, Job, Node, NodeSlab, Plan


def _plain(obj) -> dict:
    return obj if isinstance(obj, dict) else obj.to_dict()


def nodes_from_reference(nodes: Iterable) -> list:
    """Port ``Node`` objects equal, field by field, to ``nodes``."""
    return [Node.from_dict(_plain(n)) for n in nodes]


def jobs_from_reference(jobs: Iterable) -> list:
    """Port ``Job`` objects equal, field by field, to ``jobs``."""
    return [Job.from_dict(_plain(j)) for j in jobs]


def allocs_from_reference(allocs: Iterable) -> list:
    """Port ``Allocation`` objects equal, field by field, to ``allocs``."""
    return [Allocation.from_dict(_plain(a)) for a in allocs]


def plans_from_reference(plans: Iterable) -> list:
    """Port ``Plan`` objects equal, field by field, to ``plans``: the
    same evictions, placements and failed allocs under the same alloc
    ids, so one recorded plan stream can be verified by both
    packages."""
    return [Plan.from_dict(_plain(p)) for p in plans]


def node_slab_from_reference(slab) -> NodeSlab:
    """A port ``NodeSlab`` with the columns of ``slab`` (a JAX-package
    ``NodeSlab``): the same ids, names, datacenters, per-row cidrs and
    ips, and a template equal field by field, so twin stores hold the
    same node ids."""
    def col(c):
        return c if c is None or isinstance(c, str) else list(c)
    return NodeSlab(
        ids=list(slab.ids), names=list(slab.names),
        datacenters=col(slab.datacenters),
        template=Node.from_dict(_plain(slab.template)),
        cidrs=col(slab.cidrs), ips=col(slab.ips))
