"""Canonical mock fixtures for tests and benchmarks.

Capability parity with reference nomad/mock/mock.go — same shapes and
resource magnitudes so scheduler behavior (fit, scores, anti-affinity) is
comparable against the reference's test expectations.
"""
from __future__ import annotations

from nomad_tpu_torch.structs import (
    ALLOC_CLIENT_STATUS_PENDING,
    ALLOC_DESIRED_STATUS_RUN,
    EVAL_STATUS_PENDING,
    JOB_STATUS_PENDING,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    NODE_STATUS_READY,
    Allocation,
    Constraint,
    Evaluation,
    Job,
    NetworkResource,
    Node,
    Plan,
    PlanResult,
    Resources,
    Task,
    TaskGroup,
    generate_uuid,
)


def node(idx: int | None = None) -> Node:
    """A ready linux node: 4000 MHz cpu, 8 GiB mem, 100 GiB disk, 1 Gbit."""
    octet = 100 if idx is None else (idx % 250) + 1
    return Node(
        id=generate_uuid(),
        datacenter="dc1",
        name="foobar" if idx is None else f"node-{idx}",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "version": "0.1.0",
            "driver.exec": "1",
        },
        resources=Resources(
            cpu=4000,
            memory_mb=8192,
            disk_mb=100 * 1024,
            iops=150,
            networks=[NetworkResource(
                device="eth0", cidr=f"192.168.0.{octet}/32", mbits=1000)],
        ),
        reserved=Resources(
            cpu=100,
            memory_mb=256,
            disk_mb=4 * 1024,
            networks=[NetworkResource(
                device="eth0", ip=f"192.168.0.{octet}",
                reserved_ports=[22], mbits=1)],
        ),
        links={"consul": "foobar.dc1"},
        meta={"pci-dss": "true"},
        node_class="linux-medium-pci",
        status=NODE_STATUS_READY,
    )



def node_slab(n: int) -> "NodeSlab":
    """A columnar n-row fleet of exactly the mock ``node`` shape
    (structs/node_slab.py): one template node + dense id/name/endpoint
    columns, no per-row Node/Resources/NetworkResource construction.
    Row r materializes equal to ``node(r)`` except for its random
    uuid."""
    from nomad_tpu_torch.structs import NodeSlab, generate_uuids

    template = node(0)
    octets = [(i % 250) + 1 for i in range(n)]
    return NodeSlab(
        ids=generate_uuids(n),
        names=[f"node-{i}" for i in range(n)],
        datacenters="dc1",
        template=template,
        cidrs=[f"192.168.0.{o}/32" for o in octets],
        ips=[f"192.168.0.{o}" for o in octets],
    )

def job() -> Job:
    return Job(
        region="global",
        id=generate_uuid(),
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        all_at_once=False,
        datacenters=["dc1"],
        constraints=[Constraint(
            hard=True, l_target="$attr.kernel.name",
            r_target="linux", operand="=")],
        task_groups=[TaskGroup(
            name="web",
            count=10,
            tasks=[Task(
                name="web",
                driver="exec",
                config={"command": "/bin/date", "args": "+%s"},
                resources=Resources(
                    cpu=500,
                    memory_mb=256,
                    networks=[NetworkResource(
                        mbits=50, dynamic_ports=["http"])],
                ),
            )],
            meta={"elb_check_type": "http"},
        )],
        meta={"owner": "armon"},
        status=JOB_STATUS_PENDING,
        create_index=42,
        modify_index=99,
    )


def system_job() -> Job:
    j = job()
    j.type = JOB_TYPE_SYSTEM
    j.priority = 100
    j.task_groups[0].count = 1
    j.task_groups[0].meta = {}
    return j


def eval() -> Evaluation:  # noqa: A001 - mirrors reference fixture name
    return Evaluation(
        id=generate_uuid(),
        priority=50,
        type=JOB_TYPE_SERVICE,
        job_id=generate_uuid(),
        status=EVAL_STATUS_PENDING,
    )


def alloc() -> Allocation:
    j = job()
    a = Allocation(
        id=generate_uuid(),
        eval_id=generate_uuid(),
        node_id="foo",
        task_group="web",
        resources=Resources(
            cpu=500,
            memory_mb=256,
            networks=[NetworkResource(
                device="eth0", ip="192.168.0.100",
                reserved_ports=[12345], mbits=100,
                dynamic_ports=["http"])],
        ),
        task_resources={
            "web": Resources(
                cpu=500,
                memory_mb=256,
                networks=[NetworkResource(
                    device="eth0", ip="192.168.0.100",
                    reserved_ports=[5000], mbits=50,
                    dynamic_ports=["http"])],
            ),
        },
        job=j,
        job_id=j.id,
        desired_status=ALLOC_DESIRED_STATUS_RUN,
        client_status=ALLOC_CLIENT_STATUS_PENDING,
    )
    return a


def plan() -> Plan:
    return Plan(priority=50)


def plan_result() -> PlanResult:
    return PlanResult()
