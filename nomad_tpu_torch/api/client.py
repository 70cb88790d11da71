"""HTTP API client library.

Capability parity with reference api/api.go + jobs.go/nodes.go/
evaluations.go/allocations.go/agent.go/status.go: a typed client over the
agent's /v1 REST surface with blocking-query support.  Domain objects are
returned as structs (nomad_tpu_torch.structs) decoded from the wire dicts.

Counterpart of ``nomad_tpu/api/client.py``; the wire is the same, so
either package's client talks to either package's agent.
"""
from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Any, Optional

from nomad_tpu_torch.structs import Allocation, Evaluation, Job, Node


class APIError(Exception):
    def __init__(self, status: int, message: str) -> None:
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


@dataclass
class QueryOptions:
    region: str = ""
    allow_stale: bool = False
    wait_index: int = 0
    wait_time: float = 0.0
    pretty: bool = False

    def params(self) -> dict:
        out: dict = {}
        if self.region:
            out["region"] = self.region
        if self.allow_stale:
            out["stale"] = ""
        if self.wait_index:
            out["index"] = str(self.wait_index)
        if self.wait_time:
            out["wait"] = f"{self.wait_time}s"
        return out


@dataclass
class QueryMeta:
    last_index: int = 0


class APIClient:
    def __init__(self, address: str = "http://127.0.0.1:4646") -> None:
        self.address = address.rstrip("/")

    # -- transport ---------------------------------------------------------
    def _url(self, path: str, params: Optional[dict] = None) -> str:
        url = self.address + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return url

    def raw(self, method: str, path: str,
            params: Optional[dict] = None,
            body: Any = None) -> tuple[Any, QueryMeta]:
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self._url(path, params), data=data,
                                     method=method)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=330) as resp:
                meta = QueryMeta(
                    last_index=int(resp.headers.get("X-Nomad-Index") or 0))
                return json.loads(resp.read() or b"null"), meta
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read()).get("error", "")
            except Exception:
                message = str(e)
            raise APIError(e.code, message) from e

    def get(self, path: str, options: Optional[QueryOptions] = None):
        return self.raw("GET", path,
                        options.params() if options else None)

    def put(self, path: str, body: Any = None):
        return self.raw("PUT", path, None, body)

    def delete(self, path: str):
        return self.raw("DELETE", path)

    # -- Jobs ---------------------------------------------------------------
    def jobs_list(self, options=None) -> tuple[list, QueryMeta]:
        data, meta = self.get("/v1/jobs", options)
        return [Job.from_dict(j) for j in data or []], meta

    def job_register(self, job: Job) -> dict:
        data, _ = self.put("/v1/jobs", {"job": job.to_dict()})
        return data

    def job_info(self, job_id: str, options=None) -> tuple[Job, QueryMeta]:
        data, meta = self.get(f"/v1/job/{job_id}", options)
        return Job.from_dict(data), meta

    def job_deregister(self, job_id: str) -> dict:
        data, _ = self.delete(f"/v1/job/{job_id}")
        return data

    def job_allocations(self, job_id: str, options=None
                        ) -> tuple[list, QueryMeta]:
        data, meta = self.get(f"/v1/job/{job_id}/allocations", options)
        return [Allocation.from_dict(a) for a in data or []], meta

    def job_evaluations(self, job_id: str, options=None
                        ) -> tuple[list, QueryMeta]:
        data, meta = self.get(f"/v1/job/{job_id}/evaluations", options)
        return [Evaluation.from_dict(e) for e in data or []], meta

    def job_evaluate(self, job_id: str) -> dict:
        data, _ = self.put(f"/v1/job/{job_id}/evaluate")
        return data

    # -- Nodes --------------------------------------------------------------
    def nodes_list(self, options=None) -> tuple[list, QueryMeta]:
        data, meta = self.get("/v1/nodes", options)
        return [Node.from_dict(n) for n in data or []], meta

    def node_info(self, node_id: str, options=None
                  ) -> tuple[Node, QueryMeta]:
        data, meta = self.get(f"/v1/node/{node_id}", options)
        return Node.from_dict(data), meta

    def node_allocations(self, node_id: str, options=None
                         ) -> tuple[list, QueryMeta]:
        data, meta = self.get(f"/v1/node/{node_id}/allocations", options)
        return [Allocation.from_dict(a) for a in data or []], meta

    def node_drain(self, node_id: str, enable: bool) -> dict:
        data, _ = self.raw("PUT", f"/v1/node/{node_id}/drain",
                           {"enable": "true" if enable else "false"})
        return data

    def node_evaluate(self, node_id: str) -> dict:
        data, _ = self.put(f"/v1/node/{node_id}/evaluate")
        return data

    # -- Evaluations ---------------------------------------------------------
    def evaluations_list(self, options=None) -> tuple[list, QueryMeta]:
        data, meta = self.get("/v1/evaluations", options)
        return [Evaluation.from_dict(e) for e in data or []], meta

    def eval_info(self, eval_id: str, options=None
                  ) -> tuple[Evaluation, QueryMeta]:
        data, meta = self.get(f"/v1/evaluation/{eval_id}", options)
        return Evaluation.from_dict(data), meta

    def eval_allocations(self, eval_id: str, options=None
                         ) -> tuple[list, QueryMeta]:
        data, meta = self.get(f"/v1/evaluation/{eval_id}/allocations",
                              options)
        return [Allocation.from_dict(a) for a in data or []], meta

    # -- Allocations ---------------------------------------------------------
    def allocations_list(self, options=None) -> tuple[list, QueryMeta]:
        data, meta = self.get("/v1/allocations", options)
        return [Allocation.from_dict(a) for a in data or []], meta

    def alloc_info(self, alloc_id: str, options=None
                   ) -> tuple[Allocation, QueryMeta]:
        data, meta = self.get(f"/v1/allocation/{alloc_id}", options)
        return Allocation.from_dict(data), meta

    # -- Agent / Status -------------------------------------------------------
    def agent_self(self) -> dict:
        data, _ = self.get("/v1/agent/self")
        return data

    def agent_monitor(self, lines: int = 0) -> list:
        """Recent agent log lines from the in-process ring
        (/v1/agent/monitor; reference command/agent/log_writer.go)."""
        return self.agent_monitor_since(0, lines)[0]

    def agent_monitor_since(self, since: int,
                            lines: int = 0) -> tuple[list, int]:
        """(lines after monotonic offset ``since`` — newest ``lines``
        of them when nonzero — and the next offset): follow-mode
        polling without re-printing on ring wraps."""
        params: dict = {"since": int(since)}
        if lines:
            params["lines"] = int(lines)
        data, _ = self.raw("GET", "/v1/agent/monitor", params)
        return data.get("lines", []), int(data.get("offset", 0))

    def agent_metrics(self, filter: str = "") -> dict:
        """The unified metrics document (/v1/agent/metrics):
        ``providers`` = flattened nomad.* registry gauges, ``inmem`` =
        the in-memory telemetry sink's counters/gauges/samples.
        ``filter`` trims provider keys server-side (substring match) —
        the watch poller's payload diet."""
        params = {"filter": filter} if filter else None
        data, _ = self.raw("GET", "/v1/agent/metrics", params)
        return data

    def agent_members(self) -> list:
        data, _ = self.get("/v1/agent/members")
        return data.get("members", [])

    def agent_join(self, address: str) -> dict:
        data, _ = self.raw("PUT", "/v1/agent/join", {"address": address})
        return data

    def agent_force_leave(self, node: str) -> None:
        self.raw("PUT", "/v1/agent/force-leave", {"node": node})

    def agent_servers(self) -> list:
        data, _ = self.get("/v1/agent/servers")
        return data

    def agent_set_servers(self, servers: list) -> None:
        self.put("/v1/agent/servers", {"servers": list(servers)})

    def status_leader(self) -> str:
        data, _ = self.get("/v1/status/leader")
        return data

    def status_peers(self) -> list:
        data, _ = self.get("/v1/status/peers")
        return data
