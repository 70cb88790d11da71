// _nomad_torch_native: C++ hot-path helpers for the port's host
// scheduling plane.
//
// The port's own copy of the JAX package's native/port_alloc.cpp (ABI 6),
// under a module name of its own so that both packages' extensions can be
// loaded into one interpreter.  The scheduler's finish loop (per-placement
// port assignment and Allocation construction) runs here through the C API:
// bulk_finish_cols / bulk_finish_many fill the columnar AllocSlab
// (nomad_tpu_torch/structs/alloc_slab.py), bulk_finish builds the object
// contract, and both hand the placement list back to the Python tail at the
// first case that needs it.
//
// Built at first use by nomad_tpu_torch/utils/native.py with g++ and the
// Python headers into nomad_tpu_torch/_build/; a failed build raises (there
// is no pure-Python fallback behind it).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <random>
#include <vector>

namespace {

thread_local std::mt19937 rng{std::random_device{}()};

// GC-untrack a freshly built, final-state object (no-op if untracked).
//
// Every object bulk_finish creates is acyclic BY CONSTRUCTION: allocs /
// metrics / resources / offers form trees whose only outbound edges go
// to long-lived store objects (job, strings) that never point back
// (nomad_tpu_torch/state/store.py's immutability contract).  Refcounting alone
// reclaims them; leaving them GC-tracked only makes every young-gen
// collection scan the full burst (~1M objects per 64-eval storm, ~0.5 s
// of scanning that finds zero garbage) and re-scan the store's alloc
// table forever after.  Untracking is applied strictly AFTER an object's
// last mutation — CPython re-tracks dicts on insertion of container
// values, so ordering matters for dicts (instances and lists stay
// untracked once untracked).  tests/test_torch_columnar_alloc.py asserts
// these objects are still reclaimed by refcount alone.
inline void gc_untrack(PyObject* o) {
  if (o != nullptr) PyObject_GC_UnTrack(o);
}

// assign_ports(used: set[int], reserved: sequence[int], n_dynamic: int,
//              min_port: int, max_port: int, attempts: int)
//   -> list[int] | None
//
// Mirrors NetworkIndex.assign_network's port logic exactly: reserved ports
// must not collide with `used`; each dynamic port is picked uniformly from
// [min_port, max_port) avoiding `used` and already-picked ports, with a
// bounded number of attempts.  Returns the full offer port list
// (reserved + dynamic) or None on failure.  `used` is NOT mutated.
PyObject* assign_ports(PyObject*, PyObject* args) {
  PyObject* used;
  PyObject* reserved;
  Py_ssize_t n_dynamic;
  long min_port, max_port;
  Py_ssize_t attempts;
  if (!PyArg_ParseTuple(args, "OOnlln", &used, &reserved, &n_dynamic,
                        &min_port, &max_port, &attempts)) {
    return nullptr;
  }
  if (!PySet_Check(used)) {
    PyErr_SetString(PyExc_TypeError, "used must be a set");
    return nullptr;
  }

  PyObject* reserved_fast =
      PySequence_Fast(reserved, "reserved must be a sequence");
  if (reserved_fast == nullptr) return nullptr;
  Py_ssize_t n_reserved = PySequence_Fast_GET_SIZE(reserved_fast);

  PyObject* out = PyList_New(0);
  if (out == nullptr) {
    Py_DECREF(reserved_fast);
    return nullptr;
  }

  // Reserved ports: collision -> None.
  for (Py_ssize_t i = 0; i < n_reserved; i++) {
    PyObject* port = PySequence_Fast_GET_ITEM(reserved_fast, i);
    int hit = PySet_Contains(used, port);
    if (hit < 0) goto fail;
    if (hit) {
      Py_DECREF(reserved_fast);
      Py_DECREF(out);
      Py_RETURN_NONE;
    }
    if (PyList_Append(out, port) < 0) goto fail;
  }

  {
    std::uniform_int_distribution<long> dist(min_port, max_port - 1);
    for (Py_ssize_t d = 0; d < n_dynamic; d++) {
      bool placed = false;
      for (Py_ssize_t a = 0; a < attempts; a++) {
        long candidate = dist(rng);
        PyObject* port = PyLong_FromLong(candidate);
        if (port == nullptr) goto fail;
        int hit = PySet_Contains(used, port);
        if (hit < 0) {
          Py_DECREF(port);
          goto fail;
        }
        if (!hit) {
          // Also avoid ports already picked into this offer.
          int dup = PySequence_Contains(out, port);
          if (dup < 0) {
            Py_DECREF(port);
            goto fail;
          }
          if (!dup) {
            int rc = PyList_Append(out, port);
            Py_DECREF(port);
            if (rc < 0) goto fail;
            placed = true;
            break;
          }
        }
        Py_DECREF(port);
      }
      if (!placed) {
        Py_DECREF(reserved_fast);
        Py_DECREF(out);
        Py_RETURN_NONE;
      }
    }
  }

  Py_DECREF(reserved_fast);
  return out;

fail:
  Py_DECREF(reserved_fast);
  Py_DECREF(out);
  return nullptr;
}

// add_all(used: set[int], ports: sequence[int]) -> bool collide
PyObject* add_all(PyObject*, PyObject* args) {
  PyObject* used;
  PyObject* ports;
  if (!PyArg_ParseTuple(args, "OO", &used, &ports)) return nullptr;
  if (!PySet_Check(used)) {
    PyErr_SetString(PyExc_TypeError, "used must be a set");
    return nullptr;
  }
  PyObject* fast = PySequence_Fast(ports, "ports must be a sequence");
  if (fast == nullptr) return nullptr;
  bool collide = false;
  for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(fast); i++) {
    PyObject* port = PySequence_Fast_GET_ITEM(fast, i);
    int hit = PySet_Contains(used, port);
    if (hit < 0) {
      Py_DECREF(fast);
      return nullptr;
    }
    if (hit) {
      collide = true;
    } else if (PySet_Add(used, port) < 0) {
      Py_DECREF(fast);
      return nullptr;
    }
  }
  Py_DECREF(fast);
  return PyBool_FromLong(collide);
}

// format_uuids(data: bytes) -> list[str]
//
// Formats len(data)/16 UUID strings ("8-4-4-4-12" lowercase hex) from raw
// entropy bytes.  The Python twin (structs/model.py generate_uuids) hex()s
// the same buffer and slices; this builds each 36-char ASCII string
// directly.  The scheduler mints one UUID per placement (1k/eval), so the
// slicing loop was visible in profiles.
PyObject* format_uuids(PyObject*, PyObject* args) {
  const char* data;
  Py_ssize_t len;
  if (!PyArg_ParseTuple(args, "y#", &data, &len)) return nullptr;
  if (len % 16 != 0) {
    PyErr_SetString(PyExc_ValueError, "data length must be a multiple of 16");
    return nullptr;
  }
  static const char hexdig[] = "0123456789abcdef";
  // Dash positions in the 36-char output (after hex nibbles 8,12,16,20).
  Py_ssize_t n = len / 16;
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* s = PyUnicode_New(36, 127);
    if (!s) {
      Py_DECREF(out);
      return nullptr;
    }
    Py_UCS1* w = PyUnicode_1BYTE_DATA(s);
    const unsigned char* b =
        reinterpret_cast<const unsigned char*>(data) + i * 16;
    Py_ssize_t o = 0;
    for (Py_ssize_t j = 0; j < 16; j++) {
      if (j == 4 || j == 6 || j == 8 || j == 10) w[o++] = '-';
      w[o++] = hexdig[b[j] >> 4];
      w[o++] = hexdig[b[j] & 0xF];
    }
    PyList_SET_ITEM(out, i, s);  // steals
  }
  gc_untrack(out);  // strings only: acyclic
  return out;
}

// ---------------------------------------------------------------------------
// bulk_finish: the scheduler finish loop's happy path in C.
//
// nomad_tpu_torch/scheduler/torch_binpack.py finish_deferred constructs one
// Allocation (+ AllocMetric, Resources, NetworkResource, port picks) per
// placement; at 1k placements/eval the CPython interpreter overhead of
// that loop dominates the whole evaluation.  This function executes the
// same per-placement steps through the C API.  It processes a PREFIX of
// the placement list and stops (returning how far it got) at the first
// case that needs Python-side handling — complex network topology,
// bandwidth overflow (divergence fallback), CIDR-derived IPs — so the
// Python general loop resumes exactly where C left off.  Semantics are
// kept bit-identical (same LCG port stream, same dict layouts); parity
// is asserted by tests/test_torch_native_finish.py against a pure-Python run
// with the same seed and uuids.
// ---------------------------------------------------------------------------

struct Interned {
  PyObject* name = nullptr;
  PyObject* task_group = nullptr;
  PyObject* resources = nullptr;
  PyObject* networks = nullptr;
  PyObject* device = nullptr;
  PyObject* ip = nullptr;
  PyObject* mbits = nullptr;
  PyObject* reserved = nullptr;
  PyObject* reserved_ports = nullptr;
  PyObject* dynamic_ports = nullptr;
  PyObject* id = nullptr;
  PyObject* task_resources = nullptr;
  PyObject* metrics = nullptr;
  PyObject* task_states = nullptr;
  PyObject* node_id = nullptr;
  PyObject* desired_status = nullptr;
  PyObject* desired_description = nullptr;
  PyObject* client_status = nullptr;
  PyObject* scores = nullptr;
  PyObject* coalesced = nullptr;
  PyObject* lazy_score_key = nullptr;
  PyObject* lazy_score_val = nullptr;
  PyObject* dunder_new = nullptr;
  PyObject* dunder_dict = nullptr;
  PyObject* proposed_allocs = nullptr;
  PyObject* binpack_suffix = nullptr;
  PyObject* srow = nullptr;
  bool ok = false;
};

Interned& interned() {
  static Interned s;
  if (!s.ok) {
    s.name = PyUnicode_InternFromString("name");
    s.task_group = PyUnicode_InternFromString("task_group");
    s.resources = PyUnicode_InternFromString("resources");
    s.networks = PyUnicode_InternFromString("networks");
    s.device = PyUnicode_InternFromString("device");
    s.ip = PyUnicode_InternFromString("ip");
    s.mbits = PyUnicode_InternFromString("mbits");
    s.reserved = PyUnicode_InternFromString("reserved");
    s.reserved_ports = PyUnicode_InternFromString("reserved_ports");
    s.dynamic_ports = PyUnicode_InternFromString("dynamic_ports");
    s.id = PyUnicode_InternFromString("id");
    s.task_resources = PyUnicode_InternFromString("task_resources");
    s.metrics = PyUnicode_InternFromString("metrics");
    s.task_states = PyUnicode_InternFromString("task_states");
    s.node_id = PyUnicode_InternFromString("node_id");
    s.desired_status = PyUnicode_InternFromString("desired_status");
    s.desired_description =
        PyUnicode_InternFromString("desired_description");
    s.client_status = PyUnicode_InternFromString("client_status");
    s.scores = PyUnicode_InternFromString("scores");
    s.coalesced = PyUnicode_InternFromString("coalesced_failures");
    s.lazy_score_key = PyUnicode_InternFromString("_lazy_score_key");
    s.lazy_score_val = PyUnicode_InternFromString("_lazy_score_val");
    s.dunder_new = PyUnicode_InternFromString("__new__");
    s.dunder_dict = PyUnicode_InternFromString("__dict__");
    s.proposed_allocs = PyUnicode_InternFromString("proposed_allocs");
    s.binpack_suffix = PyUnicode_InternFromString(".binpack");
    s.srow = PyUnicode_InternFromString("_srow");
    s.ok = true;
  }
  return s;
}

// cls.__new__(cls) + inst.__dict__ = d (steals nothing; returns new ref).
PyObject* make_instance(PyObject* cls, PyObject* d) {
  // Plain-Python heap classes (no custom __new__/__slots__ — true for
  // the dataclasses this serves): allocate directly and install the
  // attribute dict, skipping the __new__ descriptor machinery.
  PyTypeObject* tp = (PyTypeObject*)cls;
  PyObject* inst = tp->tp_alloc(tp, 0);
  if (!inst) return nullptr;
  PyObject** dictptr = _PyObject_GetDictPtr(inst);
  if (dictptr) {
    PyObject* old = *dictptr;
    Py_INCREF(d);
    *dictptr = d;
    Py_XDECREF(old);
    return inst;
  }
  if (PyObject_SetAttr(inst, interned().dunder_dict, d) < 0) {
    Py_DECREF(inst);
    return nullptr;
  }
  return inst;
}

// Accumulate one node's proposed-alloc network usage into (used, bw).
int walk_proposed(PyObject* ctx, PyObject* node_id, PyObject* used,
                  long* bw) {
  Interned& I = interned();
  PyObject* allocs =
      PyObject_CallMethodObjArgs(ctx, I.proposed_allocs, node_id, nullptr);
  if (!allocs) return -1;
  PyObject* it = PyObject_GetIter(allocs);
  Py_DECREF(allocs);
  if (!it) return -1;
  PyObject* alloc;
  while ((alloc = PyIter_Next(it))) {
    PyObject* trs = PyObject_GetAttr(alloc, I.task_resources);
    Py_DECREF(alloc);
    if (!trs) goto fail;
    {
      PyObject* values = PyDict_Values(trs);
      Py_DECREF(trs);
      if (!values) goto fail;
      for (Py_ssize_t i = 0; i < PyList_GET_SIZE(values); i++) {
        PyObject* nets =
            PyObject_GetAttr(PyList_GET_ITEM(values, i), I.networks);
        if (!nets) {
          Py_DECREF(values);
          goto fail;
        }
        PyObject* nets_fast = PySequence_Fast(nets, "networks");
        Py_DECREF(nets);
        if (!nets_fast) {
          Py_DECREF(values);
          goto fail;
        }
        for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(nets_fast);
             j++) {
          PyObject* offer = PySequence_Fast_GET_ITEM(nets_fast, j);
          PyObject* rports = PyObject_GetAttr(offer, I.reserved_ports);
          if (!rports) {
            Py_DECREF(nets_fast);
            Py_DECREF(values);
            goto fail;
          }
          PyObject* rp_fast = PySequence_Fast(rports, "reserved_ports");
          Py_DECREF(rports);
          if (!rp_fast) {
            Py_DECREF(nets_fast);
            Py_DECREF(values);
            goto fail;
          }
          for (Py_ssize_t k = 0; k < PySequence_Fast_GET_SIZE(rp_fast);
               k++) {
            if (PySet_Add(used, PySequence_Fast_GET_ITEM(rp_fast, k)) <
                0) {
              Py_DECREF(rp_fast);
              Py_DECREF(nets_fast);
              Py_DECREF(values);
              goto fail;
            }
          }
          Py_DECREF(rp_fast);
          PyObject* mb = PyObject_GetAttr(offer, I.mbits);
          if (!mb) {
            Py_DECREF(nets_fast);
            Py_DECREF(values);
            goto fail;
          }
          *bw += PyLong_AsLong(mb);
          Py_DECREF(mb);
          if (PyErr_Occurred()) {
            Py_DECREF(nets_fast);
            Py_DECREF(values);
            goto fail;
          }
        }
        Py_DECREF(nets_fast);
      }
      Py_DECREF(values);
    }
  }
  Py_DECREF(it);
  return PyErr_Occurred() ? -1 : 0;
fail:
  Py_DECREF(it);
  return -1;
}

// Node-static network base lookup: cached tuple from net_base, else one
// callback into Python's _net_base_for (which computes, handles CIDR
// IPs, and caches).  Returns 1 ok (*out = borrowed tuple), 0 bail
// (complex topology), -1 error.
int node_base(PyObject* net_base, PyObject* base_fn, PyObject* ch_key,
              PyObject* node, PyObject** out) {
  PyObject* base = PyDict_GetItemWithError(net_base, ch_key);
  if (base) {
    if (base == Py_None) return 0;
    *out = base;  // borrowed from net_base, same as the miss path below
    return 1;
  }
  if (PyErr_Occurred()) return -1;
  base = PyObject_CallFunctionObjArgs(base_fn, ch_key, node, nullptr);
  if (!base) return -1;
  bool is_none = base == Py_None;
  Py_DECREF(base);
  if (is_none) return 0;
  // _net_base_for cached the tuple into net_base; borrow it from there
  // so the caller needs no ownership bookkeeping.
  base = PyDict_GetItem(net_base, ch_key);
  if (!base || base == Py_None) return 0;  // defensive: cacheless callback
  *out = base;
  return 1;
}

// bulk_finish(place, group_idx, chosen, scores, uuids, slots, nodes,
//             node_net, net_base, base_fn, allocs_idx, ctx, plan_nu, plan_na,
//             failed_list, alloc_proto, metric_proto,
//             alloc_cls, metric_cls, res_cls, net_cls,
//             statuses, coalesce_all, port_lcg, min_port, max_port)
//   -> (n_done, port_lcg, failed_map)
//
// slots[g] = (size_obj, tasks) with tasks = list of
//   (task_name, res_proto_dict, None | (mbits, net_proto, dyn_labels)).
// statuses = (run, pending, failed, client_failed, failed_desc).
// coalesce_all: 1 = a task group's first failure swallows ALL its later
// placements (generic-scheduler semantics: placements of one TG are
// interchangeable, reference scheduler/generic_sched.go failedTGAllocs);
// 0 = coalesce only placements with no chosen node (system semantics:
// placements are node-pinned, one node failing says nothing about the
// others).
PyObject* bulk_finish(PyObject*, PyObject* args) {
  PyObject *place, *group_idx, *chosen, *scores, *uuids, *slots, *nodes;
  PyObject *node_net, *net_base, *base_fn, *allocs_idx, *ctx, *plan_nu,
      *plan_na;
  PyObject *failed_list, *alloc_proto, *metric_proto;
  PyObject *alloc_cls, *metric_cls, *res_cls, *net_cls, *statuses;
  int coalesce_all;
  long long lcg;  // 64-bit: lcg*1103515245 overflows a 32-bit long
  long min_port, max_port;
  if (!PyArg_ParseTuple(
          args, "OOOOOOOOOOOOOOOOOOOOOOiLll", &place, &group_idx, &chosen,
          &scores, &uuids, &slots, &nodes, &node_net, &net_base, &base_fn,
          &allocs_idx, &ctx, &plan_nu, &plan_na, &failed_list, &alloc_proto,
          &metric_proto, &alloc_cls, &metric_cls,
          &res_cls, &net_cls, &statuses, &coalesce_all, &lcg, &min_port,
          &max_port)) {
    return nullptr;
  }
  Interned& I = interned();
  const long span = max_port - min_port;
  PyObject* st_run = PyTuple_GET_ITEM(statuses, 0);
  PyObject* st_pending = PyTuple_GET_ITEM(statuses, 1);
  PyObject* st_failed = PyTuple_GET_ITEM(statuses, 2);
  PyObject* st_cfailed = PyTuple_GET_ITEM(statuses, 3);
  PyObject* failed_desc = PyTuple_GET_ITEM(statuses, 4);

  PyObject* failed_map = PyDict_New();
  if (!failed_map) return nullptr;

  Py_ssize_t P = PyList_GET_SIZE(place);
  Py_ssize_t p = 0;
  for (; p < P; p++) {
    PyObject* missing = PyList_GET_ITEM(place, p);
    PyObject* tg = PyObject_GetAttr(missing, I.task_group);
    if (!tg) goto fail;
    PyObject* tg_key = PyLong_FromVoidPtr((void*)tg);
    if (!tg_key) {
      Py_DECREF(tg);
      goto fail;
    }

    long g = PyLong_AsLong(PyList_GET_ITEM(group_idx, p));
    long ch = PyLong_AsLong(PyList_GET_ITEM(chosen, p));

    // Coalesce onto a prior failure of the same task group (all
    // placements under generic semantics; only chosen-less ones under
    // node-pinned system semantics — see coalesce_all above).
    PyObject* prior = PyDict_GetItemWithError(failed_map, tg_key);
    if (!prior && PyErr_Occurred()) {
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto fail;
    }
    if (prior && !coalesce_all && ch >= 0) prior = nullptr;
    if (prior) {
      PyObject* m = PyObject_GetAttr(prior, I.metrics);
      PyObject* c = m ? PyObject_GetAttr(m, I.coalesced) : nullptr;
      if (!c) {
        Py_XDECREF(m);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      long v = PyLong_AsLong(c) + 1;
      Py_DECREF(c);
      PyObject* nv = PyLong_FromLong(v);
      int rc = nv ? PyObject_SetAttr(m, I.coalesced, nv) : -1;
      Py_XDECREF(nv);
      Py_DECREF(m);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      if (rc < 0) goto fail;
      continue;
    }

    if (ch < 0 && coalesce_all) {
      // First failure of a task group under generic semantics: bail so
      // the Python loop owns it — its sequential fallback can still
      // PLACE the copy when the device's rounds estimate stranded it
      // (fleet-fullness underestimates), and failures that survive get
      // the full filter/exhaustion explanation.  The system path
      // (coalesce_all=0, node-pinned) keeps its O(1) inline failures.
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto done;
    }

    PyObject* slot = PyList_GET_ITEM(slots, g);
    PyObject* size_obj = PyTuple_GET_ITEM(slot, 0);
    PyObject* tasks = PyTuple_GET_ITEM(slot, 1);

    PyObject* node = nullptr;
    PyObject* node_id = nullptr;
    PyObject* out_trs = nullptr;  // task name -> Resources
    double score = 0.0;

    if (ch >= 0) {
      node = PyList_GET_ITEM(nodes, ch);  // borrowed
      node_id = PyObject_GetAttr(node, I.id);
      if (!node_id) {
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      score = PyFloat_AsDouble(PyList_GET_ITEM(scores, p));

      // --- network state for the node -------------------------------
      PyObject* ch_key = PyLong_FromLong(ch);
      if (!ch_key) {
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      PyObject* st = PyDict_GetItemWithError(node_net, ch_key);
      if (!st && PyErr_Occurred()) {
        Py_DECREF(ch_key);
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      if (!st) {
        PyObject* base = nullptr;
        int rc = node_base(net_base, base_fn, ch_key, node, &base);
        if (rc < 0) {
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        if (rc == 0) {  // bail: Python path owns this placement
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto done;
        }
        PyObject* used = PySet_New(PyTuple_GET_ITEM(base, 0));
        if (!used) {
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        long bw = PyLong_AsLong(PyTuple_GET_ITEM(base, 1));
        // Probe for proposed allocs needing the exact walk: direct
        // lookup in the store's allocs-by-node index (node_id ->
        // alloc-id collection; snapshots copy-on-write so the borrowed
        // dict is stable for the eval).
        int busy;
        {
          PyObject* entry = PyDict_GetItemWithError(allocs_idx, node_id);
          if (!entry && PyErr_Occurred()) {
            Py_DECREF(used);
            Py_DECREF(ch_key);
            Py_DECREF(node_id);
            Py_DECREF(tg_key);
            Py_DECREF(tg);
            goto fail;
          }
          busy = entry ? PyObject_IsTrue(entry) : 0;
        }
        if (busy == 0) {
          int c1 = PyDict_Contains(plan_nu, node_id);
          int c2 = c1 == 0 ? PyDict_Contains(plan_na, node_id) : c1;
          if (c1 < 0 || c2 < 0) busy = -1;
          else busy = (c1 > 0 || c2 > 0) ? 1 : 0;
        }
        if (busy < 0) {
          Py_DECREF(used);
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        if (busy &&
            walk_proposed(ctx, node_id, used, &bw) < 0) {
          Py_DECREF(used);
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        PyObject* bw_obj = PyLong_FromLong(bw);
        st = bw_obj ? PyList_New(5) : nullptr;
        if (!st) {
          Py_XDECREF(bw_obj);
          Py_DECREF(used);
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        PyList_SET_ITEM(st, 0, used);  // steals
        PyList_SET_ITEM(st, 1, bw_obj);
        PyObject* avail = PyTuple_GET_ITEM(base, 2);
        Py_INCREF(avail);
        PyList_SET_ITEM(st, 2, avail);
        PyObject* ipo = PyTuple_GET_ITEM(base, 3);
        Py_INCREF(ipo);
        PyList_SET_ITEM(st, 3, ipo);
        PyObject* devo = PyTuple_GET_ITEM(base, 4);
        Py_INCREF(devo);
        PyList_SET_ITEM(st, 4, devo);
        gc_untrack(used);  // port ints only
        gc_untrack(st);    // [set, int, int, str, str]
        int rc2 = PyDict_SetItem(node_net, ch_key, st);
        Py_DECREF(st);  // dict holds it now
        if (rc2 < 0) {
          Py_DECREF(ch_key);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        st = PyDict_GetItem(node_net, ch_key);  // borrowed
      }
      Py_DECREF(ch_key);

      PyObject* used = PyList_GET_ITEM(st, 0);
      long bw_used = PyLong_AsLong(PyList_GET_ITEM(st, 1));
      long bw_avail = PyLong_AsLong(PyList_GET_ITEM(st, 2));
      PyObject* node_ip = PyList_GET_ITEM(st, 3);
      PyObject* node_dev = PyList_GET_ITEM(st, 4);

      // Total bandwidth ask up-front: no mid-slot rollback needed.
      long total_mbits = 0;
      Py_ssize_t n_tasks = PyList_GET_SIZE(tasks);
      for (Py_ssize_t t = 0; t < n_tasks; t++) {
        PyObject* net = PyTuple_GET_ITEM(PyList_GET_ITEM(tasks, t), 2);
        if (net != Py_None) {
          total_mbits += PyLong_AsLong(PyTuple_GET_ITEM(net, 0));
        }
      }
      if (bw_used + total_mbits > bw_avail) {
        // Divergence: Python fallback owns this placement onward.
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto done;
      }

      out_trs = PyDict_New();
      if (!out_trs) {
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      bool task_fail = false;
      for (Py_ssize_t t = 0; t < n_tasks && !task_fail; t++) {
        PyObject* task = PyList_GET_ITEM(tasks, t);
        PyObject* tname = PyTuple_GET_ITEM(task, 0);
        PyObject* res_proto = PyTuple_GET_ITEM(task, 1);
        PyObject* net = PyTuple_GET_ITEM(task, 2);
        PyObject* rd = PyDict_Copy(res_proto);
        if (!rd) {
          task_fail = true;
          break;
        }
        if (net == Py_None) {
          PyObject* empty = PyList_New(0);
          gc_untrack(empty);
          if (!empty || PyDict_SetItem(rd, I.networks, empty) < 0) {
            Py_XDECREF(empty);
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
          Py_DECREF(empty);
        } else {
          PyObject* net_proto = PyTuple_GET_ITEM(net, 1);
          PyObject* labels = PyTuple_GET_ITEM(net, 2);
          Py_ssize_t n_dyn = PySequence_Fast_GET_SIZE(labels);
          PyObject* ports = PyList_New(0);
          if (!ports) {
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
          bool port_fail = false;
          for (Py_ssize_t dp = 0; dp < n_dyn && !port_fail; dp++) {
            lcg = (lcg * 1103515245LL + 12345LL) & 0x3FFFFFFFLL;
            long port = min_port + (long)(lcg % span);
            long tries = 0;
            while (true) {
              PyObject* po = PyLong_FromLong(port);
              if (!po) {
                port_fail = true;
                break;
              }
              int hit = PySet_Contains(used, po);
              if (hit < 0) {
                Py_DECREF(po);
                port_fail = true;
                break;
              }
              if (!hit) {
                if (PySet_Add(used, po) < 0 ||
                    PyList_Append(ports, po) < 0) {
                  Py_DECREF(po);
                  port_fail = true;
                  break;
                }
                Py_DECREF(po);
                break;
              }
              Py_DECREF(po);
              port = min_port + (port - min_port + 1) % span;
              if (++tries > span) {
                // Whole dynamic range exhausted on this node: a genuine
                // error (the Python twin would spin); raise, don't bail.
                PyErr_SetString(PyExc_RuntimeError,
                                "dynamic port range exhausted");
                port_fail = true;
                break;
              }
            }
          }
          if (port_fail) {
            Py_DECREF(ports);
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
          gc_untrack(ports);  // ints only
          PyObject* nd = PyDict_Copy(net_proto);
          PyObject* labels_copy = nd ? PySequence_List(labels) : nullptr;
          if (!labels_copy ||
              PyDict_SetItem(nd, I.device, node_dev) < 0 ||
              PyDict_SetItem(nd, I.ip, node_ip) < 0 ||
              PyDict_SetItem(nd, I.reserved_ports, ports) < 0 ||
              PyDict_SetItem(nd, I.dynamic_ports, labels_copy) < 0) {
            Py_XDECREF(labels_copy);
            Py_XDECREF(nd);
            Py_DECREF(ports);
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
          gc_untrack(labels_copy);  // strings only
          Py_DECREF(labels_copy);
          Py_DECREF(ports);
          gc_untrack(nd);  // final: offer.__dict__
          PyObject* offer = make_instance(net_cls, nd);
          Py_DECREF(nd);
          if (!offer) {
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
          gc_untrack(offer);
          PyObject* offer_list = PyList_New(1);
          if (!offer_list) {
            Py_DECREF(offer);
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
          PyList_SET_ITEM(offer_list, 0, offer);  // steals
          gc_untrack(offer_list);
          int rc3 = PyDict_SetItem(rd, I.networks, offer_list);
          Py_DECREF(offer_list);
          if (rc3 < 0) {
            Py_DECREF(rd);
            task_fail = true;
            break;
          }
        }
        gc_untrack(rd);  // final: Resources.__dict__
        PyObject* res_inst = make_instance(res_cls, rd);
        Py_DECREF(rd);
        if (!res_inst || PyDict_SetItem(out_trs, tname, res_inst) < 0) {
          Py_XDECREF(res_inst);
          task_fail = true;
          break;
        }
        gc_untrack(res_inst);
        Py_DECREF(res_inst);
      }
      if (task_fail) {
        Py_DECREF(out_trs);
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      // Commit bandwidth.
      PyObject* new_bw = PyLong_FromLong(bw_used + total_mbits);
      if (!new_bw) {
        Py_DECREF(out_trs);
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      PyList_SetItem(st, 1, new_bw);  // steals
      gc_untrack(out_trs);  // final: alloc.task_resources
    }

    // --- metric + alloc construction --------------------------------
    // Lazy AllocMetric: only the proto copy + the one binpack score as
    // two scalars; factory dicts + the scores dict materialize on
    // first read (AllocMetric.__getattr__ in structs/model.py).
    PyObject* md = PyDict_Copy(metric_proto);
    if (!md) {
      Py_XDECREF(out_trs);
      Py_XDECREF(node_id);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto fail;
    }
    if (node_id) {
      PyObject* key = PyUnicode_Concat(node_id, I.binpack_suffix);
      PyObject* sv = key ? PyFloat_FromDouble(score) : nullptr;
      if (!sv || PyDict_SetItem(md, I.lazy_score_key, key) < 0 ||
          PyDict_SetItem(md, I.lazy_score_val, sv) < 0) {
        Py_XDECREF(sv);
        Py_XDECREF(key);
        Py_DECREF(md);
        Py_XDECREF(out_trs);
        Py_DECREF(node_id);
        Py_DECREF(tg_key);
        Py_DECREF(tg);
        goto fail;
      }
      Py_DECREF(sv);
      Py_DECREF(key);
    }
    gc_untrack(md);  // final: AllocMetric.__dict__
    PyObject* metric = make_instance(metric_cls, md);
    Py_DECREF(md);
    if (!metric) {
      Py_XDECREF(out_trs);
      Py_XDECREF(node_id);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto fail;
    }

    PyObject* ad = PyDict_Copy(alloc_proto);
    PyObject* tg_name = ad ? PyObject_GetAttr(tg, I.name) : nullptr;
    PyObject* m_name = tg_name ? PyObject_GetAttr(missing, I.name)
                               : nullptr;
    PyObject* ts = m_name ? PyDict_New() : nullptr;
    if (!ts ||
        PyDict_SetItem(ad, I.id, PyList_GET_ITEM(uuids, p)) < 0 ||
        PyDict_SetItem(ad, I.name, m_name) < 0 ||
        PyDict_SetItem(ad, I.task_group, tg_name) < 0 ||
        PyDict_SetItem(ad, I.resources, size_obj) < 0 ||
        PyDict_SetItem(ad, I.metrics, metric) < 0 ||
        PyDict_SetItem(ad, I.task_states, ts) < 0) {
      Py_XDECREF(ts);
      Py_XDECREF(m_name);
      Py_XDECREF(tg_name);
      Py_XDECREF(ad);
      Py_DECREF(metric);
      Py_XDECREF(out_trs);
      Py_XDECREF(node_id);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto fail;
    }
    Py_DECREF(ts);
    Py_DECREF(m_name);
    Py_DECREF(tg_name);
    Py_DECREF(metric);

    int rc4 = 0;
    if (node_id) {
      rc4 = PyDict_SetItem(ad, I.node_id, node_id) < 0 ||
            PyDict_SetItem(ad, I.task_resources, out_trs) < 0 ||
            PyDict_SetItem(ad, I.desired_status, st_run) < 0 ||
            PyDict_SetItem(ad, I.client_status, st_pending) < 0;
      Py_DECREF(out_trs);
      out_trs = nullptr;
    } else {
      PyObject* empty_trs = PyDict_New();
      rc4 = !empty_trs ||
            PyDict_SetItem(ad, I.task_resources, empty_trs) < 0 ||
            PyDict_SetItem(ad, I.desired_status, st_failed) < 0 ||
            PyDict_SetItem(ad, I.desired_description, failed_desc) < 0 ||
            PyDict_SetItem(ad, I.client_status, st_cfailed) < 0;
      Py_XDECREF(empty_trs);
    }
    if (rc4) {
      Py_DECREF(ad);
      Py_XDECREF(node_id);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto fail;
    }
    gc_untrack(metric);
    gc_untrack(ad);  // final: Allocation.__dict__
    PyObject* alloc = make_instance(alloc_cls, ad);
    Py_DECREF(ad);
    if (!alloc) {
      Py_XDECREF(node_id);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      goto fail;
    }

    gc_untrack(alloc);
    if (node_id) {
      PyObject* lst = PyDict_GetItemWithError(plan_na, node_id);
      if (!lst) {
        if (PyErr_Occurred()) {
          Py_DECREF(alloc);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        lst = PyList_New(0);
        gc_untrack(lst);  // holds only (untracked) allocs
        if (!lst || PyDict_SetItem(plan_na, node_id, lst) < 0) {
          Py_XDECREF(lst);
          Py_DECREF(alloc);
          Py_DECREF(node_id);
          Py_DECREF(tg_key);
          Py_DECREF(tg);
          goto fail;
        }
        Py_DECREF(lst);
        lst = PyDict_GetItem(plan_na, node_id);
      }
      int rc5 = PyList_Append(lst, alloc);
      Py_DECREF(alloc);
      Py_DECREF(node_id);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      if (rc5 < 0) goto fail;
    } else {
      int rc5 = PyList_Append(failed_list, alloc) < 0 ||
                PyDict_SetItem(failed_map, tg_key, alloc) < 0;
      Py_DECREF(alloc);
      Py_DECREF(tg_key);
      Py_DECREF(tg);
      if (rc5) goto fail;
    }
  }

done:
  return Py_BuildValue("(nLN)", p, lcg, failed_map);

fail:
  Py_DECREF(failed_map);
  return nullptr;
}

// ---------------------------------------------------------------------------
// bulk_finish_cols: the columnar finish loop (the AllocSlab contract).
//
// Same control flow as bulk_finish's generic (coalesce_all=1) happy
// path — identical per-node network state, identical LCG port stream,
// identical bail conditions — but instead of constructing the full
// Allocation object tree per placement it writes the assigned ports
// into the slab's int32 buffer, fills the slab's node_id/ip/device
// columns, and emits ONE small lazy SlabAlloc per row (a proto dict
// copy + five scalar inserts; the heavy fields materialize from the
// slab only at the client/API edge — nomad_tpu_torch/structs/alloc_slab.py).
// Bails (returning how far it got) at the first chosen-less placement,
// complex network topology, or bandwidth divergence, exactly where the
// object path handed control to the Python tail.
//
// bulk_finish_cols(chosen, group_l, uuids, names, tg_names,
//                  slot_mbits, slot_ndyn, ports_buf,
//                  nids_out, ips_out, devs_out, lazy_proto, alloc_cls,
//                  nodes, node_net, net_base, base_fn, allocs_idx, ctx,
//                  plan_nu, plan_na, port_lcg, min_port, max_port)
//   -> (n_done, port_lcg)
// ---------------------------------------------------------------------------
PyObject* bulk_finish_cols(PyObject*, PyObject* args) {
  PyObject *chosen, *group_l, *uuids, *names, *tg_names;
  PyObject *slot_mbits, *slot_ndyn;
  Py_buffer ports_buf;
  PyObject *nids_out, *ips_out, *devs_out, *lazy_proto, *alloc_cls;
  PyObject *nodes, *node_net, *net_base, *base_fn, *allocs_idx, *ctx,
      *plan_nu, *plan_na;
  long long lcg;
  long min_port, max_port;
  if (!PyArg_ParseTuple(
          args, "OOOOOOOw*OOOOOOOOOOOOOLll", &chosen, &group_l, &uuids,
          &names, &tg_names, &slot_mbits, &slot_ndyn, &ports_buf,
          &nids_out, &ips_out, &devs_out, &lazy_proto, &alloc_cls,
          &nodes, &node_net, &net_base, &base_fn, &allocs_idx, &ctx,
          &plan_nu, &plan_na, &lcg, &min_port, &max_port)) {
    return nullptr;
  }
  Interned& I = interned();
  const long span = max_port - min_port;
  Py_ssize_t P = PyList_GET_SIZE(chosen);
  Py_ssize_t n_nodes = PyList_GET_SIZE(nodes);
  int32_t* pbuf = static_cast<int32_t*>(ports_buf.buf);
  Py_ssize_t poff = 0;
  // Per-node caches for this call: st borrowed from node_net (the dict
  // keeps it alive), node_id owned here — avoids a PyLong key build +
  // dict probe per placement on the hot path.
  std::vector<PyObject*> st_of(n_nodes, nullptr);
  std::vector<PyObject*> nid_of(n_nodes, nullptr);  // owned
  bool failed = false;
  Py_ssize_t p = 0;
  for (; p < P && !failed; p++) {
    long ch = PyLong_AsLong(PyList_GET_ITEM(chosen, p));
    if (ch == -1 && PyErr_Occurred()) {
      failed = true;
      break;
    }
    if (ch < 0 || ch >= n_nodes) break;  // tail owns failures/oddities
    long g = PyLong_AsLong(PyList_GET_ITEM(group_l, p));
    long ndyn = PyLong_AsLong(PyList_GET_ITEM(slot_ndyn, g));
    long total_mbits = PyLong_AsLong(PyList_GET_ITEM(slot_mbits, g));
    if (PyErr_Occurred()) {
      failed = true;
      break;
    }

    PyObject* st = st_of[ch];
    PyObject* node_id = nid_of[ch];
    if (st == nullptr) {
      // First placement on this node: build the fast per-node network
      // state exactly like the object path (shared with the Python
      // tail through node_net).
      PyObject* node = PyList_GET_ITEM(nodes, ch);
      node_id = PyObject_GetAttr(node, I.id);
      if (!node_id) {
        failed = true;
        break;
      }
      nid_of[ch] = node_id;  // owned for the rest of the call
      PyObject* ch_key = PyLong_FromLong(ch);
      if (!ch_key) {
        failed = true;
        break;
      }
      PyObject* base = nullptr;
      int rc = node_base(net_base, base_fn, ch_key, node, &base);
      if (rc < 0) {
        Py_DECREF(ch_key);
        failed = true;
        break;
      }
      if (rc == 0) {  // complex topology: Python tail owns it
        Py_DECREF(ch_key);
        break;
      }
      PyObject* used = PySet_New(PyTuple_GET_ITEM(base, 0));
      if (!used) {
        Py_DECREF(ch_key);
        failed = true;
        break;
      }
      long bw = PyLong_AsLong(PyTuple_GET_ITEM(base, 1));
      int busy;
      {
        PyObject* entry = PyDict_GetItemWithError(allocs_idx, node_id);
        if (!entry && PyErr_Occurred()) {
          Py_DECREF(used);
          Py_DECREF(ch_key);
          failed = true;
          break;
        }
        busy = entry ? PyObject_IsTrue(entry) : 0;
      }
      if (busy == 0) {
        int c1 = PyDict_Contains(plan_nu, node_id);
        int c2 = c1 == 0 ? PyDict_Contains(plan_na, node_id) : c1;
        if (c1 < 0 || c2 < 0) busy = -1;
        else busy = (c1 > 0 || c2 > 0) ? 1 : 0;
      }
      if (busy < 0 ||
          (busy && walk_proposed(ctx, node_id, used, &bw) < 0)) {
        Py_DECREF(used);
        Py_DECREF(ch_key);
        failed = true;
        break;
      }
      PyObject* bw_obj = PyLong_FromLong(bw);
      st = bw_obj ? PyList_New(5) : nullptr;
      if (!st) {
        Py_XDECREF(bw_obj);
        Py_DECREF(used);
        Py_DECREF(ch_key);
        failed = true;
        break;
      }
      PyList_SET_ITEM(st, 0, used);    // steals
      PyList_SET_ITEM(st, 1, bw_obj);  // steals
      PyObject* avail = PyTuple_GET_ITEM(base, 2);
      Py_INCREF(avail);
      PyList_SET_ITEM(st, 2, avail);
      PyObject* ipo = PyTuple_GET_ITEM(base, 3);
      Py_INCREF(ipo);
      PyList_SET_ITEM(st, 3, ipo);
      PyObject* devo = PyTuple_GET_ITEM(base, 4);
      Py_INCREF(devo);
      PyList_SET_ITEM(st, 4, devo);
      gc_untrack(used);
      gc_untrack(st);
      int rc2 = PyDict_SetItem(node_net, ch_key, st);
      Py_DECREF(st);  // node_net holds it now
      Py_DECREF(ch_key);
      if (rc2 < 0) {
        failed = true;
        break;
      }
      st_of[ch] = st;  // borrowed from node_net for this call
    }

    long bw_used = PyLong_AsLong(PyList_GET_ITEM(st, 1));
    long bw_avail = PyLong_AsLong(PyList_GET_ITEM(st, 2));
    if (PyErr_Occurred()) {
      failed = true;
      break;
    }
    if (bw_used + total_mbits > bw_avail) break;  // divergence: tail

    PyObject* used = PyList_GET_ITEM(st, 0);
    bool port_fail = false;
    for (long d = 0; d < ndyn && !port_fail; d++) {
      lcg = (lcg * 1103515245LL + 12345LL) & 0x3FFFFFFFLL;
      long port = min_port + (long)(lcg % span);
      long tries = 0;
      while (true) {
        PyObject* po = PyLong_FromLong(port);
        if (!po) {
          port_fail = true;
          break;
        }
        int hit = PySet_Contains(used, po);
        if (hit < 0) {
          Py_DECREF(po);
          port_fail = true;
          break;
        }
        if (!hit) {
          int rc3 = PySet_Add(used, po);
          Py_DECREF(po);
          if (rc3 < 0) {
            port_fail = true;
            break;
          }
          pbuf[poff + d] = (int32_t)port;
          break;
        }
        Py_DECREF(po);
        port = min_port + (port - min_port + 1) % span;
        if (++tries > span) {
          PyErr_SetString(PyExc_RuntimeError,
                          "dynamic port range exhausted");
          port_fail = true;
          break;
        }
      }
    }
    if (port_fail) {
      failed = true;
      break;
    }
    poff += ndyn;
    if (total_mbits) {
      PyObject* nb = PyLong_FromLong(bw_used + total_mbits);
      if (!nb || PyList_SetItem(st, 1, nb) < 0) {  // steals nb
        failed = true;
        break;
      }
    }

    // Slab columns: node id / ip / device for this row.
    Py_INCREF(node_id);
    PyObject* ipo = PyList_GET_ITEM(st, 3);
    Py_INCREF(ipo);
    PyObject* devo = PyList_GET_ITEM(st, 4);
    Py_INCREF(devo);
    if (PyList_SetItem(nids_out, p, node_id) < 0 ||  // steal; replaces None
        PyList_SetItem(ips_out, p, ipo) < 0 ||
        PyList_SetItem(devs_out, p, devo) < 0) {
      failed = true;
      break;
    }

    // The lazy alloc: proto copy + five scalar inserts.
    PyObject* ad = PyDict_Copy(lazy_proto);
    PyObject* srow = ad ? PyLong_FromSsize_t(p) : nullptr;
    if (!srow ||
        PyDict_SetItem(ad, I.id, PyList_GET_ITEM(uuids, p)) < 0 ||
        PyDict_SetItem(ad, I.name, PyList_GET_ITEM(names, p)) < 0 ||
        PyDict_SetItem(ad, I.task_group,
                       PyList_GET_ITEM(tg_names, p)) < 0 ||
        PyDict_SetItem(ad, I.node_id, node_id) < 0 ||
        PyDict_SetItem(ad, I.srow, srow) < 0) {
      Py_XDECREF(srow);
      Py_XDECREF(ad);
      failed = true;
      break;
    }
    Py_DECREF(srow);
    gc_untrack(ad);  // final: SlabAlloc.__dict__ (acyclic: the slab
    //                  never points back at scheduler-path allocs)
    PyObject* alloc = make_instance(alloc_cls, ad);
    Py_DECREF(ad);
    if (!alloc) {
      failed = true;
      break;
    }
    gc_untrack(alloc);

    PyObject* lst = PyDict_GetItemWithError(plan_na, node_id);
    if (!lst) {
      if (PyErr_Occurred()) {
        Py_DECREF(alloc);
        failed = true;
        break;
      }
      lst = PyList_New(0);
      gc_untrack(lst);  // holds only (untracked) allocs
      if (!lst || PyDict_SetItem(plan_na, node_id, lst) < 0) {
        Py_XDECREF(lst);
        Py_DECREF(alloc);
        failed = true;
        break;
      }
      Py_DECREF(lst);
      lst = PyDict_GetItem(plan_na, node_id);
    }
    int rc4 = PyList_Append(lst, alloc);
    Py_DECREF(alloc);
    if (rc4 < 0) {
      failed = true;
      break;
    }
  }

  for (PyObject* o : nid_of) Py_XDECREF(o);
  PyBuffer_Release(&ports_buf);
  if (failed) {
    if (!PyErr_Occurred()) {
      PyErr_SetString(PyExc_RuntimeError, "bulk_finish_cols failed");
    }
    return nullptr;
  }
  return Py_BuildValue("(nL)", p, lcg);
}

// bulk_finish_many(items) -> [(n_done, port_lcg), ...]
//
// items: list of bulk_finish_cols argument TUPLES (built by
// scheduler/torch_binpack._finish_native_args), one per evaluation of a
// fused storm's window.  Runs every eval's columnar finish loop in ONE
// Python->C transition so the batch runner (scheduler/batch.py
// _finish_lanes) amortizes the native-call setup across the window
// instead of re-entering the interpreter between evals.
// Exactly equivalent to calling bulk_finish_cols per item.
PyObject* bulk_finish_many(PyObject* self, PyObject* args) {
  PyObject* items;
  if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &items)) return nullptr;
  Py_ssize_t n = PyList_GET_SIZE(items);
  PyObject* out = PyList_New(n);
  if (!out) return nullptr;
  for (Py_ssize_t i = 0; i < n; i++) {
    PyObject* item = PyList_GET_ITEM(items, i);
    if (!PyTuple_Check(item)) {
      Py_DECREF(out);
      PyErr_SetString(PyExc_TypeError,
                      "bulk_finish_many items must be argument tuples");
      return nullptr;
    }
    PyObject* r = bulk_finish_cols(self, item);
    if (!r) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, r);  // steals
  }
  return out;
}

PyMethodDef methods[] = {
    {"assign_ports", assign_ports, METH_VARARGS,
     "Assign reserved + dynamic ports against a used-port set."},
    {"add_all", add_all, METH_VARARGS,
     "Add ports to a used-port set; returns True on any collision."},
    {"bulk_finish", bulk_finish, METH_VARARGS,
     "Scheduler finish-loop happy path: bulk alloc construction."},
    {"bulk_finish_cols", bulk_finish_cols, METH_VARARGS,
     "Columnar finish loop: ports into the AllocSlab buffer, lazy "
     "SlabAllocs into the plan."},
    {"bulk_finish_many", bulk_finish_many, METH_VARARGS,
     "bulk_finish_cols over a window of evals in one native call."},
    {"format_uuids", format_uuids, METH_VARARGS,
     "Format UUID strings from raw entropy bytes (16 per UUID)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_nomad_torch_native",
    "C++ hot-path helpers for the port's host scheduling plane.", -1,
    methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__nomad_torch_native(void) {
  PyObject* m = PyModule_Create(&module);
  if (m == nullptr) return nullptr;
  // Bumped on any signature/behavior change of an existing function so a
  // stale build (same names, old ABI) is refused by the loader
  // (nomad_tpu_torch/utils/native.py) instead of crashing mid-eval.
  if (PyModule_AddIntConstant(m, "ABI_VERSION", 6) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
