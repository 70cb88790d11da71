"""The port's boot-log gating + recent-log ring (reference
helper/gated-writer + command/agent/log_writer.go): twins of
tests/test_gated_log.py on ``nomad_tpu_torch.utils.gated_log``, and the
two packages' default gates side by side in one process."""
from __future__ import annotations

import io
import logging

from nomad_tpu.utils import gated_log as jgated
from nomad_tpu_torch.utils.gated_log import BootLogGate, GatedHandler, LogWriter


def test_pre_config_lines_appear_exactly_once_post_setup():
    stream = io.StringIO()
    gate = BootLogGate(logger_name="nomad_tpu_torch.test.boot", stream=stream)
    try:
        log = logging.getLogger("nomad_tpu_torch.test.boot")
        log.info("boot line one")
        log.warning("boot line two")
        assert stream.getvalue() == ""  # nothing until the gate opens

        gate.open("INFO")
        out = stream.getvalue()
        assert out.count("boot line one") == 1
        assert out.count("boot line two") == 1

        log.info("live line")
        out = stream.getvalue()
        # Replay happened once; live lines pass straight through.
        assert out.count("boot line one") == 1
        assert out.count("live line") == 1
    finally:
        gate.remove()


def test_configured_level_filters_buffered_and_live():
    stream = io.StringIO()
    gate = BootLogGate(logger_name="nomad_tpu_torch.test.lvl", stream=stream)
    try:
        log = logging.getLogger("nomad_tpu_torch.test.lvl")
        log.debug("buffered debug")
        log.info("buffered info")
        gate.open("WARN")
        log.info("live info")
        log.warning("live warn")
        out = stream.getvalue()
        assert "buffered debug" not in out
        assert "buffered info" not in out
        assert "live info" not in out
        assert "live warn" in out
    finally:
        gate.remove()


def test_sighup_level_change_refilters(caplog):
    stream = io.StringIO()
    gate = BootLogGate(logger_name="nomad_tpu_torch.test.re", stream=stream)
    try:
        log = logging.getLogger("nomad_tpu_torch.test.re")
        gate.open("INFO")
        log.debug("hidden debug")
        assert "hidden debug" not in stream.getvalue()
        gate.set_level("DEBUG")
        log.debug("visible debug")
        assert "visible debug" in stream.getvalue()
    finally:
        gate.remove()


def test_log_writer_ring_and_monitor():
    writer = LogWriter(maxlen=3)
    log = logging.getLogger("nomad_tpu_torch.test.ring")
    log.setLevel(logging.INFO)
    log.propagate = False
    log.addHandler(writer)
    try:
        for i in range(5):
            log.info("line %d", i)
        ring = writer.lines()
        assert len(ring) == 3
        assert ring[-1].endswith("line 4")
        assert writer.lines(1)[0].endswith("line 4")

        seen: list = []
        unsub = writer.monitor(seen.append)
        assert len(seen) == 3  # backlog replayed into the monitor
        log.info("tail line")
        assert seen[-1].endswith("tail line")
        unsub()
        log.info("after unsub")
        assert not seen[-1].endswith("after unsub")
    finally:
        log.removeHandler(writer)
        log.propagate = True


def test_gated_handler_threadsafe_open():
    gate = GatedHandler()
    sink = LogWriter()
    rec = logging.LogRecord("n", logging.INFO, __file__, 1, "msg-%d", (7,),
                            None)
    gate.emit(rec)
    gate.open_gate([sink])
    assert any("msg-7" in ln for ln in sink.lines())
    rec2 = logging.LogRecord("n", logging.INFO, __file__, 1, "msg-%d",
                             (8,), None)
    gate.emit(rec2)
    assert any("msg-8" in ln for ln in sink.lines())


def test_log_writer_lines_since_offsets_survive_wrap():
    """Follow-mode contract: monotonic offsets work across ring
    eviction — no re-prints, evicted-unread lines simply gone."""
    import logging as _logging

    writer = LogWriter(maxlen=4)
    log = _logging.getLogger("nomad_tpu_torch.test.since")
    log.setLevel(_logging.INFO)
    log.propagate = False
    log.addHandler(writer)
    try:
        for i in range(3):
            log.info("w%d", i)
        lines, off = writer.lines_since(0)
        assert len(lines) == 3 and off == 3
        # Nothing new: empty, offset unchanged.
        lines, off2 = writer.lines_since(off)
        assert lines == [] and off2 == 3
        # Wrap the ring: 6 more lines into a 4-slot ring.
        for i in range(3, 9):
            log.info("w%d", i)
        lines, off3 = writer.lines_since(off)
        assert off3 == 9
        # 6 appended since offset 3, but only 4 survive the ring.
        assert [ln[-2:] for ln in lines] == ["w5", "w6", "w7", "w8"]
        # Duplicate message text cannot confuse offsets.
        log.info("w8")
        lines, off4 = writer.lines_since(off3)
        assert len(lines) == 1 and off4 == 10
    finally:
        log.removeHandler(writer)


def test_lines_since_resets_after_counter_restart():
    """An offset from a previous agent process (since > total) returns
    the full ring — the restart backlog is exactly what a watching
    monitor wants, not silence."""
    import logging as _logging

    writer = LogWriter(maxlen=8)
    log = _logging.getLogger("nomad_tpu_torch.test.restart")
    log.setLevel(_logging.INFO)
    log.propagate = False
    log.addHandler(writer)
    try:
        for i in range(3):
            log.info("boot %d", i)
        lines, off = writer.lines_since(5000)  # stale pre-restart offset
        assert len(lines) == 3 and off == 3
    finally:
        log.removeHandler(writer)


def test_default_gates_capture_only_their_own_package():
    """A JAX agent and a port agent in one process: each package's
    default gate holds its own logger's records and none of the
    other's, and both format a record alike."""
    jstream, tstream = io.StringIO(), io.StringIO()
    jgate = jgated.BootLogGate(stream=jstream)
    tgate = BootLogGate(stream=tstream)
    try:
        assert tgate.logger.name == "nomad_tpu_torch"
        logging.getLogger("nomad_tpu.test.side").warning("jax side")
        logging.getLogger("nomad_tpu_torch.test.side").warning("port side")
        jgate.open("INFO")
        tgate.open("INFO")
        jout, tout = jstream.getvalue(), tstream.getvalue()
        assert "jax side" in jout and "port side" not in jout
        assert "port side" in tout and "jax side" not in tout
        strip = [ln.split(" [", 1)[1] for ln in (jout.strip(),
                                                 tout.strip())]
        assert strip == ["WARNING] nomad_tpu.test.side: jax side",
                         "WARNING] nomad_tpu_torch.test.side: port side"]
    finally:
        tgate.remove()
        jgate.remove()
