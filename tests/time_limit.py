"""A time limit for every test, from the standard library.

Under ``pytest -n``, a test that hangs holds its worker until the command's
own time limit cuts the whole run, and nothing after it is counted.
``TimeLimit`` arms ``faulthandler.dump_traceback_later(LIMIT_S, exit=True)``
around each test (setup, call and teardown) and cancels it after. A test
that outlasts the limit prints every thread's stack into the log and ends
its worker; xdist reports it failed ("worker 'gwN' crashed while running
...") and starts a new worker for the rest of the run.

Two things in pytest-xdist 3.8's ``--dist loadfile`` scheduler
(``LoadScopeScheduling.remove_node``) would still cost the run, and this
module mends both:

- It hands the ended worker's files out again, finished ones included. A
  worker given a finished file runs nothing, is never given more, and the
  run waits for it until the command's limit. The controller therefore
  forgets an ended worker's finished files before xdist hands them out.
- It runs the test that reached the limit again, and one that hangs every
  time would end worker after worker. So each worker leaves a mark while a
  test runs, in a directory that the controller makes for the run, and a
  test whose mark an ended worker left fails at setup instead, whether the
  limit or a crash ended that worker.

A process has one faulthandler timer, and pytest's ``faulthandler_timeout``
uses it too, so the two cannot be combined.

Both mends rely on pytest-xdist 3.8's scheduler state and hook order; an
assertion names that if they change. ``tests/test_harness.py`` runs a hang
through xdist and fails if either mend stops working.

Install from a ``conftest.py``::

    def pytest_configure(config):
        time_limit.install(config)
"""

import faulthandler
import hashlib
import os
import shutil
import tempfile

import pytest

# A backstop for a hang, which no test that is only slow may reach: the
# slowest test (a multichip dry run) takes up to 108 s on an 8-core host and
# 157 s beside six busy-loop processes there; the limit is twice that.
LIMIT_S = 320

_DIR_KEY = "time_limit_dir"


class TimeLimit:

    def __init__(self, config, seconds):
        self.config = config
        self.seconds = seconds
        # fd 2 is redirected into pytest's capture while a test runs; this
        # copy, made at configure time, is the log.
        self.stderr = os.dup(2)
        workerinput = getattr(config, "workerinput", None)
        if workerinput is None:  # the controller, or a run without xdist
            self.marks = None
            self.own_dir = tempfile.mkdtemp(prefix="pytest-time-limit-")
        else:
            self.marks = workerinput[_DIR_KEY]
            self.own_dir = None

    def pytest_unconfigure(self, config):
        os.close(self.stderr)
        if self.own_dir:
            shutil.rmtree(self.own_dir, ignore_errors=True)

    # -- the controller

    @pytest.hookimpl(optionalhook=True)
    def pytest_configure_node(self, node):
        node.workerinput[_DIR_KEY] = self.own_dir

    @pytest.hookimpl(optionalhook=True)
    def pytest_testnodedown(self, node, error):
        from xdist.scheduler import LoadScopeScheduling

        sched = self.config.pluginmanager.getplugin("dsession").sched
        if error is None or not isinstance(sched, LoadScopeScheduling):
            return
        # pytest-xdist 3.8 calls this hook before the scheduler's
        # remove_node, and keeps {node: {file: {nodeid: finished}}} there.
        assigned = getattr(sched, "assigned_work", None)
        assert isinstance(assigned, dict), (
            "time_limit was written against pytest-xdist 3.8's "
            "LoadScopeScheduling.assigned_work; this xdist has none")
        workload = assigned.get(node, {})
        for scope in [s for s, unit in workload.items()
                      if all(unit.values())]:
            del workload[scope]

    # -- each test

    def _mark(self, item):
        name = hashlib.sha1(item.nodeid.encode()).hexdigest()
        return os.path.join(self.marks, name)

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_protocol(self, item, nextitem):
        mark = self._mark(item) if self.marks else None
        if mark and os.path.exists(mark):
            item.time_limit_worker_ended = True
            yield
            return
        if mark:
            open(mark, "w").close()
        faulthandler.dump_traceback_later(self.seconds, exit=True,
                                          file=self.stderr)
        try:
            yield
        finally:
            faulthandler.cancel_dump_traceback_later()
            if mark:
                os.remove(mark)

    @pytest.hookimpl(tryfirst=True)
    def pytest_runtest_setup(self, item):
        if getattr(item, "time_limit_worker_ended", False):
            pytest.fail("its worker ended while it ran (the time limit of "
                        f"{self.seconds} s, or a crash); not run again",
                        pytrace=False)


def install(config, seconds=LIMIT_S):
    """Registers a ``TimeLimit`` of ``seconds`` on ``config``."""
    if float(config.getini("faulthandler_timeout") or 0) > 0:
        raise pytest.UsageError(
            "the time limit uses the process's faulthandler timer; "
            "pass no faulthandler_timeout (the limit prints the stacks)")
    config.pluginmanager.register(TimeLimit(config, seconds), "time_limit")
