"""The test harness itself: CPU dispatch runs inline, and every test has a
time limit that ends a hung test without ending the run."""

import os
import subprocess
import sys
import textwrap
import time
import xml.etree.ElementTree as ET

import jax

import time_limit


def test_cpu_async_dispatch_is_off():
    # conftest.py turns it off; on, interpret-mode Pallas tests deadlock
    # under CPU load.
    assert jax.config.read("jax_cpu_enable_async_dispatch") is False


def test_time_limit_ends_a_hung_test_and_the_run_goes_on(tmp_path):
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {os.path.dirname(time_limit.__file__)!r})
        import time_limit

        def pytest_configure(config):
            time_limit.install(config, seconds=2)
        """))
    (tmp_path / "test_hang.py").write_text(textwrap.dedent("""\
        import time

        def test_sleeps():
            time.sleep(60)

        def test_passes():
            pass
        """))
    # xdist runs the larger file first: the worker that the limit ends
    # has a finished file behind it.
    (tmp_path / "test_done.py").write_text(textwrap.dedent("""\
        import pytest

        @pytest.mark.parametrize("i", range(3))
        def test_done(i):
            pass
        """))
    xml = tmp_path / "out.xml"
    start = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "xdist", "-n", "1",
         "--dist", "loadfile", "-p", "no:cacheprovider", "-p", "no:randomly",
         f"--junitxml={xml}", "test_hang.py", "test_done.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items()
             if not k.startswith("PYTEST_")})
    elapsed = time.monotonic() - start
    log = proc.stdout + proc.stderr

    assert elapsed < 60, log
    assert proc.returncode != 0, log
    # faulthandler's dump names the hung test's frame, once
    assert log.count("Timeout (0:00:02)!") == 1, log
    assert "line 4 in test_sleeps" in log, log
    assert "crashed while running 'test_hang.py::test_sleeps'" in log, log

    outcomes = {}
    for case in ET.parse(xml).getroot().iter("testcase"):
        failed = any(c.tag in ("failure", "error") for c in case)
        outcomes.setdefault(case.get("name"), []).append(
            "failed" if failed else "passed")
    # xdist's loadfile scheduler hands the hung test's file to a new
    # worker, the hung test included; the mark the limit left fails it
    # there at setup instead of running it again. The finished file is
    # not run again.
    assert outcomes == {"test_sleeps": ["failed", "failed"],
                        "test_passes": ["passed"],
                        "test_done[0]": ["passed"],
                        "test_done[1]": ["passed"],
                        "test_done[2]": ["passed"]}, (outcomes, log)
    assert "not run again" in log, log
