"""chip_smoke.py's phase deadlines: a phase that stalls past twice its
ceiling ends the run with a non-zero exit code, every thread's stack on
stderr naming the phase, and no result line; no deadline reaches past
RUN_DEADLINE_S into the run."""

import faulthandler
import os
import subprocess
import sys
import time

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STALL = """
import time
import chip_smoke as cs

def phase_15_stalls():
    cs.PHASE_CEILING_S["15"] = 0.5
    cs.arm_deadline("15", time.time())
    time.sleep(60)
    print('{"ok": true}', flush=True)

phase_15_stalls()
"""


def test_a_stalled_phase_ends_the_run_and_names_itself():
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", STALL], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert time.time() - t0 < 30
    assert out.returncode != 0
    assert "phase 15: start at" in out.stdout
    assert '"ok"' not in out.stdout
    assert "Timeout" in out.stderr
    tail = out.stderr.strip().splitlines()[-3:]
    assert any("phase_15_stalls" in line for line in tail), tail


def test_deadline_is_twice_the_ceiling_within_the_run_limit(capsys):
    try:
        assert cs.arm_deadline("17", time.time()) == \
            2 * cs.PHASE_CEILING_S["17"]
        late = time.time() - (cs.RUN_DEADLINE_S - 10)
        assert 9 <= cs.arm_deadline("20", late) <= 10
        assert cs.arm_deadline("5", time.time() - 2 * cs.RUN_DEADLINE_S) \
            == 1.0
    finally:
        faulthandler.cancel_dump_traceback_later()
    assert "phase 17: start at" in capsys.readouterr().out
    assert sum(cs.PHASE_CEILING_S.values()) <= 700
