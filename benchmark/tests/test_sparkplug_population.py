"""The Sparkplug plant of ``spb3-5m-edges`` and the ``spb5m-report``
mix: the deployment's counts, its four shapes, the subscriber table, and
drawn topics against ``mqtt_match``; the same seed gives the same ring."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import traffic
from benchmark.drivers.sparkplug import shapes_of
from benchmark.reference.matcher import mqtt_match
from benchmark.sparkplug import Plant

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(kind, name):
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


CFG = load("configs", "spb3-5m-edges")
MIX = load("traffic", "spb5m-report")


def test_deployment_counts():
    plant = Plant(CFG["population"])
    assert plant.n_edge == 5_000_000
    assert plant.n_filters == 10_001_002
    assert plant.fixed == ["spBv1.0/STATE/scada-primary", "spBv1.0/#"]
    assert plant.n_sessions == 5_000_000 + 4 + 8 + 2_000


@pytest.mark.parametrize("ids,nums", [(7, 3), (64, 64)])
def test_small_plant_tables(ids, nums):
    plant = Plant(dict(CFG["population"], ids=ids, nums=nums))
    fw, fl = plant.filter_words()
    E = ids * nums
    assert len(fl) == plant.n_filters == 2 * E + nums + 2
    # 1, 2 and 4 levels before '#', and STATE's 3 exact
    assert shapes_of(fw, fl, plant.plus, plant.hash) == [
        (1, True, False), (2, True, False), (3, False, False),
        (4, True, False)]
    st = plant.subtable()
    rows = np.diff(st["sub_start"])
    state, umbrella = plant.fid_of("spBv1.0/STATE/scada-primary"), \
        plant.fid_of("spBv1.0/#")
    assert rows[state] == E + 1 and rows[umbrella] == 4
    assert (rows[2:2 + nums] == 2).all() and (rows[2 + nums:] == 1).all()
    assert len(st["sub_row"]) == 3 * E + 1 + 4 + 2 * nums
    assert st["fs_start"][umbrella + 1] - st["fs_start"][umbrella] == 1
    assert st["shared_row"].tolist() == list(range(E + 4, E + 12))
    assert plant.filter_string(2 + nums + E + 5) == \
        f"spBv1.0/g{5 // ids}/DCMD/e{5 % ids}/#"


def test_drawn_topics_match_their_filters():
    """A sample of the full-size mix: each topic matches spBv1.0/# and its
    group's filter, and its own edge node's command filter exactly when
    it is a command of that kind."""
    plant = Plant(CFG["population"])
    words, lens = plant.draw(MIX, traffic.rng_for(2**33 + 1, 0), 2000)
    for t in plant.topic_strings(words, lens):
        _ns, g, ty, e, *_d = t.split("/")
        cands = {"spBv1.0/#": True, f"spBv1.0/{g}/#": True,
                 "spBv1.0/STATE/scada-primary": False,
                 f"spBv1.0/{g}/NCMD/{e}/#": ty == "NCMD",
                 f"spBv1.0/{g}/DCMD/{e}/#": ty == "DCMD",
                 f"spBv1.0/{g}/DCMD/e{plant.ids}/#": False}
        assert len(t.split("/")) == (5 if ty.startswith("D") else 4)
        for f, want in cands.items():
            assert mqtt_match(t, f) == want, (t, f)


def test_mix_shares_and_ring_are_the_seeds():
    plant = Plant(CFG["population"])
    mix = dict(MIX, batch=8192)
    a = plant.ring(mix, 2**31 + 11, traffic.rng_for)
    b = plant.ring(mix, 2**31 + 11, traffic.rng_for)
    c = plant.ring(mix, 7, traffic.rng_for)
    assert len(a) == mix["ring"]
    for (wa, la), (wb, lb), (wc, _lc) in zip(a, b, c):
        assert wa.shape == (mix["window"], 8192, 5)
        assert np.array_equal(wa, wb) and np.array_equal(la, lb)
        assert not np.array_equal(wa, wc)
    words = np.concatenate([w.reshape(-1, 5) for w, _l in a])
    ty = np.array(plant.vocab)[words[:, 2]]
    for t, share in MIX["message_types"].items():
        assert abs((ty == t).mean() - share) < 0.01, t
    s1 = plant.start_cursors(2**31 + 11, traffic.rng_for)
    assert s1.tolist() == plant.start_cursors(2**31 + 11,
                                              traffic.rng_for).tolist()
    assert -(1 << 31) <= s1[0] < (1 << 31)


def test_kept_heap_refaults_no_readback_page():
    """After ``keep_host_pages`` an array past glibc's largest mmap
    threshold comes from the heap (below the program break), and made
    again after it is dropped it lands on pages already faulted in (in a
    process of its own: the settings last as long as it does)."""
    code = (
        "import ctypes, resource, numpy as np\n"
        "from benchmark.drivers.sparkplug import keep_host_pages\n"
        "keep_host_pages()\n"
        "libc = ctypes.CDLL('libc.so.6')\n"
        "libc.sbrk.restype = ctypes.c_void_p\n"
        "def touch():\n"
        "    a = np.empty(72 << 20, np.uint8); a[::4096] = 1\n"
        "    return a.ctypes.data < libc.sbrk(0)\n"
        "touch()\n"
        "f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt\n"
        "heap = touch()\n"
        "print(heap, resource.getrusage(resource.RUSAGE_SELF).ru_minflt"
        " - f0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=os.path.dirname(HERE))
    assert out.returncode == 0, out.stderr
    heap, faults = out.stdout.split()
    assert heap == "True" and int(faults) < 8
