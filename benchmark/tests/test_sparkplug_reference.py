"""The filter-set reference (``reference/filterset_ref.py``) against
brute force: random filters and topics over a small vocabulary with '+',
'#' and a '$' word, every filter matched by ``mqtt_match``; hits confirmed
by whole rows even where every key collides; and the module loads
nothing but NumPy and PyTorch."""

import random
import subprocess
import sys

import numpy as np
import pytest

from benchmark.reference import filterset_ref
from benchmark.reference.filterset_ref import FilterSet
from benchmark.reference.matcher import mqtt_match

VOCAB = ["a", "b", "c", "$SYS", "", "+", "#"]
PLUS, HASH, PAD = 5, 6, -1


def rand_filter(rng):
    n = rng.randint(1, 5)
    lv = [rng.choice(VOCAB[:6]) for _ in range(n)]
    if rng.random() < 0.4:
        lv[-1] = "#"
    return "/".join(lv)


def rand_topic(rng):
    return "/".join(rng.choice(VOCAB[:5]) for _ in range(rng.randint(1, 6)))


def rows(strings, depth=6):
    out = np.full((len(strings), depth), PAD, np.int64)
    lens = np.zeros(len(strings), np.int64)
    for k, s in enumerate(strings):
        lv = s.split("/")
        out[k, :len(lv)] = [VOCAB.index(w) for w in lv]
        lens[k] = len(lv)
    return out, lens


def brute(filters, topics):
    return [[f for f, flt in enumerate(filters) if mqtt_match(t, flt)]
            for t in topics]


def check(fs, filters, topics):
    tw, tl = rows(topics)
    dollar = np.array([t.startswith("$") for t in topics])
    counts, fids = fs.match(tw, tl, dollar)
    at = np.concatenate([[0], np.cumsum(counts)])
    got = [fids[at[k]:at[k + 1]].tolist() for k in range(len(topics))]
    assert got == brute(filters, topics)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_filter_set_is_brute_force(seed):
    rng = random.Random(seed)
    filters = sorted({rand_filter(rng) for _ in range(120)}
                     | {"#", "+", "$SYS/#", "+/#", "a/#", "a"})
    topics = [rand_topic(rng) for _ in range(300)] + ["$SYS", "$SYS/a", "a"]
    fw, fl = rows(filters)
    check(FilterSet(fw, fl, plus=PLUS, hash_=HASH, pad=PAD), filters, topics)


def test_collisions_are_confirmed_away(monkeypatch):
    """With both moduli at 3 nearly every candidate's key collides with
    some filter's; the row comparison still admits only true matches."""
    monkeypatch.setattr(filterset_ref, "M1", 3)
    monkeypatch.setattr(filterset_ref, "M2", 3)
    rng = random.Random(7)
    filters = sorted({rand_filter(rng) for _ in range(60)})
    topics = [rand_topic(rng) for _ in range(100)]
    fw, fl = rows(filters)
    fs = FilterSet(fw, fl, plus=PLUS, hash_=HASH, pad=PAD)
    assert len(set(fs.keys.tolist())) <= 9 < len(filters)
    check(fs, filters, topics)


def test_reference_loads_nothing_of_jax_or_the_program():
    code = ("import sys; import benchmark.reference.filterset_ref, "
            "benchmark.reference.engine_ref, benchmark.sparkplug; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'emqx_tpu', 'emqx_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=filterset_ref.__file__.rsplit("/benchmark/",
                                                           1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
