"""MQTT topic matching, plain: one filter at a time by the specification,
and an index over a filter grid that finds the same filters.

``mqtt_match`` is the brute-force rule (MQTT 3.1.1 section 4.7): ``+``
matches one level, a trailing ``#`` any number of levels including none
(``a/#`` matches ``a``), and a topic that starts with ``$`` matches no
filter whose first level is a wildcard.

``GridIndex`` answers the same question for every filter of a template
grid at once: it walks the template's levels against the topic's and
looks each placeholder level up in a dict of that column's words. It
holds the grid's strings column by column, not ten million filter
strings; a test holds it against ``mqtt_match`` over every filter.
"""

from __future__ import annotations

import numpy as np


def mqtt_match(topic: str, filt: str) -> bool:
    t, f = topic.split("/"), filt.split("/")
    if topic.startswith("$") and f[0] in ("+", "#"):
        return False
    for k, lv in enumerate(f):
        if lv == "#":
            return True
        if k >= len(t):
            return False
        if lv != "+" and lv != t[k]:
            return False
    return len(t) == len(f)


class GridIndex:
    """The filters ``template.format(i=i, n=n)`` for i < ids, n < nums,
    filter id i * nums + n."""

    def __init__(self, template: str, ids: int, nums: int):
        self.levels = template.split("/")
        self.ids, self.nums = ids, nums
        self.cols = []
        for lv in self.levels:
            if "{i}" in lv:
                self.cols.append(("i", {lv.format(i=i): i
                                        for i in range(ids)}))
            elif "{n}" in lv:
                self.cols.append(("n", {lv.format(n=n): n
                                        for n in range(nums)}))
            else:
                self.cols.append((None, lv))

    def match(self, topic: str) -> list:
        """Every matching filter id, ascending."""
        t = topic.split("/")
        if topic.startswith("$") and self.levels[0] in ("+", "#"):
            return []
        got = {}
        for k, (kind, word) in enumerate(self.cols):
            if kind is None and word == "#":
                break
            if k >= len(t):
                return []
            if kind is None:
                if word != "+" and word != t[k]:
                    return []
            else:
                v = word.get(t[k])
                if v is None:
                    return []
                got[kind] = v
        else:
            if len(t) != len(self.levels):
                return []
        # a placeholder the template lacks: every value of it matches
        ii = [got["i"]] if "i" in got else range(self.ids)
        nn = [got["n"]] if "n" in got else range(self.nums)
        return [i * self.nums + n for i in ii for n in nn]

    def match_many(self, topics: list):
        """(count [T], fids) for a list of topics: topic k's matching
        filter ids, ascending, are the count[k] entries after those of
        the topics before it."""
        memo: dict = {}
        counts, flat = [], []
        for t in topics:
            got = memo.get(t)
            if got is None:
                got = memo[t] = self.match(t)
            counts.append(len(got))
            flat.extend(got)
        return np.array(counts, np.int64), np.array(flat, np.int64)
