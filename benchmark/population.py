"""Subscription populations, made from a configuration's ``population``.

The one population kind is the upstream router bench's filter grid
(emqx_broker_bench.erl:25-34): ``ids`` x ``nums`` filters made from a
template such as ``device/d{i}/+/n{n}/#``, filter id ``fid = i * nums +
n``. The subscriber table is ``bench.py``'s ``bench_subtable`` (one
subscriber per filter, the first ``shared_percent`` of the filters also
in groups of ``filters_per_group`` filters with ``members`` members
each). Nothing here imports the program: the driver hands its intern
table in.
"""

from __future__ import annotations

import numpy as np


class Grid:
    """The filter grid of a ``population`` entry."""

    def __init__(self, pop: dict):
        self.template = pop["template"]
        self.ids = int(pop["ids"])
        self.nums = int(pop["nums"])
        self.levels = self.template.split("/")
        for lv in self.levels:
            if "{" in lv and lv.replace("{i}", "").replace("{n}", "") \
                    .count("{"):
                raise ValueError(f"template level {lv!r}: only {{i}} and "
                                 f"{{n}} are placeholders")

    @property
    def n_filters(self) -> int:
        return self.ids * self.nums

    def filter(self, i: int, n: int) -> str:
        return self.template.format(i=i, n=n)

    def words(self, intern, plus: int, hash_: int, pad: int,
              max_levels: int):
        """[F, max_levels] int32 interned filter levels and [F] lens, fid
        order, through the program's intern table (its ``intern(word)``)
        and word constants."""
        F, L = self.n_filters, len(self.levels)
        if L > max_levels:
            raise ValueError(f"{self.template}: {L} levels > {max_levels}")
        rows = np.full((F, max_levels), pad, np.int32)
        for k, lv in enumerate(self.levels):
            if lv == "+":
                rows[:, k] = plus
            elif lv == "#":
                rows[:, k] = hash_
            elif "{i}" in lv:
                col = np.array([intern.intern(lv.format(i=i))
                                for i in range(self.ids)], np.int32)
                rows[:, k] = np.repeat(col, self.nums)
            elif "{n}" in lv:
                col = np.array([intern.intern(lv.format(n=n))
                                for n in range(self.nums)], np.int32)
                rows[:, k] = np.tile(col, self.ids)
            else:
                rows[:, k] = intern.intern(lv)
        return rows, np.full(F, L, np.int64)


def subtable(F: int, shared: dict) -> dict:
    """bench.py's ``bench_subtable``: subscriber row = fid with packed
    options 1; the first ``percent`` of the filters in groups of
    ``filters_per_group`` (slot = fid // filters_per_group) with
    ``members`` members each, rows F + members * slot + m, options 1.
    Returns the SubTable's arrays by field name, plus ``n_groups``."""
    per, members = int(shared["filters_per_group"]), int(shared["members"])
    n_shared = F * int(shared["percent"]) // 100
    group_of = np.arange(n_shared, dtype=np.int32) // per
    n_groups = max(1, int(group_of.max(initial=0)) + 1)
    fs_start = np.zeros(F + 1, np.int32)
    fs_start[1:n_shared + 1] = 1
    np.cumsum(fs_start, out=fs_start)
    return {
        "sub_start": np.arange(F + 1, dtype=np.int32),
        "sub_row": np.arange(F, dtype=np.int32),
        "sub_opts": np.ones(F, np.int8),
        "fs_start": fs_start,
        "fs_slot": group_of if n_shared else np.full(1, -1, np.int32),
        "shared_start": np.arange(n_groups + 1, dtype=np.int32) * members,
        "shared_row": F + np.arange(n_groups * members, dtype=np.int32),
        "shared_opts": np.ones(n_groups * members, np.int8),
        "n_groups": n_groups, "n_shared_filters": n_shared}

