"""A Sparkplug B plant fleet: its subscriptions and its traffic, made from
a configuration's ``population`` and a traffic mix.

Every topic is ``spBv1.0/<group_id>/<message_type>/<edge_node_id>`` with
a ``/<device_id>`` for the device messages (Eclipse Sparkplug 3.0.0,
Topic Namespace Elements). The population names its words by template:
group ``n < nums`` is ``words["group"].format(n=n)``, edge node ``i <
ids`` of a group ``words["edge_node"].format(i=i)``, device ``d <
devices`` of an edge node ``words["device"].format(d=d)``; edge node
``(n, i)`` is session row ``k = n * ids + i``.

Sessions and their subscriptions (filters templated with ``{group}`` and
``{edge_node}``):

- every edge node subscribes to ``edge_node["filters"]``: a filter with
  both placeholders is one filter an edge node, one without is one
  filter that every edge node subscribes to;
- each host of ``hosts`` subscribes to its ``filters``;
- every group has the sessions ``site["sessions"]``, each subscribed to
  ``site["filters"]`` (templated with ``{group}`` only);
- ``shared`` is one ``$share`` group of ``members`` sessions on one
  filter.

Filters get ids in order of first appearance: the filters without a
placeholder, then each group template's block (``n``), then each edge
node template's block (``k``). Words are ids into the plant's own
vocabulary (``Plant.vocab``), rows padded with -1; nothing here imports
the program, whose intern table the driver maps the vocabulary into.
"""

from __future__ import annotations

import numpy as np

PAD = -1
# the message types of the namespace (Sparkplug 3.0.0, Topic Namespace
# Elements)
MESSAGE_TYPES = ("NBIRTH", "NDEATH", "DBIRTH", "DDEATH", "NDATA", "DDATA",
                 "NCMD", "DCMD", "STATE")


def _opts(qos) -> int:
    return int(qos) & 0x3


class Plant:
    """The filter set, subscriber table and vocabulary of a population."""

    def __init__(self, pop: dict):
        self.ids, self.nums = int(pop["ids"]), int(pop["nums"])
        self.devices = int(pop["devices"])
        self.words = pop["words"]
        self.edge_node = pop["edge_node"]
        self.hosts = pop["hosts"]
        self.site = pop["site"]
        self.shared = pop["shared"]
        self.n_edge = self.ids * self.nums
        templates = list(self.edge_node["filters"]) + \
            [f for h in self.hosts for f in h["filters"]] + \
            list(self.site["filters"]) + [self.shared["filter"]]
        literal = [lv for t in templates for lv in t.split("/")
                   if lv not in ("{group}", "{edge_node}")]
        self._literal = list(dict.fromkeys(
            literal + list(MESSAGE_TYPES) + ["+", "#"]))
        self._g0 = len(self._literal)
        self._e0 = self._g0 + self.nums
        self._d0 = self._e0 + self.ids
        fixed = [t for t in templates if "{" not in t]
        self.fixed = list(dict.fromkeys(fixed))
        self.group_tpl = list(dict.fromkeys(
            t for t in templates if "{group}" in t
            and "{edge_node}" not in t))
        self.edge_tpl = list(dict.fromkeys(
            t for t in templates if "{edge_node}" in t))
        for t in self.edge_tpl:
            if "{group}" not in t:
                raise ValueError(f"{t}: an edge node filter names its group")
        self.depth = max(len(t.split("/")) for t in templates)
        # session rows: edge nodes, hosts, shared members, site sessions
        self.host_row0 = self.n_edge
        self.member_row0 = self.host_row0 + len(self.hosts)
        self.site_row0 = self.member_row0 + int(self.shared["members"])
        self.n_sessions = self.site_row0 + self.nums * len(
            self.site["sessions"])

    # --- vocabulary ------------------------------------------------------

    @property
    def vocab(self) -> list:
        """Every word's string by id."""
        w = self.words
        return (self._literal
                + [w["group"].format(n=n) for n in range(self.nums)]
                + [w["edge_node"].format(i=i) for i in range(self.ids)]
                + [w["device"].format(d=d) for d in range(self.devices)])

    def word_id(self, word: str) -> int:
        """The id of a literal word: a level of a filter template, a
        message type, '+' or '#'."""
        return self._literal.index(word)

    @property
    def plus(self) -> int:
        return self.word_id("+")

    @property
    def hash(self) -> int:
        return self.word_id("#")

    # --- filters ---------------------------------------------------------

    @property
    def n_filters(self) -> int:
        return len(self.fixed) + self.nums * len(self.group_tpl) \
            + self.n_edge * len(self.edge_tpl)

    def fid_of(self, filt: str) -> int:
        """The id of a filter without a placeholder."""
        return self.fixed.index(filt)

    def _rows(self, tpl: str, n, i) -> np.ndarray:
        lv = tpl.split("/")
        out = np.full((len(n), self.depth), PAD, np.int32)
        for k, w in enumerate(lv):
            if w == "{group}":
                out[:, k] = self._g0 + n
            elif w == "{edge_node}":
                out[:, k] = self._e0 + i
            else:
                out[:, k] = self.word_id(w)
        return out

    def filter_words(self):
        """([F, depth] int32 word ids padded with PAD, [F] int64 levels),
        in fid order."""
        parts, lens = [], []
        zero = np.zeros(1, np.int64)
        for t in self.fixed:
            parts.append(self._rows(t, zero, zero))
            lens.append(np.full(1, len(t.split("/"))))
        n = np.arange(self.nums, dtype=np.int64)
        for t in self.group_tpl:
            parts.append(self._rows(t, n, n))
            lens.append(np.full(self.nums, len(t.split("/"))))
        k = np.arange(self.n_edge, dtype=np.int64)
        for t in self.edge_tpl:
            parts.append(self._rows(t, k // self.ids, k % self.ids))
            lens.append(np.full(self.n_edge, len(t.split("/"))))
        return np.concatenate(parts), np.concatenate(lens).astype(np.int64)

    def filter_string(self, fid: int) -> str:
        words, lens = self._filter_row(fid)
        v = self.vocab
        return "/".join(v[int(x)] for x in words[:lens])

    def _filter_row(self, fid: int):
        nf, ng = len(self.fixed), self.nums * len(self.group_tpl)
        if fid < nf:
            t, n, i = self.fixed[fid], 0, 0
        elif fid < nf + ng:
            q, n = divmod(fid - nf, self.nums)
            t, i = self.group_tpl[q], 0
        else:
            q, k = divmod(fid - nf - ng, self.n_edge)
            t, n, i = self.edge_tpl[q], k // self.ids, k % self.ids
        row = self._rows(t, np.array([n]), np.array([i]))[0]
        return row, len(t.split("/"))

    # --- subscribers -----------------------------------------------------

    def subtable(self) -> dict:
        """The SubTable's arrays by field name (numpy; sub_opts the
        packed QoS), plus ``n_groups`` (shared slots: one)."""
        F = self.n_filters
        nf, ng = len(self.fixed), self.nums * len(self.group_tpl)
        # the fixed filters' subscribers: edge nodes first, then hosts
        fixed_rows = [[] for _ in self.fixed]
        fixed_opts = [[] for _ in self.fixed]
        e_qos = _opts(self.edge_node.get("qos", 0))
        for t in self.edge_node["filters"]:
            if t in self.fixed:
                f = self.fid_of(t)
                fixed_rows[f].append(np.arange(self.n_edge, dtype=np.int32))
                fixed_opts[f].append(np.full(self.n_edge, e_qos, np.int8))
        for h, host in enumerate(self.hosts):
            for t in host["filters"]:
                f = self.fid_of(t)
                fixed_rows[f].append(np.full(1, self.host_row0 + h,
                                             np.int32))
                fixed_opts[f].append(np.full(1, _opts(host.get("qos", 0)),
                                             np.int8))
        sess = self.site["sessions"]
        s_qos = _opts(self.site.get("qos", 0))
        rows, opts, count = [], [], np.zeros(F, np.int64)
        for f in range(nf):
            r = np.concatenate(fixed_rows[f]) if fixed_rows[f] \
                else np.zeros(0, np.int32)
            rows.append(r)
            opts.append(np.concatenate(fixed_opts[f]) if fixed_opts[f]
                        else np.zeros(0, np.int8))
            count[f] = len(r)
        n = np.arange(self.nums, dtype=np.int32)
        for q, _t in enumerate(self.group_tpl):
            r = self.site_row0 + n[:, None] * len(sess) \
                + np.arange(len(sess), dtype=np.int32)[None]
            rows.append(r.reshape(-1).astype(np.int32))
            opts.append(np.full(r.size, s_qos, np.int8))
            count[nf + q * self.nums: nf + (q + 1) * self.nums] = len(sess)
        for q, _t in enumerate(self.edge_tpl):
            rows.append(np.arange(self.n_edge, dtype=np.int32))
            opts.append(np.full(self.n_edge, e_qos, np.int8))
            lo = nf + ng + q * self.n_edge
            count[lo:lo + self.n_edge] = 1
        sub_start = np.zeros(F + 1, np.int64)
        np.cumsum(count, out=sub_start[1:])
        if sub_start[-1] >= 1 << 31:
            raise ValueError("more than 2^31 subscriptions")
        members = int(self.shared["members"])
        fs_start = np.zeros(F + 1, np.int32)
        fs_start[self.fid_of(self.shared["filter"]) + 1:] = 1
        return {
            "sub_start": sub_start.astype(np.int32),
            "sub_row": np.concatenate(rows).astype(np.int32),
            "sub_opts": np.concatenate(opts).astype(np.int8),
            "fs_start": fs_start,
            "fs_slot": np.zeros(1, np.int32),
            "shared_start": np.array([0, members], np.int32),
            "shared_row": self.member_row0 + np.arange(members,
                                                       dtype=np.int32),
            "shared_opts": np.full(members, _opts(self.shared.get("qos", 0)),
                                   np.int8),
            "n_groups": 1}

    # --- traffic ---------------------------------------------------------

    def draw(self, mix: dict, rng, size: int):
        """``size`` messages of the mix: ([size, depth] int32 topic word
        ids padded with PAD, [size] int32 levels). Message types by the
        mix's shares; group, edge node and device uniform, with
        replacement."""
        types = list(mix["message_types"])
        share = np.array([float(mix["message_types"][t]) for t in types])
        if abs(share.sum() - 1.0) > 1e-9:
            raise ValueError(f"message type shares sum to {share.sum()}")
        ty = rng.choice(len(types), size=size, p=share)
        n = rng.integers(0, self.nums, size)
        i = rng.integers(0, self.ids, size)
        d = rng.integers(0, self.devices, size)
        node = mix["node_topic"].split("/")
        dev = mix["device_topic"].split("/")
        depth = max(len(node), len(dev), self.depth)
        out = np.full((size, depth), PAD, np.int32)
        is_dev = np.isin(np.array(types), mix["device_types"])[ty]
        lens = np.where(is_dev, len(dev), len(node)).astype(np.int32)
        type_ids = np.array([self.word_id(t) for t in types], np.int32)
        for lv, sel in ((node, ~is_dev), (dev, is_dev)):
            for k, w in enumerate(lv):
                if w == "{group}":
                    col = self._g0 + n
                elif w == "{edge_node}":
                    col = self._e0 + i
                elif w == "{device}":
                    col = self._d0 + d
                elif w == "{type}":
                    col = type_ids[ty]
                else:
                    col = np.full(size, self.word_id(w))
                out[sel, k] = col[sel]
        return out, lens

    def ring(self, mix: dict, seed: int, rng_for) -> list:
        """``ring`` windows, each ([W, B, depth] words, [W, B] levels)."""
        W, B = int(mix["window"]), int(mix["batch"])
        out = []
        for r in range(int(mix["ring"])):
            words, lens = self.draw(mix, rng_for(seed, 1, r), W * B)
            out.append((words.reshape(W, B, -1), lens.reshape(W, B)))
        return out

    def encode(self, topics: list):
        """Topic strings of the plant's words as ([T, depth] word ids
        padded with PAD, [T] int32 levels)."""
        ids = {w: k for k, w in enumerate(self.vocab)}
        out = np.full((len(topics), self.depth), PAD, np.int32)
        lens = np.zeros(len(topics), np.int32)
        for t, topic in enumerate(topics):
            lv = topic.split("/")
            out[t, :len(lv)] = [ids[w] for w in lv]
            lens[t] = len(lv)
        return out, lens

    def topic_strings(self, words, lens) -> list:
        """Word ids and levels back to topic strings."""
        v = self.vocab
        return ["/".join(v[int(x)] for x in row[:n])
                for row, n in zip(np.asarray(words).reshape(
                    -1, np.shape(words)[-1]).tolist(),
                    np.asarray(lens).reshape(-1).tolist())]

    def start_cursors(self, seed: int, rng_for) -> np.ndarray:
        """The shared slot's round-robin cursor at the start, as int64 in
        int32's range: drawn from the seed over the whole range, as on a
        node that has run for hours."""
        return rng_for(seed, 2).integers(-(1 << 31), 1 << 31, 1,
                                         dtype=np.int64)
