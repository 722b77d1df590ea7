"""Columnar topic-filter trie: the host-side batch compiler (numpy).

Counterpart of ``emqx_tpu/ops/trie.py`` (``TrieTables`` :33, ``mix_hash``
:57, ``_build_edge_table`` :72, ``build_tables`` :102, ``_assemble``
:170): the full filter set is lexicographically sorted and collapsed into
flat arrays in one vectorized pass per level, producing

  - an open-addressing hash table of exact edges (parent_node, word) → child
  - per-node '+' and '#' child slots (wildcard branches of the match NFA)
  - per-node terminal filter id

which ``ops/match.match_batch`` walks batched over topics. Numpy only; the
build output equals the original's array for array. ``HostTrie`` (:206 of
the original) is the dynamic dict trie the host router and the engine's
post-snapshot delta filters match through. With subscription covering
the trie is built over the covering set (``filter_ids`` keeps the full
set's fids) and carries ``ops.cover.CoverTables`` in ``cover``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from emqx_tpu_torch.ops.intern import HASH, PAD, PLUS

# Linear-probe budget for the edge hash table. The builder grows capacity
# until every edge lands within MAX_PROBES of its home slot, so the device
# lookup can unroll exactly this many probes.
MAX_PROBES = 8


class TrieTables(NamedTuple):
    """Flat trie planes (numpy after ``build_tables``, tensors after
    ``convert.router_tables_from_numpy``).

    slot_parent/slot_word/slot_child: edge hash table, -1 parent = empty slot.
    plus_child/hash_child: wildcard branch per node, -1 = none.
    node_filter: terminal filter id per node, -1 = none.
    num_nodes/num_edges: scalars (informational; capacities come from shapes).
    cover: ``ops.cover.CoverTables`` when the trie holds the covering set
      only (subscription covering), else None.
    """

    slot_parent: object  # [S]
    slot_word: object    # [S]
    slot_child: object   # [S]
    plus_child: object   # [N]
    hash_child: object   # [N]
    node_filter: object  # [N]
    num_nodes: object    # []
    num_edges: object    # []
    cover: Optional[NamedTuple] = None


def mix_hash(parent, word):
    """32-bit hash of an edge key (numpy uint32 wraparound). The device
    lookup computes the same value in ``ops/match._mix_hash_t``."""
    p = parent.astype("uint32")
    w = word.astype("uint32")
    h = (p * np.uint32(0x9E3779B1)) ^ (w * np.uint32(0x85EBCA77))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    return h


def _next_pow2(x: int) -> int:
    return 1 << max(4, (x - 1).bit_length())


def _build_edge_table(parents: np.ndarray, words_: np.ndarray,
                      children: np.ndarray, capacity: int):
    """Vectorized linear-probe insertion; returns None if MAX_PROBES exceeded."""
    mask = capacity - 1
    slot_parent = np.full(capacity, -1, np.int32)
    slot_word = np.zeros(capacity, np.int32)
    slot_child = np.full(capacity, -1, np.int32)
    home = (mix_hash(parents, words_) & np.uint32(mask)).astype(np.int64)
    pending = np.arange(len(parents))
    probe = np.zeros(len(parents), np.int64)
    while len(pending):
        if probe.max(initial=0) >= MAX_PROBES:
            return None
        target = (home[pending] + probe) & mask
        free = slot_parent[target] == -1
        # among pending edges probing a free slot, first claimant per slot wins
        tgt_free = np.where(free, target, -1)
        _, winner_idx = np.unique(tgt_free, return_index=True)
        winner_idx = winner_idx[tgt_free[winner_idx] >= 0]
        win = np.zeros(len(pending), bool)
        win[winner_idx] = True
        placed = pending[win]
        slot_parent[target[win]] = parents[placed]
        slot_word[target[win]] = words_[placed]
        slot_child[target[win]] = children[placed]
        pending = pending[~win]
        probe = probe[~win] + 1
    return slot_parent, slot_word, slot_child


def build_tables(words: np.ndarray, lens: np.ndarray,
                 filter_ids: Optional[np.ndarray] = None,
                 node_capacity: Optional[int] = None,
                 slot_capacity: Optional[int] = None) -> TrieTables:
    """Compile a deduplicated filter set into TrieTables.

    words: [F, L] int32 interned level ids, PAD beyond lens[f].
    lens:  [F] level counts (>=1).
    filter_ids: [F] dense filter ids (default: row index).

    One vectorized pass per level: rows are lexsorted so equal prefixes are
    contiguous; new trie nodes are boundaries of (parent, word) runs.
    """
    words = np.asarray(words, np.int32)
    lens = np.asarray(lens, np.int64)
    F, L = words.shape if words.ndim == 2 else (0, 0)
    if filter_ids is None:
        filter_ids = np.arange(F)
    filter_ids = np.asarray(filter_ids, np.int64)

    if F == 0:
        return _assemble(np.array([-1]), np.array([0]), np.array([-1]),
                         1, 0, node_capacity, slot_capacity)

    order = np.lexsort(tuple(words[:, l] for l in range(L - 1, -1, -1)))
    Ws = words[order]
    ls = lens[order]
    fids = filter_ids[order]

    parent = np.zeros(F, np.int64)  # node id after consuming l words (root=0)
    num_nodes = 1
    node_parents = [np.array([-1], np.int64)]
    node_words = [np.array([PAD], np.int64)]
    node_filters = [np.array([-1], np.int64)]

    for l in range(L):
        alive = ls > l
        if not alive.any():
            break
        w = Ws[:, l].astype(np.int64)
        prev_alive = np.concatenate(([False], alive[:-1]))
        prev_parent = np.concatenate(([-2], parent[:-1]))
        prev_w = np.concatenate(([-2], w[:-1]))
        is_new = alive & (~prev_alive | (parent != prev_parent) | (w != prev_w))
        rank = np.cumsum(is_new) - 1  # per-row index of its (parent,word) run
        node_of_row = num_nodes + rank
        cnt = int(is_new.sum())

        node_parents.append(parent[is_new])
        node_words.append(w[is_new])
        nf = np.full(cnt, -1, np.int64)
        term = alive & (ls == l + 1)
        tnodes = node_of_row[term] - num_nodes
        if len(np.unique(tnodes)) != len(tnodes):
            raise ValueError("duplicate filters passed to build_tables")
        nf[tnodes] = fids[term]
        node_filters.append(nf)

        parent = np.where(alive, node_of_row, parent)
        num_nodes += cnt

    node_parent = np.concatenate(node_parents)
    node_word = np.concatenate(node_words)
    node_filter = np.concatenate(node_filters)
    return _assemble(node_parent, node_word, node_filter, num_nodes,
                     F, node_capacity, slot_capacity)


def _assemble(node_parent, node_word, node_filter, num_nodes, num_filters,
              node_capacity, slot_capacity) -> TrieTables:
    ids = np.arange(num_nodes)
    N = node_capacity or _next_pow2(num_nodes)
    if N < num_nodes:
        raise ValueError(f"node_capacity {N} < {num_nodes} nodes")

    plus_child = np.full(N, -1, np.int32)
    hash_child = np.full(N, -1, np.int32)
    nf = np.full(N, -1, np.int32)
    nf[:num_nodes] = node_filter

    is_plus = (node_word == PLUS) & (ids != 0)
    is_hash = (node_word == HASH) & (ids != 0)
    plus_child[node_parent[is_plus]] = ids[is_plus]
    hash_child[node_parent[is_hash]] = ids[is_hash]

    em = ~is_plus & ~is_hash & (ids != 0)
    eparents = node_parent[em].astype(np.int32)
    ewords = node_word[em].astype(np.int32)
    echildren = ids[em].astype(np.int32)
    num_edges = len(eparents)

    S = slot_capacity or _next_pow2(max(16, 2 * num_edges))
    while True:
        built = _build_edge_table(eparents, ewords, echildren, S)
        if built is not None:
            break
        S *= 2
    slot_parent, slot_word, slot_child = built

    return TrieTables(
        slot_parent=slot_parent, slot_word=slot_word, slot_child=slot_child,
        plus_child=plus_child, hash_child=hash_child, node_filter=nf,
        num_nodes=np.int32(num_nodes), num_edges=np.int32(num_edges),
    )




class HostTrie:
    """Dynamic dict-based trie over interned word ids.

    Role: (a) accumulator for subscribe/unsubscribe deltas between columnar
    rebuilds, (b) CPU fallback matcher for topics that overflow the device
    NFA's static frontier/match/level capacities. Same match semantics as the
    device NFA and the reference (emqx_trie.erl do_match + root-'$' rule).
    """

    __slots__ = ("children", "plus", "hash", "filter_id")

    def __init__(self):
        self.children: dict[int, HostTrie] = {}
        self.plus: Optional[HostTrie] = None
        self.hash: Optional[HostTrie] = None
        self.filter_id: int = -1

    def insert(self, word_ids: list[int], filter_id: int) -> None:
        node = self
        for w in word_ids:
            if w == PLUS:
                node.plus = node.plus or HostTrie()
                node = node.plus
            elif w == HASH:
                node.hash = node.hash or HostTrie()
                node = node.hash
            else:
                nxt = node.children.get(w)
                if nxt is None:
                    nxt = node.children[w] = HostTrie()
                node = nxt
        node.filter_id = filter_id

    def delete(self, word_ids: list[int]) -> None:
        path = [(None, self)]
        node = self
        for w in word_ids:
            nxt = (node.plus if w == PLUS else
                   node.hash if w == HASH else node.children.get(w))
            if nxt is None:
                return
            path.append((w, nxt))
            node = nxt
        node.filter_id = -1
        # prune empty tails
        for i in range(len(path) - 1, 0, -1):
            w, n = path[i]
            if n.filter_id == -1 and not n.children and n.plus is None and n.hash is None:
                pnode = path[i - 1][1]
                if w == PLUS:
                    pnode.plus = None
                elif w == HASH:
                    pnode.hash = None
                else:
                    pnode.children.pop(w, None)
            else:
                break

    def match(self, word_ids: list[int], is_dollar: bool = False) -> list[int]:
        """Matching filter ids for a (non-wildcard) topic."""
        out: list[int] = []
        self._match(word_ids, 0, is_dollar, out)
        return out

    def _match(self, ws: list[int], i: int, dollar_root: bool, out: list[int]) -> None:
        skip_wild = dollar_root and i == 0
        if not skip_wild and self.hash is not None and self.hash.filter_id >= 0:
            out.append(self.hash.filter_id)
        if i == len(ws):
            if self.filter_id >= 0:
                out.append(self.filter_id)
            return
        if not skip_wild and self.plus is not None:
            self.plus._match(ws, i + 1, dollar_root, out)
        nxt = self.children.get(ws[i])
        if nxt is not None:
            nxt._match(ws, i + 1, dollar_root, out)

    def is_empty(self) -> bool:
        return self.filter_id < 0 and not self.children and self.plus is None and self.hash is None
