"""MQTT topic matching over an arbitrary filter set, plain, by candidate
enumeration.

A topic of n levels can match only the filters that read, level by
level, either its word or '+', and then end, or end in '#' after any
prefix of it, the empty prefix and the whole topic included (``a/#``
matches ``a``). A topic whose first word starts with '$' matches no
filter whose first level is a wildcard (MQTT 3.1.1 section 4.7.2).
``FilterSet.match`` enumerates those candidates for every topic, keys
each with a 62-bit hash of its own (two polynomial hashes modulo primes
below 2^31, so no product passes 2^62), finds the keys among the sorted
filter keys with ``searchsorted``, and confirms every hit by comparing
the candidate's whole row of words with the filter's, so no collision
can pass.

Words are the caller's ids (any integers, ``pad`` past a row's levels);
the '+' and '#' words are named by id. Everything runs in plain PyTorch
on the device the set is built on, in blocks of topics, and the result
comes back as NumPy: ``(counts [T], fids)``, each topic's matching filter
ids ascending after those of the topics before it, the form
``engine_ref.expected`` takes. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

# two (multiplier, prime modulus) pairs, both below 2^31
P1, M1 = 1_000_003, 2_147_483_647
P2, M2 = 999_983, 2_147_483_629
BLOCK = 1 << 16            # topics a block


def _step(h1, h2, w):
    """Fold one word (int64, any sign) into both hashes."""
    w1 = torch.remainder(w, M1) + 1
    w2 = torch.remainder(w, M2) + 1
    return (h1 * P1 + w1) % M1, (h2 * P2 + w2) % M2


def _key(h1, h2, n):
    """The 62-bit key of a row of ``n`` levels whose words folded to
    (h1, h2)."""
    h1, h2 = _step(h1, h2, n)
    return h1 * (1 << 31) + h2


def row_keys(words: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The key of each row of words [N, L] (its first ``lens`` levels)."""
    N, L = words.shape
    h1 = torch.zeros(N, dtype=torch.int64, device=words.device)
    h2 = torch.zeros_like(h1)
    w = words.long()
    for k in range(L):
        a, b = _step(h1, h2, w[:, k])
        live = k < lens
        h1, h2 = torch.where(live, a, h1), torch.where(live, b, h2)
    return _key(h1, h2, lens.long())


class FilterSet:
    """Filters as rows of word ids: words [F, L], lens [F]."""

    def __init__(self, words, lens, *, plus: int, hash_: int, pad: int,
                 device="cpu"):
        self.device = torch.device(device)
        self.words = torch.as_tensor(np.asarray(words, np.int64),
                                     device=self.device)
        self.lens = torch.as_tensor(np.asarray(lens, np.int64),
                                    device=self.device)
        self.plus, self.hash, self.pad = int(plus), int(hash_), int(pad)
        keys = row_keys(self.words, self.lens)
        self.keys, self.order = torch.sort(keys)

    def _candidates(self, t: torch.Tensor, n: int, dollar: torch.Tensor):
        """Every candidate of topics t [T, >=n] of n levels: (topic
        index, level count before any '#', '+' mask, ends in '#') and its
        key, each [T * C]."""
        T = t.shape[0]
        dev = t.device
        zero = torch.zeros(T, 1, dtype=torch.int64, device=dev)
        h1, h2 = zero, zero.clone()
        plus = torch.full((T, 1), self.plus, dtype=torch.int64, device=dev)
        hsh = torch.full((T, 1), self.hash, dtype=torch.int64, device=dev)
        parts = []
        for k in range(n + 1):
            # prefix of k levels (h over 2^k masks), then '#'
            a, b = _step(h1, h2, hsh.expand_as(h1))
            parts.append((k, True, _key(a, b, torch.full_like(a, k + 1))))
            if k == n:
                parts.append((k, False, _key(h1, h2, torch.full_like(h1, k))))
                break
            w = t[:, k:k + 1].long()
            a1, a2 = _step(h1, h2, w.expand_as(h1))
            b1, b2 = _step(h1, h2, plus.expand_as(h1))
            # mask bit k set: level k is '+'
            h1, h2 = torch.cat([a1, b1], 1), torch.cat([a2, b2], 1)
        owner, lvl, mask, ends, keys = [], [], [], [], []
        for k, is_hash, key in parts:
            C = key.shape[1]
            m = torch.arange(C, device=dev)
            ok = torch.ones(T, C, dtype=torch.bool, device=dev)
            # a '$' topic: no '+' first level, no bare '#'
            wild_root = (m & 1).bool()[None] if k > 0 else \
                torch.full((1, C), is_hash, device=dev)
            ok &= ~(dollar[:, None] & wild_root)
            ti, ci = ok.nonzero(as_tuple=True)
            owner.append(ti)
            lvl.append(torch.full_like(ti, k))
            mask.append(ci)
            ends.append(torch.full_like(ti, int(is_hash)))
            keys.append(key[ti, ci])
        return (torch.cat(owner), torch.cat(lvl), torch.cat(mask),
                torch.cat(ends), torch.cat(keys))

    def _confirm(self, t, owner, lvl, mask, ends, fid) -> torch.Tensor:
        """Whether each hit's filter row equals its candidate's row."""
        L = self.words.shape[1]
        row = self.words[fid]
        n = lvl + ends
        ok = self.lens[fid] == n
        for j in range(L):
            tw = t[owner, j].long() if j < t.shape[1] else \
                torch.full_like(owner, self.pad)
            want = torch.where(j < lvl, torch.where(
                (mask >> j) & 1 == 1, torch.full_like(tw, self.plus), tw),
                torch.where((j == lvl) & (ends == 1),
                            torch.full_like(tw, self.hash),
                            torch.full_like(tw, self.pad)))
            ok &= row[:, j] == want
        return ok

    def match(self, topics, lens, dollar=None):
        """(counts [T], fids) of topics [T, L] word ids with ``lens``
        levels; ``dollar`` [T] marks topics whose first word starts with
        '$'. A topic of 0 levels matches nothing."""
        t_all = torch.as_tensor(np.asarray(topics, np.int64),
                                device=self.device)
        n_all = torch.as_tensor(np.asarray(lens, np.int64),
                                device=self.device)
        T = t_all.shape[0]
        d_all = torch.zeros(T, dtype=torch.bool, device=self.device) \
            if dollar is None else torch.as_tensor(
                np.asarray(dollar, bool), device=self.device)
        owners, fids = [], []
        for s in range(0, T, BLOCK):
            t, nl, dl = (x[s:s + BLOCK] for x in (t_all, n_all, d_all))
            for n in torch.unique(nl).tolist():
                if n <= 0:
                    continue
                sel = (nl == n).nonzero(as_tuple=True)[0]
                owner, lvl, mask, ends, keys = self._candidates(
                    t[sel], n, dl[sel])
                lo = torch.searchsorted(self.keys, keys)
                hi = torch.searchsorted(self.keys, keys, right=True)
                cnt = hi - lo
                rep = torch.repeat_interleave(
                    torch.arange(len(keys), device=self.device), cnt)
                pos = lo[rep] + torch.arange(len(rep), device=self.device) \
                    - torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt,
                                              cnt)
                fid = self.order[pos]
                o = owner[rep]
                ok = self._confirm(t[sel], o, lvl[rep], mask[rep],
                                   ends[rep], fid)
                owners.append(sel[o[ok]] + s)
                fids.append(fid[ok])
        if owners:
            own, fid = torch.cat(owners), torch.cat(fids)
        else:
            own = fid = torch.zeros(0, dtype=torch.int64, device=self.device)
        # ascending by (topic, fid)
        order = torch.argsort(own * max(len(self.lens), 1) + fid)
        own, fid = own[order], fid[order]
        counts = torch.bincount(own, minlength=T)
        return counts.cpu().numpy().astype(np.int64), \
            fid.cpu().numpy().astype(np.int64)
