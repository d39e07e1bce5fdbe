"""Matching statistics in SA order from two flag scans (the counterpart
of ``andix/esa/matchstats_jax.py``).

For every joint-SA entry: the longest match against one subject segment,
whether it is unique, and its position in the subject string — the
reference's ``get_match_cached`` / ``anchor()`` (src/esa.c:636-656,
src/process.c:113-123) for all query positions at once.
"""

from __future__ import annotations

import torch

from .scans import INF32, flag_scan


def match_stats_device(sa: torch.Tensor, lcp: torch.Tensor,
                       segid: torch.Tensor, subj_seg: int,
                       subj_start: int):
    """(matchlen int32, unique bool, pos_s int32), all [N] in SA order."""
    flag = segid == subj_seg
    sa_rel = sa - subj_start  # payload: position within RS_i

    # upward: values lcp[t] = lcp(SA[t-1], SA[t])
    k_up, g_up, sa_up, suf_up = flag_scan(lcp, flag, sa_rel)
    # downward: values lcp[t+1], scanned from the end
    vals_down = torch.cat([lcp[1:], lcp.new_full((1,), INF32)])
    k_dn, g_dn, sa_dn, suf_dn = flag_scan(vals_down, flag, sa_rel,
                                          reverse=True)
    del flag, sa_rel, vals_down

    neg1 = sa.new_full((), -1)
    u = torch.where(k_up >= 1, suf_up, neg1)
    d = torch.where(k_dn >= 1, suf_dn, neg1)
    del suf_up, suf_dn
    l = torch.maximum(u, d)
    matchlen = torch.clamp(l, min=0)
    both = (u == l) & (d == l)
    second_u = torch.where(k_up >= 2, torch.minimum(u, g_up), neg1)
    second_d = torch.where(k_dn >= 2, torch.minimum(d, g_dn), neg1)
    unique = torch.where(
        (l <= 0) | both,
        False,
        torch.where(u == l, second_u < l, second_d < l),
    )
    pos_s = torch.where(u == l, sa_up, sa_dn)
    return matchlen, unique, pos_s


def inverse_sa_device(sa: torch.Tensor) -> torch.Tensor:
    n = sa.shape[0]
    isa = torch.empty(n, dtype=torch.int32, device=sa.device)
    isa[sa.long()] = torch.arange(n, dtype=torch.int32, device=sa.device)
    return isa
