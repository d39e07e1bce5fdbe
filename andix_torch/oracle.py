"""Brute-force oracle: tiny-input ground truth for the fast pipelines.

``match_stats_brute`` computes, for every query position, the longest-match
length / uniqueness / subject position by direct comparison against every
subject suffix — O(n·m·L), only for test-sized inputs.  ``dist_pair_oracle``
is the end-to-end per-pair oracle mirroring ``dist_anchor`` semantics
(SURVEY.md §7 build order step 2).
"""

from __future__ import annotations

import numpy as np

from .chain import dist_anchor_replay
from .model import CountMatrix
from .runtime import Model as ModelKind
from .sequence import Seq, Subject, subject_init


def match_stats_brute(
    rs: np.ndarray, query: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(matchlen, unique, pos_s) for every query position, brute force.

    ``pos_s`` is the position of the lexicographically smallest subject
    suffix achieving the match (only meaningful where ``unique``).
    """
    rs = np.asarray(rs, dtype=np.uint8)
    query = np.asarray(query, dtype=np.uint8)
    n, m = len(rs), len(query)
    matchlen = np.zeros(m, dtype=np.int64)
    unique = np.zeros(m, dtype=bool)
    pos_s = np.zeros(m, dtype=np.int64)

    for p in range(m):
        rem = m - p
        # lens[s] = lcp(query[p:], rs[s:]) capped at remaining query
        lens = np.zeros(n, dtype=np.int64)
        active = np.arange(n)
        k = 0
        while len(active) and k < rem:
            ok = active + k < n
            ok[ok] = rs[active[ok] + k] == query[p + k]
            lens[active[ok]] += 1
            active = active[ok]
            k += 1
        l = int(lens.max(initial=0))
        matchlen[p] = l
        if l > 0:
            achievers = np.nonzero(lens == l)[0]
            unique[p] = len(achievers) == 1
            if unique[p]:
                pos_s[p] = int(achievers[0])
            else:
                # smallest in suffix order: compare the suffixes
                best = min(
                    achievers, key=lambda s: rs[s:].tobytes()
                )
                pos_s[p] = int(best)
    return matchlen, unique, pos_s


def dist_pair_oracle(
    subject: Subject, query: Seq, model_kind: ModelKind
) -> CountMatrix:
    """End-to-end brute-force distance counts for one (subject, query) pair."""
    matchlen, unique, pos_s = match_stats_brute(subject.rs, query.data)
    return dist_anchor_replay(
        matchlen, unique, pos_s, subject.rs, query.data,
        subject.threshold, model_kind,
    )


def matrix_oracle(
    seqs: list[Seq], anchor_p_value: float, model_kind: ModelKind
) -> list[list[CountMatrix]]:
    """Full n×n count-matrix grid, brute force (reference ``distMatrix``
    semantics incl. the diagonal sentinel, src/dist_hack.h:62)."""
    n = len(seqs)
    M: list[list[CountMatrix]] = [[None] * n for _ in range(n)]  # type: ignore
    for i in range(n):
        subject = subject_init(seqs[i], anchor_p_value)
        for j in range(n):
            if i == j:
                diag = CountMatrix.zero(seq_len=9)
                diag.counts[0] = 9
                M[i][j] = diag
            else:
                M[i][j] = dist_pair_oracle(subject, seqs[j], model_kind)
    return M


# ---------------------------------------------------------------------------
# Shim-RNG twin for the bootstrap byte-parity gate.
#
# The reference seeds its GSL RNG with time(NULL) (src/andi.c:272-279, an
# upstream reproducibility TODO), so `-b` stdout cannot be compared against
# the compiled oracle directly.  The parity tests compile the reference
# against tests/refshim/gsl (splitmix64 + conditional-binomial multinomial,
# seedable via SHIM_RNG_SEED); this is the bit-exact Python twin of that
# stream, enabled in andix by ANDIX_BOOTSTRAP_SHIM_SEED (test-only).  With
# both sides on the same seed, the full multi-matrix `-b` stdout (averaging,
# diagonal sentinels, sci-notation interaction) is byte-comparable.
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


class ShimRng:
    """splitmix64 stream identical to tests/refshim/gsl/gsl_rng.h."""

    def __init__(self, seed: int):
        self.s = (seed if seed else 1) & _MASK64

    def next64(self) -> int:
        self.s = (self.s + 0x9E3779B97F4A7C15) & _MASK64
        z = self.s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        return z ^ (z >> 31)

    def uniform(self) -> float:
        return (self.next64() >> 11) * (1.0 / 9007199254740992.0)

    def binomial(self, p: float, n: int) -> int:
        """tests/refshim/gsl/gsl_randist.h shim_binomial, exactly: direct
        Bernoulli counting below 64 draws, explicit lo-then-hi recursion
        above (the C shim sequences the calls for a defined order)."""
        if p <= 0:
            return 0
        if p >= 1:
            return n
        if n < 64:
            k = 0
            for _ in range(n):
                if self.uniform() < p:
                    k += 1
            return k
        half = n // 2
        lo = self.binomial(p, half)
        return lo + self.binomial(p, n - half)

    def multinomial(self, total: int, p: list[float]) -> list[int]:
        """Conditional-binomial multinomial (gsl_ran_multinomial shim):
        sequential left fold for norm/rest, double division — all ordered
        exactly as the C code so the doubles agree bit for bit."""
        norm = 0.0
        for v in p:
            norm += v
        rest = norm
        left = total
        out = []
        for v in p:
            if v > 0 and rest > 0:
                k = self.binomial(v / rest, left)
            else:
                k = 0
            out.append(k)
            left -= k
            rest -= v
        return out


def shim_model_bootstrap(m, rng: "ShimRng"):
    """Reference ``model_bootstrap`` (src/model.c:222-232) over the shim
    stream: p[i] = counts[i] / nucl with no zero-total guard — the shim
    multinomial returns all zeros for a zero total, matching the oracle."""
    from .model import CountMatrix, model_total

    nucl = model_total(m)
    if nucl <= 0:
        return m.copy()
    p = [float(c) / float(nucl) for c in m.counts]
    counts = rng.multinomial(int(nucl), p)
    return CountMatrix(np.asarray(counts, dtype=np.int64), m.seq_len)
