"""Model-free self-speculative drafting — the port of
``bigdl_tpu/llm/spec.py``.

A decode pass streams every weight to emit one token a row.
Speculative decoding emits several a pass: draft k candidate tokens
cheaply, verify them all in one pass. This is the model-free variant
(prompt-lookup / n-gram decoding): the drafts come from the request's
own history. The most recent suffix of ``prompt + generated`` is
matched against an earlier occurrence of the same n-gram, and the
tokens that followed it are proposed. No second model, no extra device
memory; on code, templated text and retrieval prompts that quote their
own context the match rate is high.

The proposer is plain Python over int token ids, run on the host while
the card runs the step before. The verify pass is the engine's spec
step (``kvcache.prefill.make_spec_step``): the drafts run as a ragged
chunk at the row's offset, and ``kernels.sampling.spec_accept`` keeps
the longest prefix greedy decode would have produced anyway, so the
tokens equal the non-speculative engine's.

Adaptive k: each request's proposer keeps an EMA of its acceptance
rate. Below ``backoff`` the draft length halves (floor 2: one real
draft); sustained acceptance grows it back toward ``k``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["NGramProposer"]


class NGramProposer:
    """Per-request prompt-lookup draft proposer with adaptive k.

    ``k`` caps the drafts a pass, ``min_match`` is the shortest suffix
    n-gram worth trusting and ``backoff`` the acceptance-rate EMA below
    which the live draft length halves. One instance per engine slot
    and request: the adaptive state is the request's."""

    __slots__ = ("k", "min_match", "max_match", "backoff", "k_live",
                 "acc_ema", "proposed_total", "accepted_total",
                 "last_match")

    def __init__(self, k: int = 4, min_match: int = 2,
                 backoff: float = 0.5, max_match: int = 8):
        self.k = max(1, int(k))
        self.min_match = max(1, int(min_match))
        self.max_match = max(self.min_match, int(max_match))
        self.backoff = float(backoff)
        self.k_live = self.k          # adaptive draft length (<= k)
        self.acc_ema = 1.0            # optimistic start: the first pass drafts
        self.proposed_total = 0
        self.accepted_total = 0
        self.last_match = 0           # n-gram length behind the last draft

    def propose(self, ids: Sequence[int],
                limit: Optional[int] = None) -> List[int]:
        """Up to ``min(k_live, limit)`` continuation tokens for ``ids``
        (prompt + generated so far), or ``[]`` when no suffix n-gram of
        at least ``min_match`` tokens recurs earlier in ``ids``.

        Longest match first, then the most recent occurrence with a
        full ``kmax``-token continuation after it: an occurrence too
        near the end (a constant run always matches one token back,
        with nothing after it) loses to an earlier one that can supply
        drafts. A partial continuation is kept only if it has at least
        2 tokens: the engine consumes a proposal as ``proposal[1:]``."""
        ids = list(ids)
        n = len(ids)
        kmax = self.k_live if limit is None else min(self.k_live,
                                                    int(limit))
        if kmax < 1 or n < self.min_match + 1:
            return []
        for m in range(min(self.max_match, n - 1),
                       self.min_match - 1, -1):
            tail = ids[n - m:]
            last = tail[-1]
            best: List[int] = []
            # j is the end of an earlier occurrence; right to left, so the
            # most recent context wins a tie
            for j in range(n - 2, m - 2, -1):
                if ids[j] != last or ids[j - m + 1:j + 1] != tail:
                    continue
                drafts = ids[j + 1:j + 1 + kmax]
                if len(drafts) == kmax:
                    self.last_match = m
                    return drafts
                if len(drafts) > len(best):
                    best = drafts
            if len(best) >= 2:
                self.last_match = m
                return best
        return []

    def observe(self, proposed: int, accepted: int) -> None:
        """Fold one verify (``accepted`` of ``proposed`` drafts kept)
        into the acceptance EMA and adapt ``k_live``: below ``backoff``
        it halves, down to 2 (a 1-token proposal carries no draft, so
        speculation would stop and the EMA could never recover); above
        the midpoint of ``backoff`` and 1 it grows by one toward ``k``."""
        if proposed <= 0:
            return
        self.proposed_total += proposed
        self.accepted_total += accepted
        rate = accepted / proposed
        self.acc_ema = 0.5 * self.acc_ema + 0.5 * rate
        if self.acc_ema < self.backoff:
            self.k_live = max(min(2, self.k), self.k_live // 2)
        elif self.acc_ema > (1.0 + self.backoff) / 2.0 and \
                self.k_live < self.k:
            self.k_live += 1

    @property
    def accept_rate(self) -> float:
        """Lifetime draft acceptance rate (1.0 before any verify)."""
        if self.proposed_total <= 0:
            return 1.0
        return self.accepted_total / self.proposed_total
