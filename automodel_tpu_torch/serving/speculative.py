"""Speculative decoding: the host-side draft proposer and the acceptance
rule (counterpart: ``automodel_tpu/serving/speculative.py``; pure Python,
the port's own copy).

A proposer guesses up to ``serving.spec_k`` draft tokens per decode row;
the engine writes token + drafts in ONE step at width ``spec_k + 1`` and
the scheduler accepts the longest draft prefix that matches the step's
own greedy argmax chain, plus the bonus token after it.  A draft is
accepted only where it equals the token greedy decoding emits at that
position, so the output is token-identical to plain greedy decoding.

The proposer is prompt-lookup n-gram drafting: continue the sequence from
the most recent prior occurrence of its trailing n-gram.  A proposer is a
stateless callable ``(seq, k) -> List[int]`` of at most ``k`` tokens, so
recompute preemption and watchdog replay re-draft from the sequence alone.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from automodel_tpu_torch.serving.kv_cache import normalize_null_spelling

# ``serving.speculative`` config domain (enum-validated at config load
# like serving.prefix_caching — see loader._enum_fields).  YAML bools
# normalize: ``speculative: true`` means the default ``ngram`` proposer.
SPECULATIVE_MODES = ("off", "ngram")
DEFAULT_SPECULATIVE = "off"

# Draft tokens proposed per decode row (``serving.spec_k``): the verify
# step runs at width spec_k + 1.  Small by default — acceptance decays
# geometrically with depth, and every proposed-but-rejected position is
# wasted bandwidth.
DEFAULT_SPEC_K = 4

# Prompt-lookup match window: longest trailing n-gram tried first.
NGRAM_MAX = 3
NGRAM_MIN = 1


def normalize_speculative(v):
    v = normalize_null_spelling(v)
    if isinstance(v, bool):
        return "ngram" if v else "off"
    return v


def validate_speculative(v: Optional[str]) -> Optional[str]:
    if v is None:
        return None
    if v not in SPECULATIVE_MODES:
        raise ValueError(
            f"serving.speculative must be one of {list(SPECULATIVE_MODES)} "
            f"(YAML true/false ok — true means 'ngram', or null for the "
            f"default), got {v!r}")
    return v


def propose_ngram(seq: Sequence[int], k: int, *, max_ngram: int = NGRAM_MAX,
                  min_ngram: int = NGRAM_MIN) -> List[int]:
    """Prompt-lookup drafting: find the MOST RECENT prior occurrence of the
    sequence's trailing n-gram (longest n first) and propose the tokens
    that followed it, up to ``k``.  Pure host arithmetic on python ints —
    deterministic, stateless, no device traffic."""
    if k <= 0 or len(seq) < 2:
        return []
    seq = list(seq)
    L = len(seq)
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pattern = seq[L - n:]
        # scan right-to-left so ties resolve to the freshest context —
        # generated-history repetition (decode loops) beats stale prompt
        # matches, which is where acceptance actually comes from
        for i in range(L - n - 1, -1, -1):
            if seq[i:i + n] == pattern:
                draft = seq[i + n:i + n + k]
                if draft:
                    return [int(t) for t in draft]
                break            # a match flush against the suffix: shorter n
    return []


class NgramProposer:
    """The ``ngram`` mode's proposer object (callable, stateless)."""

    def __init__(self, max_ngram: int = NGRAM_MAX,
                 min_ngram: int = NGRAM_MIN):
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def __call__(self, seq: Sequence[int], k: int) -> List[int]:
        return propose_ngram(seq, k, max_ngram=self.max_ngram,
                             min_ngram=self.min_ngram)


# mode -> proposer factory: the registration seam a learned draft model
# plugs into later (the engine resolves through here only; nothing else
# in serving/ knows which proposer is live).
PROPOSERS: Dict[str, Callable[[], Callable]] = {
    "ngram": NgramProposer,
}


def build_proposer(mode: Optional[str]) -> Optional[Callable]:
    """Proposer callable for a validated mode; None for ``off``/null."""
    if mode is None or mode == "off":
        return None
    factory = PROPOSERS.get(mode)
    if factory is None:
        raise ValueError(
            f"no draft proposer registered for serving.speculative={mode!r} "
            f"(registered: {sorted(PROPOSERS)})")
    return factory()


def longest_accepted(draft: Sequence[int], greedy: Sequence[int]) -> int:
    """The acceptance rule: length of the longest draft prefix matching
    the verify step's greedy chain.  ``greedy[j]`` is the argmax AT the
    position draft ``j`` was written to — valid exactly when drafts
    ``0..j-1`` were all accepted, which this prefix rule guarantees."""
    m = 0
    while m < len(draft) and int(draft[m]) == int(greedy[m]):
        m += 1
    return m
