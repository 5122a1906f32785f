"""Speculative decoding — draft-proposed, flagship-verified tokens (port
of horovod_tpu/serving/speculative.py; the acceptance math is numpy, as
the reference's).

A small draft model (typically a layer-prefix of the target —
``tfm.draft_config`` / ``tfm.draft_params_from``) proposes ``k`` tokens
autoregressively; the flagship scores all of them in ONE batched
``tfm.decode_verify`` forward (K = k+1 query positions per slot: the
pending input token plus the k proposals).  The engine then accepts a
prefix of the proposals per slot:

* **greedy** (temperature 0): accept while the proposal equals the
  target argmax — exact: the emitted stream is the non-speculative
  greedy stream, because every emitted token is an argmax of target
  logits over a context of previously-emitted target tokens
  (:func:`accept_greedy`);
* **seeded sampling** (:func:`accept_sampled`): proposal x drawn from the
  draft distribution q is accepted with probability
  ``min(1, p(x) / q(x))`` against the target distribution p; on the
  first rejection the corrected token draws from the residual
  ``max(0, p - q) / Z``.  Marginalizing over the draft's proposal gives
  back exactly p (:func:`acceptance_identity`), so speculation changes
  throughput, never the sampled distribution.

Per accepted run of j proposals the engine emits j+1 tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import numpy as np

from ..models import transformer as tfm

_TINY = 1e-30


@dataclasses.dataclass
class DraftSpec:
    """The draft model the engine speculates with.  ``k`` proposals
    per round (clamped >= 1); the draft must share the target's vocab
    and cover its positional extent — checked loudly at attach."""

    cfg: tfm.TransformerConfig
    params: Any
    k: int = 4

    def validate(self, target_cfg: tfm.TransformerConfig,
                 max_len: int) -> None:
        if self.cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.cfg.vocab_size} != target "
                f"{target_cfg.vocab_size} — proposals would not share "
                "the token space")
        if self.cfg.seq_len < max_len:
            raise ValueError(
                f"draft positional table ({self.cfg.seq_len}) shorter "
                f"than the serving context ({max_len})")
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")


def probs(logits: np.ndarray, temperature: float) -> np.ndarray:
    """fp64 softmax at ``temperature`` — the one distribution both the
    proposal draw and the acceptance test use (they MUST agree, or the
    accept ratio is against the wrong q)."""
    z = logits.astype(np.float64) / max(float(temperature), 1e-8)
    z = z - z.max()
    p = np.exp(z)
    return p / p.sum()


def accept_prob(p: np.ndarray, q: np.ndarray, x: int) -> float:
    """P(accept proposal x): min(1, p(x) / q(x))."""
    return float(min(1.0, p[x] / max(q[x], _TINY)))


def residual(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The rejection distribution max(0, p - q) / Z (falls back to p
    when q dominates p everywhere, i.e. Z underflows)."""
    r = np.maximum(p - q, 0.0)
    z = r.sum()
    return r / z if z > _TINY else p


def acceptance_identity(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The distribution speculative sampling actually emits for one
    proposal round, marginalized over the draft's draw:

        out(x) = q(x)·min(1, p(x)/q(x)) + P(reject)·residual(x)

    Algebra: the first term is min(p, q); P(reject) = 1 - Σ min(p, q)
    = Σ max(0, p - q) = Z, and Z·residual = max(0, p - q), so
    out = min(p, q) + max(0, p - q) = p.  Returned so tests can check
    the implementation's helpers reproduce the identity numerically.
    """
    accept = np.array([q[x] * accept_prob(p, q, x)
                       for x in range(len(p))])
    return accept + (1.0 - accept.sum()) * residual(p, q)


def accept_greedy(target_logits: np.ndarray,
                  proposals: Sequence[int]) -> Tuple[int, int]:
    """Greedy acceptance: ``target_logits`` is (k+1, V) — row t scores
    the position AFTER proposal t.  Returns ``(j, next_token)``: j
    proposals accepted (argmax-equal prefix) and the token the target
    emits next (the correction at the first mismatch, or the bonus
    when everything matched) — exactly the non-speculative stream."""
    j = 0
    for t, d in enumerate(proposals):
        if int(np.argmax(target_logits[t])) != int(d):
            break
        j += 1
    return j, int(np.argmax(target_logits[j]))


def accept_sampled(target_logits: np.ndarray, draft_logits: np.ndarray,
                   proposals: Sequence[int], temperature: float,
                   rng: np.random.Generator) -> Tuple[int, int]:
    """Seeded speculative sampling: accept a prefix of ``proposals``
    (row t of ``draft_logits`` is the draft distribution proposal t was
    drawn from), then draw the correction/bonus.  Consumes one uniform
    per considered proposal plus one categorical draw — deterministic
    under ``rng``'s seed.  Returns ``(j, next_token)``."""
    for t, d in enumerate(proposals):
        p = probs(target_logits[t], temperature)
        q = probs(draft_logits[t], temperature)
        if float(rng.uniform()) <= accept_prob(p, q, int(d)):
            continue
        res = residual(p, q)
        return t, int(rng.choice(len(res), p=res))
    p = probs(target_logits[len(proposals)], temperature)
    return len(proposals), int(rng.choice(len(p), p=p))
