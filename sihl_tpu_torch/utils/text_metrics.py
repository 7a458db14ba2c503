"""Host-side text metrics: token error rate and edit distance
(replacing torchmetrics.text used at reference
``src/sihl/heads/text_recognition.py:115-118``).

A copy of ``sihl_tpu/utils/text_metrics.py``, kept in the port so that it
imports nothing of the JAX package; the code after this docstring is the
JAX file's, byte for byte.
"""

from typing import List, Sequence


def levenshtein(a: Sequence, b: Sequence) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def token_error_rate(preds: List[Sequence], targets: List[Sequence]) -> float:
    """WER over token sequences: total edit distance / total target length."""
    errors = sum(levenshtein(p, t) for p, t in zip(preds, targets))
    total = sum(len(t) for t in targets)
    return errors / max(total, 1)


def total_edit_distance(preds: List[Sequence], targets: List[Sequence]) -> float:
    """Mean Levenshtein distance (torchmetrics EditDistance default)."""
    if not preds:
        return 0.0
    return sum(levenshtein(p, t) for p, t in zip(preds, targets)) / len(preds)
