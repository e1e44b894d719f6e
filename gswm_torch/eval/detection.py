"""Watermark detection statistics.

The reference only reports raw bit accuracy (extract.py:103-110).  A
production watermark service needs calibrated detection: under H0 (no
watermark / wrong key) each decoded bit is Bernoulli(1/2), so the matching
count k out of n follows Binomial(n, 1/2) and

    p-value = P(Binom(n, 1/2) >= k) = I_{1/2}(k, n - k + 1)

(regularized incomplete beta).  TPR@FPR thresholds follow directly.  This is
the Gaussian-Shading analog of the Tree-Ring toolkit's ncx2 p-value
(SURVEY.md §2.3 optim_utils.get_p_value).

The port's copy of ``gswm.eval.detection`` (host only: numpy and scipy).
"""

from __future__ import annotations

import numpy as np
from scipy import stats


def bit_match_pvalue(matching_bits: int, total_bits: int) -> float:
    """One-sided binomial tail under the null of unwatermarked content."""
    return float(stats.binom.sf(matching_bits - 1, total_bits, 0.5))


def detection_threshold(total_bits: int, fpr: float = 1e-6) -> int:
    """Smallest k with P(Binom(n,1/2) >= k) <= fpr."""
    return int(stats.binom.isf(fpr, total_bits, 0.5)) + 1


def is_detected(bit_accuracy: float, total_bits: int, fpr: float = 1e-6) -> bool:
    k = round(bit_accuracy * total_bits)
    return k >= detection_threshold(total_bits, fpr)


def tpr_at_fpr(accuracies, total_bits: int, fpr: float = 1e-6) -> float:
    """Fraction of images whose match count clears the FPR threshold."""
    acc = np.asarray(list(accuracies), dtype=np.float64)
    thresh = detection_threshold(total_bits, fpr)
    return float(np.mean(np.round(acc * total_bits) >= thresh))
