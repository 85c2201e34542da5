"""Error-model scoring matrices for polishing.

Log-likelihood substitution/indel scores per sequencing platform.  The
probability tables are the reference's published error-model parameters
(reference: flye/config/bin_cfg/pacbio_substitutions.mat,
nano_r94_substitutions.mat; loader semantics src/polishing/subs_matrix.cpp:
score(a,b) = log P, with '-' rows/cols for deletion/insertion).  Scores
are kept as float32 natural-log probabilities rather than the reference's
fixed-point ints — the DP runs in f32 on the device.

Base order: A=0, C=1, G=2, T=3, gap=4.  M[cand_char, read_char].
"""

from __future__ import annotations

import numpy as np

_BASES = "ACGT"

# P(read char | candidate char), P(candidate char deleted), P(char inserted)
_PLATFORM_PROBS = {
    "pacbio": {
        "mat": {"A": 0.9582463498, "C": 0.9435934049, "T": 0.9559668288,
                "G": 0.9501232526},
        "mis": {"CG": 0.0040725792, "AT": 0.0023891038, "TA": 0.0039490745,
                "AG": 0.0022850350, "CT": 0.0035703067, "TC": 0.0028326086,
                "GA": 0.0037474205, "GT": 0.0042757024, "CA": 0.0080860631,
                "GC": 0.0029070538, "TG": 0.0037853330, "AC": 0.0051434271},
        "del": {"A": 0.0319360844, "C": 0.0406776461, "T": 0.0334661551,
                "G": 0.0389465707},
        "ins": {"A": 0.0267382405, "C": 0.0187951126, "T": 0.0208484604,
                "G": 0.0216606426},
    },
    "nano_r7": {  # reference: flye/config/bin_cfg/nano_r7_substitutions.mat
        "mat": {"A": 0.88837, "C": 0.84933, "T": 0.88804, "G": 0.84354},
        "mis": {"CG": 0.02182, "AT": 0.00686, "TA": 0.00697, "AG": 0.01796,
                "CT": 0.02111, "TC": 0.01629, "GA": 0.02185, "GT": 0.02049,
                "CA": 0.02145, "GC": 0.02310, "TG": 0.01666, "AC": 0.01530},
        "del": {"A": 0.07152, "C": 0.08629, "T": 0.07204, "G": 0.09101},
        "ins": {"A": 0.01743, "C": 0.01750, "T": 0.01745, "G": 0.01832},
    },
    "nano": {  # r94
        "mat": {"A": 0.90352852413, "C": 0.899563198899, "G": 0.899432537076,
                "T": 0.903558166301},
        "mis": {"AC": 0.00721554762111, "AG": 0.0285282839875,
                "AT": 0.007674510041, "CA": 0.010653409688,
                "CG": 0.00590756972495, "CT": 0.031881185559,
                "GA": 0.0301509836432, "GC": 0.0059966180506,
                "GT": 0.0104792084014, "TA": 0.00779400554697,
                "TC": 0.0294115994139, "TG": 0.00752739727204},
        "del": {"A": 0.0530531342202, "C": 0.0519946361291,
                "G": 0.0539406528286, "T": 0.0517088314665},
        "ins": {"A": 0.0085546218779, "C": 0.00696690293149,
                "G": 0.00709709153664, "T": 0.00826245765424},
    },
}


def get_subs_matrix(platform: str = "pacbio") -> np.ndarray:
    """5x5 float32 log-prob matrix M[cand, read] (4 = gap)."""
    probs = _PLATFORM_PROBS[platform]
    M = np.zeros((5, 5), dtype=np.float64)
    for i, a in enumerate(_BASES):
        M[i, i] = probs["mat"][a]
        for j, b in enumerate(_BASES):
            if a != b:
                M[i, j] = probs["mis"][a + b]
        M[i, 4] = probs["del"][a]
        M[4, i] = probs["ins"][a]
    M[4, 4] = 1e-10  # gap-to-gap never used
    return np.log(M).astype(np.float32)
