import numpy as np

from flye_jax.polishing.homopolisher import (fix_dinucleotide_repeats,
                                             get_hopo_model,
                                             polish_homopolymers)


def codes(s):
    return np.array([{"A": 0, "C": 1, "G": 2, "T": 3}[c] for c in s],
                    dtype=np.uint8)


def to_str(c):
    return "".join("ACGT"[x] for x in c)


def test_model_loads():
    obs, gen = get_hopo_model("pacbio")
    assert obs.shape == (4, 21, 33)
    # diagonal dominance for moderate runs
    assert obs[0, 3, 3] > obs[0, 3, 7]


def test_homopolymer_extension():
    # candidate under-calls a 5-run as 4; branches all show 5
    cand = codes("CGT" + "A" * 4 + "TGC")
    branches = [codes("CGT" + "A" * 5 + "TGC") for _ in range(6)]
    out = polish_homopolymers(cand, branches, "pacbio")
    assert to_str(out) == "CGT" + "A" * 5 + "TGC"


def test_homopolymer_short_runs_untouched():
    # runs below the confidence floor are left alone
    cand = codes("CGTAATGC")
    branches = [codes("CGTAAATGC") for _ in range(6)]
    out = polish_homopolymers(cand, branches, "pacbio")
    assert to_str(out) == to_str(cand)


def test_homopolymer_undercall_correction():
    # the nano model knows reads systematically under-call runs: branches
    # showing 4 most likely come from a true 5-run
    # corrections are capped at +-1 per pass; 6 with unanimous 4s moves
    # to 5
    cand = codes("CGT" + "A" * 6 + "TGC")
    branches = [codes("CGT" + "A" * 4 + "TGC") for _ in range(6)]
    out = polish_homopolymers(cand, branches, "nano")
    assert to_str(out) == "CGT" + "A" * 5 + "TGC"


def test_homopolymer_agreement_noop():
    cand = codes("CGTAAAATGC")
    branches = [cand.copy() for _ in range(6)]
    out = polish_homopolymers(cand, branches, "pacbio")
    assert to_str(out) == to_str(cand)


def test_dinucleotide_vote():
    cand = codes("GGC" + "AT" * 4 + "CGG")
    branches = [codes("GGC" + "AT" * 5 + "CGG") for _ in range(5)]
    out = fix_dinucleotide_repeats(cand, branches)
    assert to_str(out) == "GGC" + "AT" * 5 + "CGG"


def test_dinucleotide_noop_without_majority():
    cand = codes("GGC" + "AT" * 4 + "CGG")
    branches = [codes("GGC" + "AT" * 5 + "CGG"),
                codes("GGC" + "AT" * 3 + "CGG"),
                codes("GGC" + "AT" * 4 + "CGG"),
                codes("GGC" + "AT" * 4 + "CGG")]
    out = fix_dinucleotide_repeats(cand, branches)
    assert to_str(out) == to_str(cand)
