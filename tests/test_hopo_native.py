"""Native batched homopolymer/dinucleotide pass == the Python reference
implementation, bubble by bubble."""

import numpy as np
import pytest

from flye_jax import native
from flye_jax.polishing.homopolisher import (fix_dinucleotide_repeats,
                                             get_hopo_model,
                                             polish_homopolymers)


@pytest.mark.parametrize("platform", ["pacbio", "nano"])
def test_native_hopo_matches_python(platform):
    mod = native.get()
    if mod is None or not hasattr(mod, "polish_hopo_host"):
        pytest.skip("native module unavailable")
    rng = np.random.default_rng(3)
    bubbles = []
    for i in range(200):
        C = int(rng.integers(4, 60))
        cand = rng.integers(0, 4, C).astype(np.uint8)
        # plant homopolymer runs and dinucleotide repeats
        if rng.random() < 0.7:
            p = int(rng.integers(0, C))
            cand = np.concatenate([
                cand[:p],
                np.full(int(rng.integers(4, 9)), rng.integers(0, 4),
                        np.uint8), cand[p:]]).astype(np.uint8)
        if rng.random() < 0.4:
            p = int(rng.integers(0, len(cand)))
            ab = rng.integers(0, 4, 2).astype(np.uint8)
            while ab[0] == ab[1]:
                ab = rng.integers(0, 4, 2).astype(np.uint8)
            cand = np.concatenate([cand[:p], np.tile(ab, 4), cand[p:]])
        R = int(rng.integers(0, 9))
        branches = []
        for _ in range(R):
            br = cand.copy()
            # indels around runs
            for _ in range(int(rng.integers(0, 4))):
                q = int(rng.integers(0, len(br)))
                if rng.random() < 0.5:
                    br = np.delete(br, q)
                else:
                    br = np.insert(br, q, br[min(q, len(br) - 1)])
            branches.append(br.astype(np.uint8))
        bubbles.append((cand, branches))

    # python reference
    expect = []
    for cand, branches in bubbles:
        if branches:
            seq = polish_homopolymers(cand, branches, platform)
            seq = fix_dinucleotide_repeats(seq, branches)
        else:
            seq = cand
        expect.append(seq)

    # native batched
    todo = [(c, brs) for c, brs in bubbles if brs]
    obs_logp, genome_logp = get_hopo_model(platform)
    cand_off = np.zeros(len(todo) + 1, np.int64)
    bb_off = np.zeros(len(todo) + 1, np.int64)
    for i, (c, brs) in enumerate(todo):
        cand_off[i + 1] = cand_off[i] + len(c)
        bb_off[i + 1] = bb_off[i] + len(brs)
    cand_flat = np.concatenate([c for c, _ in todo])
    all_br = [br for _, brs in todo for br in brs]
    br_off = np.zeros(len(all_br) + 1, np.int64)
    br_off[1:] = np.cumsum([len(x) for x in all_br])
    br_flat = np.concatenate(all_br)
    out_flat_b, out_off_b = mod.polish_hopo_host(
        np.ascontiguousarray(cand_flat, np.uint8), cand_off,
        np.ascontiguousarray(br_flat, np.uint8), br_off, bb_off,
        np.ascontiguousarray(obs_logp, np.float64),
        np.ascontiguousarray(genome_logp, np.float64), 4, 3)
    out_flat = np.frombuffer(out_flat_b, np.uint8)
    out_off = np.frombuffer(out_off_b, np.int64)

    j = 0
    for (cand, branches), exp in zip(bubbles, expect):
        if not branches:
            continue
        got = out_flat[out_off[j]:out_off[j + 1]]
        np.testing.assert_array_equal(np.asarray(exp), got,
                                      err_msg=f"bubble {j}")
        j += 1
