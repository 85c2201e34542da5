import gzip

import numpy as np
import pytest

from flye_jax.io import (SequenceStore, SeqId, codes_to_str, read_seq_file,
                         str_to_codes, write_fasta)
from flye_jax.io.fasta import reverse_complement
from flye_jax.io.seqstore import compute_nx


def test_codes_roundtrip():
    s = "ACGTACGTTTGGCCA"
    assert codes_to_str(str_to_codes(s)) == s


def test_sanitize_ambiguous():
    codes = str_to_codes("ACGNRYT")
    assert codes_to_str(codes) == "ACGAAAT"


def test_reverse_complement():
    assert codes_to_str(reverse_complement(str_to_codes("AACGT"))) == "ACGTT"


def test_fasta_roundtrip(tmp_path):
    recs = [("seq1", "ACGT" * 40), ("seq2", "TTTTGGGG")]
    path = str(tmp_path / "t.fasta")
    write_fasta([(n, str_to_codes(s)) for n, s in recs], path)
    back = read_seq_file(path)
    assert [(n, codes_to_str(c)) for n, c in back] == recs


def test_fastq_gz(tmp_path):
    path = str(tmp_path / "t.fastq.gz")
    with gzip.open(path, "wb") as f:
        f.write(b"@r1 extra stuff\nACGTAA\n+\nIIIIII\n@r2\nGGCC\n+\nIIII\n")
    back = read_seq_file(path)
    assert [(n, codes_to_str(c)) for n, c in back] == [("r1", "ACGTAA"),
                                                       ("r2", "GGCC")]


def test_seqid_encoding():
    sid = SeqId(4)
    assert sid.index == 2 and sid.is_forward
    assert sid.rc == 5 and not sid.rc.is_forward
    assert sid.rc.rc == sid
    assert SeqId(5).fwd == 4


def test_store_strands():
    store = SequenceStore()
    a = store.add("a", str_to_codes("AACGT"))
    b = store.add("b", str_to_codes("GGGG"))
    assert codes_to_str(store.get(a)) == "AACGT"
    assert codes_to_str(store.get(a.rc)) == "ACGTT"
    assert store.length(a) == store.length(a.rc) == 5
    assert store.name(b.rc) == "b"
    assert store.total_length == 9
    # substr on both strands
    assert codes_to_str(store.get_sub(a, 1, 4)) == "ACG"
    assert codes_to_str(store.get_sub(a.rc, 1, 4)) == "CGT"
    np.testing.assert_array_equal(store.get(a.rc)[1:4],
                                  store.get_sub(a.rc, 1, 4))


def test_padded_batch():
    store = SequenceStore()
    a = store.add("a", str_to_codes("AACGT"))
    batch, lens = store.padded_batch([a, a.rc], pad_to=8)
    assert batch.shape == (2, 8)
    assert list(lens) == [5, 5]
    assert codes_to_str(batch[1][:5]) == "ACGTT"


def test_nx():
    lens = np.array([10, 20, 30, 40])
    assert compute_nx(lens, 0.5) == 30
    assert compute_nx(lens, 0.9) == 10
    assert compute_nx(lens, 0.5, genome_size=200) == 10
