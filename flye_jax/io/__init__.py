from flye_jax.io.fasta import (
    read_seq_file,
    write_fasta,
    codes_to_str,
    str_to_codes,
)
from flye_jax.io.seqstore import SeqId, SequenceStore
