from nanopore_tpu_torch.io.encoding import (
    encode,
    decode,
    reverse_complement,
    revcomp_codes,
    BASE_A,
    BASE_C,
    BASE_G,
    BASE_T,
    BASE_N,
)
from nanopore_tpu_torch.io.seqio import (
    fasta_read,
    fasta_write,
    fastq_read,
    fastq_write,
    read_fasta_dict,
    read_fastq_dict,
)
from nanopore_tpu_torch.io.sam import SamRecord, SamReader, SamWriter, CIG
from nanopore_tpu_torch.io.cigar import (
    exonerate_cigar_string,
    parse_exonerate_cigar,
    ExonerateCigar,
)
