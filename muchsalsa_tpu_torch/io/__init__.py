from muchsalsa_tpu_torch.io.registry import Registry
from muchsalsa_tpu_torch.io.fasta import SequenceStore
from muchsalsa_tpu_torch.io.paf import PafRecords, read_paf
from muchsalsa_tpu_torch.io.output import OutputWriter

__all__ = ["Registry", "SequenceStore", "PafRecords", "read_paf", "OutputWriter"]
