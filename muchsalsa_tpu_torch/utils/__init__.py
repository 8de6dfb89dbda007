from muchsalsa_tpu_torch.utils.seq import (
    reverse_complement,
    str_slice,
    sub_sequence,
    wrap_sequence,
)
from muchsalsa_tpu_torch.utils.timing import StageTimer

__all__ = [
    "reverse_complement",
    "str_slice",
    "sub_sequence",
    "wrap_sequence",
    "StageTimer",
]
