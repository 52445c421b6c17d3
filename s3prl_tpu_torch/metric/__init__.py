from .common import (  # noqa: F401
    accuracy,
    cer,
    compute_eer,
    compute_minDCF,
    edit_distance,
    per,
    ter,
    wer,
)
from .diarization import calc_diarization_error, der_from_accumulators  # noqa: F401
from .slot_filling import (  # noqa: F401
    slot_edit_f1_full,
    slot_edit_f1_part,
    slot_type_f1,
    slot_value_cer,
    slot_value_wer,
)
