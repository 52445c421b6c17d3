from .common import accuracy, cer, edit_distance, per, ter, wer  # noqa: F401
from .slot_filling import (  # noqa: F401
    slot_edit_f1_full,
    slot_edit_f1_part,
    slot_type_f1,
    slot_value_cer,
    slot_value_wer,
)
