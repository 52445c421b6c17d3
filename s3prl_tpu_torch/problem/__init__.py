from .base import Problem  # noqa: F401
from .common import (  # noqa: F401
    CommonExample,
    CommonProblem,
    IcExample,
    SuperbER,
    SuperbIC,
    SuperbKS,
    SuperbSID,
)
from .asr import AsrExample, SuperbASR, SuperbPR, SuperbSF  # noqa: F401
from .asv import (  # noqa: F401
    AmsoftmaxSegmentExample,
    AsvExample,
    Ge2eExample,
    SuperbASV,
    Voxceleb2AMSoftmaxSegment,
    Voxceleb2GE2E,
)
from .diarization import SdExample, SuperbSD  # noqa: F401
