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
