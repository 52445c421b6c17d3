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
from .frame_probe import (  # noqa: F401
    FrameLabelDataset,
    FrameProbeExample,
    LibriPhone1Hidden,
    LibriPhoneConcat,
    LibriPhoneLinear,
    SpeakerLinearFrame,
    SpeakerLinearUtter,
    TimitPhone1Hidden,
    TimitPhoneConcat,
    TimitPhoneConvBank,
    TimitPhoneLinear,
    Voxceleb1FrameLevel,
)
from .qbe import QbeDTW, QbeExample  # noqa: F401
from .qbe_embedding import (  # noqa: F401
    QbeEmbeddingExample,
    QbeEmbeddingQuesst14,
    Sws2013Embedding,
)
from .hear import (  # noqa: F401
    HearBeijingOpera,
    HearCremaD,
    HearDcase2016Task2,
    HearESC50,
    HearEvent,
    HearEventExample,
    HearFSD,
    HearGSC5hr,
    HearGtzan,
    HearGtzanMusicSpeech,
    HearGunshot,
    HearLibriCount,
    HearMaestro,
    HearNsynth5hr,
    HearScene,
    HearStroke,
    HearTonic,
    HearVocal,
    HearVoxLingual,
)
from .mos import MosExample, MosPrediction  # noqa: F401
from .enhancement import SeExample, SuperbSE, SuperbSS  # noqa: F401
from .translation import StExample, SuperbST  # noqa: F401
