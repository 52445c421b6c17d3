from .base import Task  # noqa: F401
from .utterance_classification import (  # noqa: F401
    FrameClassificationTask,
    UtteranceClassificationTask,
    UtteranceMultiClassClassificationTask,
)
from .speech2text_ctc import SlotFillingCTCTask, Speech2TextCTCTask  # noqa: F401
from .speaker_verification import (  # noqa: F401
    Ge2eVerificationTask,
    SpeakerVerificationTask,
    amsoftmax_logits,
    ge2e_loss,
)
from .diarization import DiarizationPITTask  # noqa: F401
from .qbe_embedding import QbeEmbedder, QbeEmbeddingTask  # noqa: F401
from .hear import (  # noqa: F401
    EventPredictionTask,
    ScenePredictionTask,
    d_prime,
    mean_average_precision,
    roc_auc,
)
from .mos_prediction import MosDownstreamModule, MosPredictionTask  # noqa: F401
from .enhancement import EnhancementTask, SeparationTask, si_sdr  # noqa: F401
from .speech_translation import SpeechTranslationTask  # noqa: F401
from .voice_conversion import VoiceConversionTask, mcd  # noqa: F401
from .hubert_pretrain import HubertPretrainTask  # noqa: F401
from .data2vec_pretrain import Data2VecPretrainTask, StudentTeacher  # noqa: F401
from .distiller_pretrain import DistillerPretrainTask  # noqa: F401
from .reconstruction import (  # noqa: F401
    AutoregressiveReconstructionTask,
    MaskedReconstructionTask,
    NpcReconstructionTask,
    SpecAugReconstructionTask,
)
from .dump_feature import dump_features  # noqa: F401
