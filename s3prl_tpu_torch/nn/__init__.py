from .heads import (  # noqa: F401
    POOLINGS,
    AttentiveStatisticsPooling,
    ConvBankHead,
    FrameConcatLinear,
    FrameLevel,
    FrameLevelLinear,
    MeanPooling,
    MeanPoolingLinear,
    RNNEncoder,
    SelfAttentivePooling,
    TemporalStatisticsPooling,
    UtteranceLevel,
)
from .speaker import (  # noqa: F401
    TDNN,
    SapSpeakerHead,
    SuperbDiarizationModel,
    SuperbXvector,
    XVectorBackbone,
)
from .upstream import Featurizer, SUpstream, UpstreamDownstreamModel, init_params  # noqa: F401
from .beam_decoder import BeamDecoder  # noqa: F401
