"""Host-side data pipeline (copies of s3prl_tpu/data/: CSV datasets, label
encoders and tokenizers, batch samplers, bucketed collation, WAV and FLAC
loading) and the prefetching loader that yields numpy batches."""

from .audio import load_wav  # noqa: F401
from .bpe import SubwordTokenizer, train_bpe  # noqa: F401
from .collate import Buckets, pad_collate  # noqa: F401
from .dataset import (  # noqa: F401
    DiarizationChunkDataset,
    SlotFillingDataset,
    Speech2TextDataset,
    UtteranceClassificationDataset,
    UtteranceMultiClassDataset,
)
from .encoder import (  # noqa: F401
    CategoryEncoder,
    CategoryEncoders,
    CharacterSlotTokenizer,
    CharacterTokenizer,
    PhonemeTokenizer,
    Tokenizer,
    WordTokenizer,
    load_tokenizer,
)
from .flac import flac_info, load_flac, write_flac  # noqa: F401
from .sampler import (  # noqa: F401
    BalancedWeightedSampler,
    FixedBatchSizeBatchSampler,
    GE2EBatchSampler,
)
