"""Host-side data pipeline (copies of s3prl_tpu/data/: CSV datasets, label
encoders, batch samplers, bucketed collation) and the prefetching loader
that yields numpy batches."""

from .audio import load_wav  # noqa: F401
from .collate import Buckets, pad_collate  # noqa: F401
from .encoder import CategoryEncoder, CategoryEncoders  # noqa: F401
from .sampler import BalancedWeightedSampler, FixedBatchSizeBatchSampler  # noqa: F401
