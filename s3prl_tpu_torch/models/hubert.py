"""HuBERT configurations (port of s3prl_tpu/models/hubert.py). Extraction is
exactly the wav2vec2 trunk forward; the pretraining head is not ported."""

from .wav2vec2 import BASE, LARGE

HUBERT_BASE = BASE  # 12L/768, group-norm extractor, post-LN, normalize=False
HUBERT_LARGE = LARGE  # 24L/1024, layer-norm extractor, pre-LN, normalize=True
