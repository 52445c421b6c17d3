"""Hub facade: ``s3prl_tpu_torch.hub.load("hubert_large_ll60k", ...)`` or
``load("wavlm_large", ...)``, on the card unless ``device="cpu"``, with the
int8 path's opt-in fused projections ``qkv_fuse`` / ``full_fuse`` (HuBERT)
and ``wavlm_fuse`` (WavLM) (port of s3prl_tpu/hub.py)."""

from .upstream.registry import load, options  # noqa: F401
