"""Hub facade: ``s3prl_tpu_torch.hub.load("hubert_large_ll60k", ...)``,
``load("wavlm_large", ...)`` or the Base models ``load("hubert_base" |
"hubert" | "wavlm_base" | "wavlm" | "wavlm_base_plus", ...)``, on the card
unless ``device="cpu"``, with the
int8 path's opt-in fused projections ``qkv_fuse`` / ``full_fuse`` (HuBERT)
and ``wavlm_fuse`` (WavLM), the front-end options ``int8_conv``
(HuBERT int8), ``fused_conv`` and ``fused_midln``, and the pos-conv options
``fused_posconv`` and ``int8_posconv`` (port of s3prl_tpu/hub.py)."""

from .upstream.registry import load, options  # noqa: F401
