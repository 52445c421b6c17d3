"""Hub facade: ``s3prl_tpu_torch.hub.load(name, ...)`` on the card unless
``device="cpu"`` (port of s3prl_tpu/hub.py). The entries: HuBERT
(``hubert_large_ll60k``, ``hubert`` / ``hubert_base`` and its catalog
aliases), wav2vec 2.0 (``wav2vec2`` / ``wav2vec2_base_960``,
``wav2vec2_large_ll60k`` / ``wav2vec2_large_lv60_cv_swbd_fsh`` and the
Large aliases ``xlsr_53``, ``xls_r_300m``, ``xls_r_1b``, ``xls_r_2b``, ...),
data2vec (``data2vec`` / ``data2vec_base_960``, ``data2vec_large_ll60k``),
WavLM (``wavlm`` / ``wavlm_base``, ``wavlm_base_plus``, ``wavlm_large``) and
UniSpeech-SAT (``unispeech_sat`` / ``unispeech_sat_base``,
``unispeech_sat_base_plus``, ``unispeech_sat_large``), and the
parameter-free baseline front ends ``fbank``, ``fbank_no_cmvn``, ``mfcc``,
``spectrogram``, ``mel`` and ``linear`` (``device=`` only), the mel-domain
SSL models ``mockingjay``, ``tera``, ``audio_albert``, ``apc``, ``vq_apc``
and ``npc`` and the MOS predictors ``mos_prediction`` / ``mos_wav2vec2``,
``mos_apc`` and ``mos_tera`` (``dtype``, ``seed``, ``ckpt`` and
``device``); ``ckpt=`` loads a local checkpoint, ``options()`` lists the
names. Keywords: the int8 path's
opt-in fused projections ``qkv_fuse`` / ``full_fuse`` (HuBERT, wav2vec2)
and ``wavlm_fuse`` (WavLM), the front-end options ``int8_conv`` (int8),
``fused_conv`` and ``fused_midln``, and the pos-conv options
``fused_posconv`` and ``int8_posconv``. The trunk entries' upstreams also
serve SUPERB's fused weighted sum, ``apply_weighted``. Every entry is also
an attribute, as in the JAX package's hub (s3prl_tpu/hub.py:14-22):
``hub.hubert(...) == hub.load("hubert", ...)``."""

import functools

from .upstream.registry import load, options  # noqa: F401


def __getattr__(name):
    if name.startswith("_") or name not in options():
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return functools.partial(load, name)


def __dir__():
    return sorted(set(globals()) | set(options()))
