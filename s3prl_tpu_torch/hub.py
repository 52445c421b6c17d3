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
``device``), the wav2vec2-style zoo (``wav2vec2_conformer*``,
``espnet_hubert*``, ``distilhubert``, ``lighthubert*``,
``multires_hubert*``), and the conv, recurrent and windowed families on
stock ops: ``wav2vec`` / ``wav2vec_large``, ``vq_wav2vec`` /
``vq_wav2vec_gumbel``, ``vq_wav2vec_kmeans`` (``dtype`` f32 or bf16),
``cpc`` / ``modified_cpc``, ``decoar``, ``decoar_layers`` (f32),
``decoar2`` (f32 or bf16, its depth from ``ckpt``), the eight ``byol_a*``
/ ``byol_s*`` names (f32; ``ckpt``, ``seed``, ``device``), the small
front ends ``wav``, ``log_stft`` / ``stft_mag`` and ``example`` /
``customized_upstream`` (``device`` only), and the rest of the zoo on stock
ops: the AST family ``ast`` / ``ssast_*`` / ``mae_ast*`` and the 12
``passt*`` names (f32 or bf16), ``vggish``, ``vq_wav2vec_kmeans_roberta``
/ ``discretebert`` (``ckpt``, ``frontend_ckpt``), ``pase_plus`` (f32 or
bf16; a ``ckpt`` raises), ``spec_augment`` (``seed``, ``device``) and the
``hf_*`` entries on the port's wav2vec2 trunk (``ckpt`` a local Hugging
Face directory; K3 in the extractor). The reference hubconf's names
on top (`upstream/aliases.py`): the generic loaders ``<family>_local`` /
``_url`` / ``_custom`` (``ckpt`` required, a local path; a URL raises),
the named checkpoint variants (``tera_960hr``, ``distilhubert_base``,
``apc_360hr``, ``baseline`` -> ``fbank``, ...) and ``baseline_local``
(``model_config=`` a yaml). ``ckpt=`` loads a local checkpoint,
``options(only_registered_ckpt=False)`` lists the names (the JAX hub's
209; without the generic loaders when True). A keyword that an entry's model cannot use
raises at load. Keywords: the int8 path's
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
