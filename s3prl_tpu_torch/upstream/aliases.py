"""The reference hubconf's name surface on top of the registry (port of
s3prl_tpu/upstream/aliases.py).

Per family the reference's generic loaders ``<family>_local(ckpt=path)``,
``<family>_url(ckpt=url)`` and ``<family>_custom(ckpt=path-or-url)``
(s3prl/upstream/hubert/hubconf.py:30-82): ``ckpt`` is required, a local
path goes to the family's factory, and a URL raises, as ``download=`` does
(the JAX package resolves it through its download cache); the named
checkpoint variants, each its family's factory (the architecture comes
from the checkpoint); ``baseline_local``'s yaml config loader.
"""

from __future__ import annotations

from .registry import _REGISTRY, NOT_DOWNLOADED


def _ckpt_loader(entry_name: str, family: str):
    """A ``<family>_{local,url,custom}`` entry: ckpt required, a local path."""

    def entry(ckpt=None, **kwargs):
        if ckpt is None:
            raise ValueError(
                f"{entry_name} requires ckpt= (path or URL); use '{family}' "
                f"for the random-init default"
            )
        if isinstance(ckpt, str) and "://" in ckpt:
            raise NotImplementedError(f"{entry_name}: a URL ckpt {NOT_DOWNLOADED}")
        return _REGISTRY[family](ckpt=ckpt, **kwargs)

    entry.__name__ = entry_name
    entry.__doc__ = (f"Load '{family}' from a local checkpoint (reference: "
                     f"s3prl/upstream/{family}/hubconf.py generic loaders).")
    return entry


# family -> which generic loader names the reference defines for it
_GENERIC_LOADERS = {
    "apc": ("local", "url"),
    "audio_albert": ("local", "url"),
    "cpc": ("local", "url"),
    "data2vec": ("custom", "local", "url"),
    "decoar": ("custom", "local", "url"),
    "decoar2": ("custom", "local", "url"),
    "decoar_layers": ("custom", "local", "url"),
    "distiller": ("local", "url"),
    "hubert": ("custom", "local", "url"),
    "lighthubert": ("local", "url"),
    "mae_ast": ("local", "url"),
    "mockingjay": ("local", "url"),
    "mos_wav2vec2": ("local", "url"),
    "mos_apc": ("local", "url"),
    "mos_tera": ("local", "url"),
    "multires_hubert": ("custom", "local"),
    "npc": ("local", "url"),
    "spec_augment": ("local", "url"),
    "tera": ("local", "url"),
    "unispeech_sat": ("local", "url"),
    "vq_wav2vec": ("custom",),
    "wav2vec2": ("custom", "local", "url"),
    "wav2vec": ("custom", "local", "url"),
    "wavlm": ("local", "url"),
}

for _family, _kinds in _GENERIC_LOADERS.items():
    for _kind in _kinds:
        _name = f"{_family}_{_kind}"
        if _name not in _REGISTRY:
            _REGISTRY[_name] = _ckpt_loader(_name, _family)


# named checkpoint variants: alias -> family factory
_NAMED_VARIANTS = {
    # mockingjay/hubconf.py
    "mockingjay_100hr": "mockingjay",
    "mockingjay_960hr": "mockingjay",
    "mockingjay_origin": "mockingjay",
    "mockingjay_logMelBase_T_AdamW_b32_1m_960hr": "mockingjay",
    "mockingjay_logMelBase_T_AdamW_b32_1m_960hr_drop1": "mockingjay",
    "mockingjay_logMelBase_T_AdamW_b32_1m_960hr_seq3k": "mockingjay",
    "mockingjay_logMelBase_T_AdamW_b32_200k_100hr": "mockingjay",
    "mockingjay_logMelLinearLarge_T_AdamW_b32_500k_360hr_drop1": "mockingjay",
    # tera/hubconf.py
    "tera_100hr": "tera",
    "tera_960hr": "tera",
    "tera_fbankBase_T_F_AdamW_b32_200k_100hr": "tera",
    "tera_logMelBase_T_F_AdamW_b32_1m_960hr": "tera",
    "tera_logMelBase_T_F_AdamW_b32_1m_960hr_drop1": "tera",
    "tera_logMelBase_T_F_AdamW_b32_1m_960hr_seq3k": "tera",
    "tera_logMelBase_T_F_AdamW_b32_200k_100hr": "tera",
    "tera_logMelBase_T_F_M_AdamW_b32_1m_960hr_drop1": "tera",
    "tera_logMelBase_T_F_M_AdamW_b32_200k_100hr": "tera",
    # audio_albert/hubconf.py
    "audio_albert_960hr": "audio_albert",
    "audio_albert_logMelBase_T_share_AdamW_b32_1m_960hr_drop1": "audio_albert",
    # distiller/hubconf.py
    "distilhubert_base": "distilhubert",
    # wav2vec2/hubconf.py s2st finetuned entries
    "wav2vec2_base_s2st_en_librilight": "wav2vec2",
    "wav2vec2_base_s2st_es_voxpopuli": "wav2vec2",
    "wav2vec2_conformer_large_s2st_en_librilight": "wav2vec2_conformer",
    "wav2vec2_conformer_large_s2st_es_voxpopuli": "wav2vec2_conformer",
    # baseline/hubconf.py + example/hubconf.py + log_stft/hubconf.py
    "baseline": "fbank",
    "customized_upstream": "example",
    "stft_mag": "log_stft",
}

for _alias, _family in _NAMED_VARIANTS.items():
    if _alias not in _REGISTRY:
        _REGISTRY[_alias] = _REGISTRY[_family]


def _config_loader(entry_name: str, family: str):
    """``baseline_local(model_config=yaml)``: the yaml's ``name`` entry (the
    family when absent or unknown) with its ``kwargs`` (reference:
    s3prl/upstream/baseline/hubconf.py:10-24)."""

    def entry(model_config=None, **kwargs):
        if model_config is None:
            return _REGISTRY[family](**kwargs)
        import yaml

        with open(model_config) as f:
            conf = yaml.safe_load(f) or {}
        kwargs.update(conf.get("kwargs", {}))
        name = conf.get("name", family)
        return _REGISTRY.get(name, _REGISTRY[family])(**kwargs)

    entry.__name__ = entry_name
    return entry


_REGISTRY["baseline_local"] = _config_loader("baseline_local", "fbank")


# pase's generic loaders are pase_plus itself (aliases.py:153-157): without
# ckpt they build the random-init model, with one they raise as it does
for _name in ("pase_local", "pase_url"):
    _REGISTRY[_name] = _REGISTRY["pase_plus"]
