"""The registry's new entries of s3prl_tpu_torch vs s3prl_tpu (CPU), at a
tiny width: wav2vec2, data2vec, UniSpeech-SAT and an alias.

Each entry's factory reads its configuration from a module constant; both
packages' constants are patched to the same tiny configuration (the widths
of tests/test_torch_port_w2v2.py, each family's other fields kept), the
JAX entry is loaded (random weights, every leaf perturbed) and its weights
carried to `hub.load(entry, device="cpu")` with the converters. f32
per-layer hidden states at atol 5e-4 over the valid frames (the ROADMAP
bar), on the batch with utterances of no frame. The full configurations
are held field for field in tests/test_torch_port_w2v2.py
(`test_entry_builds_the_jax_configuration`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import s3prl_tpu.models.wavlm as jax_wavlm
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.wavlm import WavLMModel
from s3prl_tpu_torch.upstream.convert import (trunk_state_dict_from_jax,
                                              wavlm_state_dict_from_jax)
from test_torch_port_slice import _batch, _jax_defaults  # noqa: F401 (fixture)
from test_torch_port_w2v2 import CASES, LENS, WIDTH, assert_f32_close, perturbed, run_port


TINY_ENTRIES = {  # one entry a factory -> the registry constants it reads
    "wav2vec2": "W2V2_BASE", "wav2vec2_large_ll60k": "W2V2_LARGE",
    "data2vec": "DATA2VEC_BASE", "data2vec_large_ll60k": "DATA2VEC_LARGE",
    "unispeech_sat_large": "WAVLM_LARGE", "contentvec": None}


@pytest.mark.parametrize("entry", list(TINY_ENTRIES))
def test_entry_at_tiny_width_matches_jax(monkeypatch, entry):
    """hub.load(entry, device="cpu") at a tiny width (its configuration with
    the widths of this file, the family's fields kept) builds, and with
    the JAX entry's weights gives the JAX entry's hidden states at f32
    (atol 5e-4) on the batch with utterances of no frame."""
    const = TINY_ENTRIES[entry]
    if const is None:  # an alias: the factory of hubert_base
        assert port_registry._REGISTRY[entry] is port_registry.hubert_base
        const = "HUBERT_BASE"
    wavlm = const.startswith("WAVLM")
    shrink = {**WIDTH, "conv_pos": 20 if "DATA2VEC" in const else 16}
    if "DATA2VEC" in const:
        shrink["conv_feature_layers"] = CASES["data2vec"]["conv_feature_layers"]
    port_cfg = dataclasses.replace(getattr(port_registry, const), **shrink)
    jax_src = jax_wavlm if wavlm else jax_registry
    jax_const = "BASE" if const == "HUBERT_BASE" else const
    jax_cfg = dataclasses.replace(getattr(jax_src, jax_const), **shrink)
    monkeypatch.setattr(port_registry, const, port_cfg)
    monkeypatch.setattr(jax_src, jax_const, jax_cfg)
    jup = jax_registry.load(entry)
    jparams = perturbed(jup.params["params"])
    up = hub.load(entry, device="cpu")
    assert isinstance(up.model, WavLMModel) == wavlm
    assert hasattr(up, "apply_weighted") != wavlm  # the trunk entries only, as in JAX
    convert = wavlm_state_dict_from_jax if wavlm else trunk_state_dict_from_jax
    up.model.load_state_dict(convert(jparams, port_cfg))
    wavs, lens = _batch(46, LENS)
    hs, h_lens = jup.apply_standardized({"params": jparams}, jnp.asarray(wavs),
                                        jnp.asarray(lens))
    got, got_lens = run_port(up, wavs, lens)
    assert_f32_close(got, np.asarray(hs), got_lens, np.asarray(h_lens))
