"""The wav2vec2 family of s3prl_tpu_torch vs s3prl_tpu (CPU): wav2vec2,
data2vec, UniSpeech-SAT and WavLM without the gate or the bias.

Tiny trunks of each family (the real seven-layer conv stack at 64
channels, so that 400 samples are the first frame, as at full width; two
layers, C 128, H 2) are initialised in JAX, every leaf perturbed, and
carried to the port with `trunk_state_dict_from_jax` /
`wavlm_state_dict_from_jax`. The same numpy batch, with utterances of 1,
399, 400 and 401 samples beside longer ones, goes through
`Upstream.apply_standardized` of both packages. Tolerances: f32 per-layer
hidden states at atol 5e-4 over the valid frames (the ROADMAP bar,
tests/test_torch_parity.py:142); bf16 and int8 per-layer cosine > 0.999
over the valid frames, both packages on the same route (`kernels`: JAX's
Pallas kernels in interpret mode and the port's wrappers, whose plain
versions run on CPU tensors; `plain`: both module paths), as
tests/test_torch_port_base.py gates them; lengths exactly equal.

An utterance under 400 samples has no frame under the conv rule (kv_len
= 0) but one or two valid frames under the reference's length rule. Every
attention of the port gives such a row the mean of the T values (the JAX
module path's and its unpadded whole-T cells' value); JAX's padded cells
(K1, K4, K6, K7, K8 and K10: flash_attention.py:208-209, :309-310,
:631-632, :770-771, :862-865, :954-958) also weigh their tile padding
there, so the reduced-precision comparisons with the JAX kernels leave
out the frames of an utterance with no frame (`framed`);
`test_zero_frame_rows_match_the_f32_model` and
`test_attention_rows_with_no_key_are_the_mean_of_the_values` hold the
port's value for them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.kernels.flash_attention as jax_fa
import s3prl_tpu.models.transformer as jax_transformer
import s3prl_tpu.models.wavlm as jax_wavlm
import s3prl_tpu.upstream.registry as jax_registry
import s3prl_tpu_torch.kernels.flash_attention as port_fa
import s3prl_tpu_torch.models.transformer as port_transformer
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu.models.transformer import ConvPositionalEmbedding as JaxPosConv
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from s3prl_tpu.models.wav2vec2 import Wav2Vec2Trunk as JaxTrunk
from s3prl_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from s3prl_tpu.models.wavlm import WavLMModel as JaxWavLM
from s3prl_tpu.upstream.base import Upstream as JaxUpstream
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.convfe import conv_output_lengths
from s3prl_tpu_torch.models.transformer import ConvPositionalStack
from s3prl_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Trunk
from s3prl_tpu_torch.models.wavlm import WavLMConfig, WavLMModel
from s3prl_tpu_torch.upstream.base import Upstream
from s3prl_tpu_torch.upstream.convert import (trunk_state_dict_from_jax,
                                              wavlm_state_dict_from_jax)
from test_torch_port_slice import (  # noqa: F401 (fixtures)
    _batch, _cos, _jax_defaults, _layer_cosines, _valid_frames)

CONV = ((64, 10, 5), (64, 3, 2), (64, 3, 2), (64, 3, 2), (64, 3, 2), (64, 2, 2), (64, 2, 2))
WIDTH = dict(conv_feature_layers=CONV, encoder_layers=2, encoder_embed_dim=128,
             encoder_ffn_embed_dim=256, encoder_attention_heads=2, conv_pos=16,
             conv_pos_groups=4, dropout=0.0, attention_dropout=0.0, dropout_input=0.0)
CASES = {  # the families' distinguishing fields at the tiny width
    # wav2vec2-Large: layer-norm extractor, pre-LN, the conv rule
    "w2v2-large": dict(extractor_mode="layer_norm", layer_norm_first=True, normalize=True,
                       feat_pad_rule="conv"),
    # wav2vec2-Base: group-norm extractor, post-LN, the conv rule
    "w2v2-base": dict(extractor_mode="default", layer_norm_first=False, feat_pad_rule="conv"),
    # data2vec: layer-norm extractor, post-LN, the conv rule, the depth-5 stack (k = 4:
    # even, the trailing frame trimmed), the projection at equal widths
    "data2vec": dict(extractor_mode="layer_norm", layer_norm_first=False, normalize=True,
                     feat_pad_rule="conv", pos_conv_depth=5, conv_pos=20,
                     post_extract_proj_always=True,
                     conv_feature_layers=tuple((128, k, s) for _, k, s in CONV)),
}
WAVLM = {"no-gate": dict(gru_rel_pos=False), "no-bias": dict(relative_position_embedding=False)}
STRIDE = 320
LENS = [9600, 6401, 401, 400, 399, 1]  # T' = 30; 399 and 1 samples: no frame (kv_len 0)
# precision -> (JAX dtype, port dtype, flash, quantize)
PRECISION = {"f32": (jnp.float32, torch.float32, False, False),
             "bf16": (jnp.bfloat16, torch.bfloat16, True, False),
             "int8": (jnp.bfloat16, torch.bfloat16, True, True)}


def perturbed(params):
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.randn(*np.shape(a)).astype(np.float32),
        params)


def jax_init(model):
    """The JAX model's params (jitted init), every leaf perturbed."""
    init = jax.jit(lambda key, w, n: model.init(key, w, n, deterministic=True))
    return perturbed(init(jax.random.key(0), jnp.zeros((1, 3200)), jnp.asarray([3200]))["params"])


def configs(case):
    """(JAX config, port config) of a case: a trunk case or a WavLM one."""
    if case in WAVLM:
        kw = {**WIDTH, "extractor_mode": "default", **WAVLM[case]}
        return JaxWavLMConfig(**kw), WavLMConfig(**kw)
    kw = {**WIDTH, **CASES[case]}
    return JaxConfig(**kw), Wav2Vec2Config(**kw)


@pytest.fixture(scope="module")
def params():
    out = {}
    for case in (*CASES, *WAVLM):
        jcfg, _ = configs(case)
        out[case] = jax_init((JaxWavLM if case in WAVLM else JaxTrunk)(jcfg))
    return out


def run_jax(case, params, wavs, lens, precision="f32"):
    dtype, _, flash, quantize = PRECISION[precision]
    jcfg, _ = configs(case)
    model = (JaxWavLM if case in WAVLM else JaxTrunk)(jcfg, dtype=dtype, use_flash=flash,
                                                       quantize=quantize)
    apply = jax.jit(lambda v, w, n: model.apply(v, w, n, deterministic=True))
    up = JaxUpstream(name="tiny", params={"params": params[case]},
                     apply_fn=lambda v, w, n, train, rngs: apply(v, w, n),
                     num_layers=3, hidden_size=128, downsample_rate=STRIDE)
    hs, h_lens = up.apply_standardized(up.params, jnp.asarray(wavs), jnp.asarray(lens))
    return np.asarray(jnp.asarray(hs, jnp.float32)), np.asarray(h_lens)


def port_model(case, params, precision="f32", **options):
    _, dtype, flash, quantize = PRECISION[precision]
    _, cfg = configs(case)
    wavlm = case in WAVLM
    model = (WavLMModel if wavlm else Wav2Vec2Trunk)(cfg, dtype=dtype, use_flash=flash,
                                                      quantize=quantize, device="meta", **options)
    model.to_empty(device="cpu")
    convert = wavlm_state_dict_from_jax if wavlm else trunk_state_dict_from_jax
    model.load_state_dict(convert(params[case], cfg))
    return Upstream(name="tiny", model=model.eval(), num_layers=3, hidden_size=128,
                    downsample_rate=STRIDE)


def run_port(up, wavs, lens):
    hs, h_lens = up.apply_standardized(torch.from_numpy(wavs), torch.from_numpy(lens))
    return hs.float().numpy(), h_lens.numpy()


def assert_f32_close(got, want, got_lens, want_lens):
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    for layer in range(got.shape[0]):
        for b, n in enumerate(_valid_frames(got_lens, got.shape[2])):
            np.testing.assert_allclose(got[layer, b, :n], want[layer, b, :n], atol=5e-4,
                                       err_msg=f"layer {layer} utterance {b}")


def framed(lens, h_lens, conv=CONV):
    """h_lens with 0 for an utterance that has no frame under the conv rule
    (module docstring)."""
    frames = conv_output_lengths(torch.as_tensor(lens), conv).numpy()
    return np.where(frames > 0, h_lens, 0)


def kernels_on(monkeypatch, **thresholds):
    monkeypatch.setattr(jax_transformer, "_fused_block_available", lambda: True)
    monkeypatch.setattr(port_transformer, "_fused_block_available", lambda x: True)
    for name, value in thresholds.items():
        for fa in (jax_fa, port_fa):
            monkeypatch.setattr(fa, name, value)


def spy(monkeypatch, module, name):
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


# -- the trunks against the JAX package ----------------------------------------------

@pytest.mark.parametrize("case", [*CASES, *WAVLM])
def test_f32_matches_jax(params, case):
    """Every valid frame, those of the utterances with no frame included:
    both module paths give such a row the mean of the values."""
    wavs, lens = _batch(40, LENS)
    want, want_lens = run_jax(case, params, wavs, lens)
    got, got_lens = run_port(port_model(case, params), wavs, lens)
    assert got.shape == (3, 6, 30, 128)
    assert_f32_close(got, want, got_lens, want_lens)


REDUCED = [("w2v2-large", "int8", "kernels"), ("w2v2-large", "bf16", "kernels"),
           ("w2v2-large", "int8", "plain"), ("w2v2-base", "int8", "kernels"),
           ("data2vec", "int8", "kernels"), ("data2vec", "bf16", "kernels"),
           ("data2vec", "bf16", "plain"), ("no-gate", "int8", "kernels"),
           ("no-gate", "bf16", "plain"), ("no-bias", "int8", "kernels"),
           ("no-bias", "bf16", "kernels")]


@pytest.mark.parametrize("case,precision,route", REDUCED)
def test_reduced_precision_matches_jax(params, monkeypatch, case, precision, route):
    """`kernels`: JAX runs K1 / K4 (postnorm on the post-LN trunks), K2 /
    K5 and K3 (interpret mode), the port its wrappers; WavLM without the
    gate runs the plain biased attention in both (no kernel), without the
    bias K7 between the int8 projections (or K4's twin, K7, in bf16) and
    K2. `plain`: both module paths (K7 between the projections)."""
    if route == "kernels":
        kernels_on(monkeypatch)
    wavs, lens = _batch(41, LENS)
    want, want_lens = run_jax(case, params, wavs, lens, precision)
    got, got_lens = run_port(port_model(case, params, precision), wavs, lens)
    np.testing.assert_array_equal(got_lens, want_lens)
    assert got.shape == want.shape
    coss = _layer_cosines(got, want, framed(lens, got_lens))
    assert min(coss) > 0.999, coss


@pytest.mark.parametrize("case,precision,max_kernel_t,plain", [
    ("data2vec", "int8", 2048, "fused_qkv_attention_outproj_reference"),
    ("data2vec", "int8", 16, "online_flash_attention_reference"),
    ("w2v2-large", "bf16", 16, "online_flash_attention_reference")])
def test_long_routes_match_jax(params, monkeypatch, case, precision, max_kernel_t, plain):
    """T' = 30 frames with MAX_BLOCK_T = 8 in both packages: data2vec int8
    through the post-LN split (int8 QKV on raw x, K6, or with MAX_KERNEL_T
    = 16 K8, then the stock LN), wav2vec2 bf16 through K7's hand-over to K8,
    rows with kv_len = 0 among them."""
    kernels_on(monkeypatch, MAX_BLOCK_T=8, MAX_KERNEL_T=max_kernel_t)
    calls = spy(monkeypatch, port_fa, plain)
    wavs, lens = _batch(42, LENS)
    want, want_lens = run_jax(case, params, wavs, lens, precision)
    got, got_lens = run_port(port_model(case, params, precision), wavs, lens)
    assert len(calls) == 2  # one per layer
    np.testing.assert_array_equal(got_lens, want_lens)
    coss = _layer_cosines(got, want, framed(lens, got_lens))
    assert min(coss) > 0.999, coss


def test_zero_frame_rows_match_the_f32_model(params, monkeypatch):
    """The utterances with no frame (kv_len = 0: 399 samples and 1) on the
    int8 kernel route (K1, K2), the long one (K6) and beyond MAX_KERNEL_T
    (K8): finite, and their valid frames at the int8 gate (cosine > 0.999)
    against the port's f32 module path, whose rows are the mean of the
    values, as the JAX module path's."""
    wavs, lens = _batch(43, LENS)
    want, _ = run_port(port_model("data2vec", params), wavs, lens)
    for thresholds in ({}, {"MAX_BLOCK_T": 8}, {"MAX_BLOCK_T": 8, "MAX_KERNEL_T": 16}):
        with monkeypatch.context() as m:
            kernels_on(m, **thresholds)
            got, h_lens = run_port(port_model("data2vec", params, "int8"), wavs, lens)
        assert np.isfinite(got).all()
        coss = _layer_cosines(got[:, 4:], want[:, 4:], h_lens[4:])
        assert min(coss) > 0.999, (thresholds, coss)


@pytest.mark.parametrize("kernel", ["K7", "K8", "K9", "K10", "K17"])
def test_attention_rows_with_no_key_are_the_mean_of_the_values(kernel):
    """Each attention's plain version gives a row with kv_len = 0 the mean
    of its T values (the card's kernels are held to these on the card,
    tests/test_torch_port_cuda.py); K9 and K17, whose JAX cells run the
    whole unpadded row (flash_attention.py:71-89, :994-1011), give the JAX
    value in interpret mode."""
    B, H, T, Dh = 3, 2, 40, 64
    rng = np.random.RandomState(47)
    q, k, v = (torch.from_numpy(rng.randn(B, H, T, Dh).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.randn(H, T, T).astype(np.float32))
    gate = torch.from_numpy(rng.uniform(1, 3, (B, H, T)).astype(np.float32))
    kv = torch.tensor([T, 0, 17], dtype=torch.int32)
    if kernel == "K7":
        qkv = torch.cat([x.transpose(1, 2).reshape(B, T, H * Dh) for x in (q, k, v)], -1)
        got = port_fa.fused_qkv_attention(qkv, kv, H).view(B, T, H, Dh).transpose(1, 2)
    else:
        fn = {"K8": port_fa.online_flash_attention, "K17": port_fa.flash_attention,
              "K9": lambda *a: port_fa.gated_bias_attention(*a[:3], bias, gate, a[3]),
              "K10": lambda *a: port_fa.gated_online_flash_attention(*a[:3], bias, gate, a[3])}
        got = fn[kernel](q, k, v, kv)
    torch.testing.assert_close(got[1], v[1].mean(1, keepdim=True).expand(H, T, Dh),
                               atol=1e-5, rtol=0)
    if kernel in ("K9", "K17"):
        jq, jk, jv, jkv = (jnp.asarray(x.numpy()) for x in (q, k, v, kv))
        want = (jax_fa.gated_bias_attention(jq, jk, jv, jnp.asarray(bias.numpy()),
                                            jnp.asarray(gate.numpy()), jkv, interpret=True)
                if kernel == "K9" else jax_fa.flash_attention(jq, jk, jv, jkv, interpret=True))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_conv_length_rule_matches_jax(params):
    """feat_lens under the conv rule: exact conv arithmetic (0 frames below
    400 samples, 1 at 400 and 401), as the JAX trunk counts them; the block
    rule of the same batch counts one frame more at the edges."""
    wavs, lens = _batch(44, LENS)
    jcfg, cfg = configs("w2v2-large")
    _, want = jax.jit(lambda v, w, n: JaxTrunk(jcfg).apply(v, w, n, deterministic=True))(
        {"params": params["w2v2-large"]}, jnp.asarray(wavs), jnp.asarray(lens))
    model = port_model("w2v2-large", params).model
    with torch.no_grad():
        _, got = model(torch.from_numpy(wavs), torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [29, 19, 1, 1, 0, 0]
    assert conv_output_lengths(torch.tensor([399, 400, 401, 719, 720])).tolist() == [0, 1, 1,
                                                                                    1, 2]
    block = Wav2Vec2Trunk(dataclasses.replace(cfg, feat_pad_rule="block"), device="meta")
    assert block.cfg.feat_pad_rule == "block"


@pytest.mark.parametrize("conv_pos,dtype,atol", [(20, "f32", 2e-5), (95, "f32", 2e-5),
                                                 (20, "bf16", 0.07)])
def test_depth5_stack_matches_jax(conv_pos, dtype, atol):
    """data2vec's pos-conv stack alone (transformer.py:49-68), five blocks of
    grouped conv (k = 4: the trailing frame trimmed; k = 19 at the published
    conv_pos 95), affine-free f32 LN, GELU, against the JAX module with the
    same f32 parameters: f32 at atol 2e-5, bf16 (the conv in bf16, the f32
    parameters cast at use) within a bf16 step of values near 4."""
    C, G, T, depth = 128, 4, 37, 5
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rng = np.random.RandomState(45)
    x = rng.randn(2, T, C).astype(np.float32)
    mod = JaxPosConv(C, conv_pos, G, depth, jdt)
    jparams = perturbed(mod.init(jax.random.key(1), jnp.zeros((1, T, C)))["params"])
    want = np.asarray(mod.apply({"params": jparams}, jnp.asarray(x, jdt)).astype(jnp.float32))
    stack = ConvPositionalStack(C, conv_pos, G, depth)
    k = max(3, conv_pos // depth)
    assert stack[0][0].kernel_size == (k,) and len(stack) == depth
    stack.load_state_dict({
        f"{i}.0.{name}": torch.from_numpy(np.ascontiguousarray(
            jparams[f"conv_{i}"][key].transpose(2, 1, 0) if name == "weight"
            else jparams[f"conv_{i}"][key]))
        for i in range(depth) for name, key in (("weight", "kernel"), ("bias", "bias"))})
    assert stack[0][0].weight.dtype == torch.float32
    with torch.no_grad():
        got = stack(torch.from_numpy(x).to(tdt)).float().numpy()
    assert got.shape == want.shape == (2, T, C)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.fixture
def no_cuda(monkeypatch):
    """Any step that reaches CUDA fails the test."""
    monkeypatch.setattr(torch.cuda, "_lazy_init", lambda: pytest.fail("CUDA was touched"))


@pytest.mark.parametrize("option", ["fused_posconv", "int8_posconv"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_posconv_options_refused_on_the_stack(no_cuda, option, device):
    """The depth-5 stack runs no kernel (the JAX stack returns before the
    pos-conv switch, transformer.py:49-68): both pos-conv options raise at
    load, naming the depth, on the CPU and for the card, before CUDA."""
    with pytest.raises(ValueError, match=f"{option} cannot take effect: the depth-5"):
        hub.load("data2vec_large_ll60k", dtype=torch.bfloat16, flash=True, device=device,
                 **{option: True})
    with pytest.raises(ValueError, match=f"{option} cannot take effect: the depth-5"):
        Wav2Vec2Trunk(configs("data2vec")[1], device="meta", **{option: True})


@pytest.mark.parametrize("case", list(WAVLM))
def test_wavlm_fuse_refused_without_gate_or_bias(no_cuda, case):
    """JAX gates K11 on the gate and the bias (wavlm.py:175-179): the
    option raises at load for either model, before CUDA is touched."""
    _, cfg = configs(case)
    with pytest.raises(ValueError, match="wavlm_fuse cannot take effect"):
        WavLMModel(cfg, torch.bfloat16, use_flash=True, quantize=True, device="cuda",
                   wavlm_fuse=True)


def test_bias_table_cached_in_inference_mode_serves_autograd(params):
    """The bucket table cached by a forward under `apply_standardized`
    (inference mode) serves a later forward that autograd tracks at the
    same T (it was an inference tensor, which autograd refuses to save)."""
    up = port_model("no-gate", params)
    wavs, lens = (torch.from_numpy(a) for a in _batch(48, [3200, 1601]))
    up.apply_standardized(wavs, lens)
    model = up.model.train()
    hs, _ = model(wavs, lens)
    hs[-1].sum().backward()
    assert model.encoder.layers[0].self_attn.relative_attention_bias.weight.grad is not None


def test_wavlm_variants_keep_microsoft_keys(params):
    """No gate: no grep_linear / grep_a, the table on layer 0; no bias: no
    table; the state_dict round-trips the JAX tree bit for bit."""
    for case in WAVLM:
        _, cfg = configs(case)
        sd = port_model(case, params).model.state_dict()
        assert any("grep" in key for key in sd) == cfg.gated
        has_table = "encoder.layers.0.self_attn.relative_attention_bias.weight" in sd
        assert has_table == cfg.relative_position_embedding
        back = wavlm_state_dict_from_jax(params[case], cfg)
        assert sd.keys() == back.keys()
        for key, value in sd.items():
            assert torch.equal(value, back[key]), key


# -- the registry's entries ------------------------------------------------------------

ENTRIES = {  # entry -> (JAX config, port config, name), the unpatched full configurations
    "wav2vec2": ("W2V2_BASE", "wav2vec2"), "wav2vec2_base_960": ("W2V2_BASE", "wav2vec2"),
    "wav2vec2_large_ll60k": ("W2V2_LARGE", "wav2vec2_large"),
    "wav2vec2_large_lv60_cv_swbd_fsh": ("W2V2_LARGE", "wav2vec2_large"),
    "data2vec": ("DATA2VEC_BASE", "data2vec"), "data2vec_base_960": ("DATA2VEC_BASE", "data2vec"),
    "data2vec_large_ll60k": ("DATA2VEC_LARGE", "data2vec_large"),
    "unispeech_sat": ("WAVLM_BASE", "unispeech_sat"),
    "unispeech_sat_base": ("WAVLM_BASE", "unispeech_sat"),
    "unispeech_sat_base_plus": ("WAVLM_BASE_PLUS", "unispeech_sat_base_plus"),
    "unispeech_sat_large": ("WAVLM_LARGE", "unispeech_sat_large"),
    **{alias: ("W2V2_LARGE", "wav2vec2_large") for alias in (
        "wav2vec2_large_960", "wav2vec2_large_voxpopuli_100k", "xlsr_53", "xls_r_300m",
        "xls_r_1b", "xls_r_2b")},
    **{alias: ("BASE", "hubert") for alias in (
        "hubert_base_robust_mgr", "mhubert_base_vp_en_es_fr_it3", "contentvec",
        "contentvec_km100", "contentvec_km500", "ms_hubert")},
}


def captured(monkeypatch, module, *factories):
    """Replaces module's upstream factories by ones that record (name, cfg)."""
    seen = []
    for factory in factories:
        monkeypatch.setattr(module, factory, lambda name, cfg, **kw: seen.append((name, cfg)))
    return seen


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_entry_builds_the_jax_configuration(monkeypatch, entry):
    """Each new entry and alias hands its factory the JAX entry's name and
    configuration, field for field (registry.py:211-229, :481-520,
    :693-716, :1524-1528)."""
    jax_seen = captured(monkeypatch, jax_registry, "_trunk_upstream", "_wavlm_upstream")
    port_seen = captured(monkeypatch, port_registry, "_trunk_upstream")
    jax_registry.load(entry)
    hub.load(entry)
    (jname, jcfg), (pname, pcfg) = jax_seen[0], port_seen[0]
    assert pname == jname == ENTRIES[entry][1]
    assert type(pcfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
