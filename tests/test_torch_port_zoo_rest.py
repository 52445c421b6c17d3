"""VGGish, the vq-wav2vec k-means -> RoBERTa pipeline, PASE+ and SpecAugment
of s3prl_tpu_torch vs s3prl_tpu (CPU).

Each JAX entry's random variables, every leaf moved by 0.05 N(0, 1) (0.005
for VGGish, whose 12,288-wide fc1 would blow a 0.05 move up; BatchNorm
variances |v| + 0.5), go to the port through its `*_state_dict_from_jax`
and both registries run the same padded batch. VGGish, PASE+ and
SpecAugment at their published widths; RoBERTa (two or four post-LN layers
at 32 wide, 8 positions a bucket, so a clip spans buckets) over
`test_torch_port_wav2vec1`'s tiny k-means vq-wav2vec (three extractor convs
at stride 40, 16 codes a group; z and the aggregator at the pipeline's
fixed 512), both configs patched in both packages with tiny-default
subclasses. Tolerances: the states at atol 5e-4 in f32
(tests/test_torch_parity.py:142), but PASE+'s at 5e-4 of each state's
largest magnitude: its QRNN's fo-pooling is a scan whose summation tree
differs from JAX's ``associative_scan`` (`linear_scan` against it at T =
1,000 holds 2e-6 relative, stated below), and its BatchNorms magnify the
rounding of the convs; lengths equal. SpecAugment's eval features by
`test_torch_port_audio`'s quantile rule; its masks equal to JAX's given
JAX's bands.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import s3prl_tpu.models.roberta as jax_roberta
import s3prl_tpu.models.wav2vec1 as jax_w2v1
import s3prl_tpu_torch.upstream.registry as port_registry
from s3prl_tpu import hub as jax_hub
from s3prl_tpu.nn import specaug as jax_specaug
from s3prl_tpu.upstream import convert as jax_convert
from s3prl_tpu_torch import hub
from s3prl_tpu_torch.models.pase import linear_scan
from s3prl_tpu_torch.models.roberta import RobertaConfig, RobertaModel
from s3prl_tpu_torch.models.wav2vec1 import Wav2Vec1Config
from s3prl_tpu_torch.nn import specaug
from s3prl_tpu_torch.upstream.convert_zoo import (pase_state_dict_from_jax,
                                                  roberta_state_dict_from_jax,
                                                  vggish_state_dict_from_jax,
                                                  wav2vec1_state_dict_from_jax)
from test_torch_port_audio import DEGENERATE, LENS, _batch, quantile_rule
from test_torch_port_mel_ssl import with_defaults
from test_torch_port_patch_transformers import perturbed, run_both, waves

# the JAX pipeline fixes vq_dim 512: z and the aggregator's states are 512 wide
FEAT = ((32, 10, 5), (32, 8, 4), (512, 4, 2))
AGG = ((512, 2, 1), (512, 3, 1), (512, 4, 1))
TINY_W2V = dict(conv_feature_layers=FEAT, conv_aggregator_layers=AGG, vq_vars=16)
TINY_ROBERTA = dict(hidden_size=32, num_heads=2, ffn_size=64, max_positions=8)
ROBERTA_LENS = np.asarray([6400, 2961], np.int32)  # 160 and 74 code frames: 21 and 10 buckets


# -- SpecAugment -------------------------------------------------------------------------


def test_spec_augment_eval_matches_jax():
    """Eval mode is fbank 80 + deltas + CMVN, as JAX's, on a batch with
    degenerate rows; the metadata and lengths equal."""
    jup, up = jax_hub.load("spec_augment"), hub.load("spec_augment", device="cpu")
    x = _batch()
    want, want_lens = jax.jit(jup.__call__)(jnp.asarray(x), jnp.asarray(LENS))
    got, got_lens = up(torch.from_numpy(x), torch.from_numpy(LENS))
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    quantile_rule(got.numpy()[0][~DEGENERATE], np.asarray(want)[0][~DEGENERATE], "spec_augment")


def jax_bands(key, B, L, num, width):
    """JAX's `_band_mask` draws (nn/specaug.py:21-30) as (starts, widths)."""
    k1, k2 = jax.random.split(key)
    widths = jax.random.randint(k1, (B, num), 0, width + 1)
    starts = (jax.random.uniform(k2, (B, num))
              * jnp.maximum(L - widths, 1).astype(jnp.float32)).astype(jnp.int32)
    return torch.from_numpy(np.asarray(starts)).long(), torch.from_numpy(np.asarray(widths)).long()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_masks_equal_jax_given_its_bands(seed):
    """`mask_bands` with the bands JAX draws from a key gives JAX's
    `specaug` output bit for bit (the time bands inside the lengths)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(4, 300, 240).astype(np.float32)
    lens = np.asarray([300, 211, 57, 3], np.int32)
    key = jax.random.key(seed)
    want = np.asarray(jax_specaug.specaug(key, jnp.asarray(feats), jnp.asarray(lens)))
    kf, kt = jax.random.split(key)
    got = specaug.mask_bands(torch.from_numpy(feats), torch.from_numpy(lens).long(),
                             jax_bands(kf, 4, 240, 2, 27), jax_bands(kt, 4, 300, 2, 100))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_augment_train_mode_band_structure():
    """Train mode: the train step's generator draws at most 2 frequency
    bands of <= 27 bins and 2 time bands of <= 100 frames an utterance,
    the time bands inside its frames; every other value is the eval
    feature. Without a generator every call draws from ``seed``."""
    up = hub.load("spec_augment", device="cpu")
    x, lens = torch.from_numpy(_batch()), torch.from_numpy(LENS)
    ref, ref_lens = up.model(x, lens)  # the model's own frames, before the length rule
    got, _ = up.model.train()(x, lens, generator=torch.Generator().manual_seed(7))
    up.model.eval()
    B, T, D = ref.shape[1:]
    bands = torch.Generator().manual_seed(7)
    fb, tb = specaug.draw_bands(bands, B, D, 2, 27), specaug.draw_bands(bands, B, T, 2, 100)
    assert int(fb[1].max()) <= 27 and int(tb[1].max()) <= 100
    torch.testing.assert_close(got[0], specaug.mask_bands(ref[0], ref_lens, fb, tb), rtol=0,
                               atol=0)
    zero_f = (got[0] == 0).all(dim=1)  # [B, D] bins masked over every frame
    zero_t = (got[0] == 0).all(dim=2)  # [B, T] frames masked over every bin
    rows = ref_lens > 0  # a row of no frame repeats frame 0, whose CMVN is 0
    assert (zero_f[rows].sum(1) <= 54).all() and (zero_t[rows].sum(1) <= 200).all()
    frames = torch.arange(T)[None] < ref_lens[:, None]
    changed = got[0] != ref[0]
    assert not (changed & ~frames[..., None] & ~zero_f[:, None, :]).any()  # time bands inside
    assert changed.any()
    ref, _ = up(x, lens)
    again, _ = up(x, lens, train=True)
    once_more, _ = up(x, lens, train=True)
    assert torch.equal(again, once_more) and not torch.equal(again, ref)
    other, _ = hub.load("spec_augment", seed=1, device="cpu")(x, lens, train=True)
    assert not torch.equal(other, again)


def test_time_warp_and_spec_aug_match_jax():
    """`warp_frames` at JAX's anchors and shifts equals JAX's `time_warp`;
    a short sequence comes back as it is; `SpecAug` is `specaug` with its
    policy."""
    rng = np.random.RandomState(4)
    feats = rng.randn(3, 40, 8).astype(np.float32)
    key = jax.random.key(5)
    want = np.asarray(jax_specaug.time_warp(key, jnp.asarray(feats), 5))
    k1, k2 = jax.random.split(key)
    center = np.asarray(jax.random.randint(k1, (3,), 6, 34))
    shift = np.asarray(jax.random.randint(k2, (3,), -5, 6))
    got = specaug.warp_frames(torch.from_numpy(feats), torch.from_numpy(center),
                              torch.from_numpy(shift))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    short = torch.randn(2, 12, 4)
    assert specaug.time_warp(torch.Generator().manual_seed(0), short) is short
    warped = specaug.time_warp(torch.Generator().manual_seed(0), torch.from_numpy(feats))
    assert warped.shape == feats.shape and not torch.equal(warped, torch.from_numpy(feats))
    policy = specaug.SpecAug(time_mask_num=1, time_mask_width=5)
    a = policy(torch.Generator().manual_seed(3), torch.from_numpy(feats))
    b = specaug.specaug(torch.Generator().manual_seed(3), torch.from_numpy(feats),
                        time_mask_num=1, time_mask_width=5)
    assert torch.equal(a, b)


# -- VGGish --------------------------------------------------------------------------------


_VGGISH = {}


def vggish_pair():
    """(the JAX entry, the port's entry), each loaded once (VGGish's 72M
    random weights take seconds to draw)."""
    if not _VGGISH:
        _VGGISH["jax"], _VGGISH["port"] = jax_hub.load("vggish"), hub.load("vggish", device="cpu")
    return copy.copy(_VGGISH["jax"]), _VGGISH["port"]


def test_vggish_matches_jax():
    """Two and one 0.96-s patches: the embeddings at 5e-4, the lengths
    (raw max(mel_lens // 96, 1) and standardized), the metadata."""
    jup, up = vggish_pair()
    rng = np.random.RandomState(0)
    jup.params = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32) + 0.005 * rng.randn(*np.shape(v)).astype(np.float32),
        jup.params)
    up.model.load_state_dict(vggish_state_dict_from_jax(jup.params))
    lens = np.asarray([32000, 20000], np.int32)
    x = waves(lens)
    got, want = run_both(jup, up, x, lens)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)


def test_vggish_fails_where_jax_fails():
    """A batch of fewer than 96 log-mel frames: the JAX reshape raises,
    and so does the port."""
    x = waves(np.asarray([8000], np.int32))
    jup, up = vggish_pair()
    with pytest.raises(TypeError):
        jup(jnp.asarray(x), jnp.asarray([8000]))
    with pytest.raises(ValueError, match="96-frame patch"):
        up(torch.from_numpy(x), torch.tensor([8000]))


# -- the vq-wav2vec k-means -> RoBERTa pipeline -----------------------------------------------


@pytest.fixture
def tiny_pipeline(monkeypatch):
    monkeypatch.setattr(jax_w2v1, "Wav2Vec1Config",
                        with_defaults(jax_w2v1.Wav2Vec1Config, **TINY_W2V))
    monkeypatch.setattr(port_registry, "VQ_WAV2VEC_KMEANS",
                        Wav2Vec1Config(vq_type="kmeans", vq_dim=512, **TINY_W2V))
    monkeypatch.setattr(jax_roberta, "RobertaConfig",
                        with_defaults(jax_roberta.RobertaConfig, **TINY_ROBERTA))
    monkeypatch.setattr(port_registry, "RobertaConfig", with_defaults(RobertaConfig,
                                                                      **TINY_ROBERTA))


def test_roberta_model_matches_jax():
    """RoBERTa alone on the same token ids (pads, a row of 1 token):
    every layer's states at 5e-4, pad rows of the embedding zeroed by the
    forward, positions restarting after the pad offset."""
    cfg = RobertaConfig(vocab_size=40, num_layers=2, **TINY_ROBERTA)
    jcfg = jax_roberta.RobertaConfig(vocab_size=40, num_layers=2, **TINY_ROBERTA)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 40, (3, 8)).astype(np.int32)
    lens = np.asarray([8, 5, 1], np.int32)
    model = jax_roberta.RobertaModel(jcfg)
    params = perturbed(jax.jit(model.init)(jax.random.key(0), jnp.asarray(tokens),
                                           jnp.asarray(lens))["params"])
    want, _ = jax.jit(model.apply)({"params": params}, jnp.asarray(tokens), jnp.asarray(lens))
    port = RobertaModel(cfg).eval()
    port.load_state_dict(roberta_state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(tokens).long(), torch.from_numpy(lens).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0)


def pipeline_pair(seed=0):
    jup = copy.copy(jax_hub.load("vq_wav2vec_kmeans_roberta"))
    jup.params = perturbed(jup.params, seed)
    up = hub.load("vq_wav2vec_kmeans_roberta", device="cpu")
    model = up.model
    model.w2v.load_state_dict(wav2vec1_state_dict_from_jax(jup.params["w2v"], model.w2v.cfg))
    model.roberta.load_state_dict(roberta_state_dict_from_jax(jup.params["roberta"],
                                                              model.roberta.cfg))
    return jup, up


def code_ids(up, x, lens):
    with torch.no_grad():
        return up.model.w2v(torch.from_numpy(x), torch.from_numpy(lens).long(),
                            return_code_ids=True)[2].numpy()


def test_discretebert_pipeline_matches_jax(tiny_pipeline):
    """The dense lookup, the <s> ... </s> wrap and the buckets whose
    positions restart: the codes equal, then every layer's states at 5e-4,
    the lengths (raw len + 2 and standardized) and the metadata; the
    ``discretebert`` name is the same factory."""
    jup, up = pipeline_pair()
    x = waves(ROBERTA_LENS)
    _, _, want_ids = jax.jit(lambda p, w, n: jax_w2v1.Wav2Vec1Model(
        jax_w2v1.Wav2Vec1Config(vq_type="kmeans", vq_dim=512)).apply(
        {"params": p}, w, n, True, return_code_ids=True))(
        jup.params["w2v"], jnp.asarray(x), jnp.asarray(ROBERTA_LENS))
    np.testing.assert_array_equal(code_ids(up, x, ROBERTA_LENS), np.asarray(want_ids))
    got, want = run_both(jup, up, x, ROBERTA_LENS)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    assert port_registry._REGISTRY["discretebert"] is port_registry._REGISTRY[
        "vq_wav2vec_kmeans_roberta"]


def _frontend_checkpoint(path, seed):
    """An s3prl-converted vq-wav2vec k-means checkpoint of random weights."""
    from s3prl_tpu_torch.models.wav2vec1 import Wav2Vec1Model

    cfg = Wav2Vec1Config(vq_type="kmeans", vq_dim=512, **TINY_W2V)
    model = Wav2Vec1Model(cfg)
    port_registry._init_flax(model, torch.Generator().manual_seed(seed))
    torch.save({"model_weight": model.state_dict(), "task_cfg": {},
                "model_cfg": {"conv_feature_layers": str(list(FEAT)),
                              "conv_aggregator_layers": str(list(AGG)), "vq_type": "kmeans",
                              "vq_vars": 16, "vq_dim": 512}}, path)


def _roberta_checkpoint(path, rng, dictionary):
    """An s3prl-converted RoBERTa checkpoint: fairseq keys under
    ``encoder.sentence_encoder.`` with ``layernorm_embedding``."""
    H, F, V, L = 32, 64, 48, 2

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * 0.1)

    pre = "encoder.sentence_encoder."
    sd = {f"{pre}embed_tokens.weight": t(V, H), f"{pre}embed_positions.weight": t(8 + 2, H),
          f"{pre}layernorm_embedding.weight": 1 + t(H), f"{pre}layernorm_embedding.bias": t(H),
          "encoder.lm_head.bias": t(V)}
    for i in range(L):
        p = f"{pre}layers.{i}."
        for name, (o, n) in {"self_attn.q_proj": (H, H), "self_attn.k_proj": (H, H),
                             "self_attn.v_proj": (H, H), "self_attn.out_proj": (H, H),
                             "fc1": (F, H), "fc2": (H, F)}.items():
            sd[f"{p}{name}.weight"], sd[f"{p}{name}.bias"] = t(o, n), t(o)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{p}{name}.weight"], sd[f"{p}{name}.bias"] = 1 + t(H), t(H)
    ckpt = {"model_weight": sd, "task_cfg": {},
            "model_cfg": {"encoder_layers": L, "encoder_embed_dim": H,
                          "encoder_attention_heads": 2, "encoder_ffn_embed_dim": F}}
    if dictionary:
        ckpt["text_dictionary"] = "\n".join(f"{a}-{b} {100 - a}" for a in range(0, 16, 2)
                                            for b in range(0, 16, 3)) + "\n"
    torch.save(ckpt, path)


@pytest.mark.parametrize("dictionary", [True, False])
def test_roberta_checkpoint_round_trip(tiny_pipeline, tmp_path, dictionary):
    """An s3prl RoBERTa checkpoint (with its dictionary's lookup, or none:
    every pair <unk>) and a vq-wav2vec frontend checkpoint load through
    both hubs to the same states."""
    rob, front = str(tmp_path / "roberta.ckpt"), str(tmp_path / "vq.ckpt")
    _roberta_checkpoint(rob, np.random.RandomState(5), dictionary)
    _frontend_checkpoint(front, 6)
    jup = jax_hub.load("vq_wav2vec_kmeans_roberta", ckpt=rob, frontend_ckpt=front)
    up = hub.load("discretebert", ckpt=rob, frontend_ckpt=front, device="cpu")
    if dictionary:
        want_lookup, _ = jax_convert.parse_fairseq_dictionary(torch.load(rob)["text_dictionary"])
        np.testing.assert_array_equal(up.model.lookup.numpy(), want_lookup)
    else:
        assert (up.model.lookup == 3).all()
    got, want = run_both(jup, up, waves(ROBERTA_LENS), ROBERTA_LENS)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


# -- PASE+ --------------------------------------------------------------------------------

PASE_LENS = np.asarray([8000, 4801], np.int32)


def pase_pair(seed=0):
    jup = copy.copy(jax_hub.load("pase_plus"))
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32) + 0.05 * np.asarray(rng.randn(*np.shape(x)), np.float32)
        return np.abs(x) + 0.5 if jax.tree_util.keystr(path).endswith("['var']") else x

    jup.params = jax.tree_util.tree_map_with_path(leaf, jup.params)
    up = hub.load("pase_plus", device="cpu")
    up.model.load_state_dict(pase_state_dict_from_jax(jup.params, up.model.cfg))
    return jup, up


def assert_scaled(got, want):
    """Each state within 5e-4 of its largest magnitude."""
    for layer, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=5e-4 * np.abs(w).max(), rtol=0,
                                   err_msg=f"state {layer}")


def test_linear_scan_matches_associative_scan():
    """The fo-pooling c_t = f_t c_{t-1} + v_t by doubling against JAX's
    associative_scan at T = 1,000: the two summation trees agree to 2e-6
    of the largest state."""
    rng = np.random.RandomState(0)
    f = (1 / (1 + np.exp(-rng.randn(2, 1000, 16)))).astype(np.float32)
    v = ((1 - f) * np.tanh(rng.randn(2, 1000, 16))).astype(np.float32)
    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        lambda p, q: (p[0] * q[0], q[0] * p[1] + q[1]), (a, b), axis=1))(jnp.asarray(f),
                                                                          jnp.asarray(v))
    got = linear_scan(torch.from_numpy(f), torch.from_numpy(v)).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=2e-6 * np.abs(want).max(), rtol=0)
    c, ref = np.zeros((2, 16), np.float64), np.empty_like(want, dtype=np.float64)
    for t in range(1000):
        c = f[:, t] * c + v[:, t]
        ref[:, t] = c
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max(), rtol=0)


def test_pase_matches_jax():
    """Eval mode (the running statistics, away from 0 / 1): the nine states
    at 5e-4 of their scale, the lengths min(ceil(len / 160), T'), the
    metadata; ``pase_local`` / ``pase_url`` are ``pase_plus``."""
    jup, up = pase_pair()
    x = waves(PASE_LENS)
    got, want = run_both(jup, up, x, PASE_LENS)
    assert got.shape[0] == 9
    assert_scaled(got, want)
    assert (up.num_layers, up.hidden_size, up.downsample_rate) == (
        jup.num_layers, jup.hidden_size, jup.downsample_rate)
    for name in ("pase_local", "pase_url"):
        assert port_registry._REGISTRY[name] is port_registry._REGISTRY["pase_plus"]


def test_pase_train_mode_uses_batch_statistics():
    """Train mode normalises with the batch's statistics, as JAX's train
    apply (whose batch_stats update it throws away), and leaves the
    running statistics as they were."""
    jup, up = pase_pair(1)
    before = {k: v.clone() for k, v in up.model.state_dict().items()}
    x = waves(PASE_LENS)
    got, want = run_both(jup, up, x, PASE_LENS, train=True)
    assert_scaled(got, want)
    eval_states, _ = up(torch.from_numpy(x), torch.from_numpy(PASE_LENS))
    assert not np.allclose(eval_states.numpy(), got, atol=1e-3)
    after = up.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_zoo_rest_refusals(monkeypatch, tmp_path):
    """The keywords each JAX entry takes and ignores raise (``ckpt`` on
    spec_augment and vggish, through spec_augment_local too; PASE+'s ckpt
    as JAX's NotImplementedError; the trunk options; a dtype the pipeline
    cannot take); without CUDA and without device= each entry raises."""
    path = str(tmp_path / "x.ckpt")
    with pytest.raises(ValueError, match="ckpt cannot take effect on spec_augment"):
        hub.load("spec_augment_local", ckpt=path, device="cpu")
    with pytest.raises(ValueError, match="ckpt cannot take effect on vggish"):
        hub.load("vggish", ckpt=path, device="cpu")
    with pytest.raises(NotImplementedError):
        jax_hub.load("pase_plus", ckpt=path)
    with pytest.raises(NotImplementedError, match="pase package"):
        hub.load("pase_url", ckpt=path, device="cpu")
    with pytest.raises(ValueError, match="flash cannot take effect on pase_plus"):
        hub.load("pase_plus", flash=True, device="cpu")
    with pytest.raises(ValueError, match="quantize cannot take effect on vq_wav2vec_kmeans_rob"):
        hub.load("discretebert", quantize=True, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        hub.load("vq_wav2vec_kmeans_roberta", dtype=torch.bfloat16, device="cpu")
    with pytest.raises(TypeError, match="unexpected"):
        hub.load("spec_augment", dtype=torch.float32, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("spec_augment", "vggish", "discretebert", "pase_plus", "pase_local"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            hub.load(name)
