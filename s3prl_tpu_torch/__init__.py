"""s3prl_tpu_torch — the PyTorch + CUDA port of s3prl_tpu for one NVIDIA H100.

The JAX package `s3prl_tpu` stays the reference; this package mirrors its
module names (`models/`, `kernels/`, `ops/`, `upstream/`, `hub`) and replaces
each Pallas kernel on its path with a CUDA kernel written for Hopper
(`csrc/*.cu`, built at first use by `kernels/_build.py`). CPU tensors run each
kernel's plain PyTorch version. It never imports jax.

    from s3prl_tpu_torch import hub
    up = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True,
                  quantize=True)  # int8 W8A8, the serving default, on the card
    hs, h_lens = up.apply_standardized(wavs, wav_lens)  # [25, B, T', 1024]

``quantize=False`` gives the bf16 reference-precision path. The other
entries (`hub.options()`) are the HuBERT, wav2vec 2.0, data2vec, WavLM and
UniSpeech-SAT models of the JAX package's registry, e.g.
``"wav2vec2_large_ll60k"``, ``"data2vec_large_ll60k"``, ``"wavlm_large"``,
``"unispeech_sat_base"``; ``ckpt=`` loads a local checkpoint; the trunk
entries also serve SUPERB's weighted sum without the per-layer stack:

    weighted, feat_lens = up.apply_weighted(layer_weights, wavs, wav_lens)  # [1, B, T', C]

Models are built on the card unless ``device="cpu"`` is given. SUPERB's
frozen-upstream probes train on the card through the packaged API and the
JAX package's recipes (`nn`, `task`, `train`, `problem`,
``python -m s3prl_tpu_torch.main``), the frozen forward on the kernels:

    from s3prl_tpu_torch.nn import SUpstream, UpstreamDownstreamModel, UtteranceLevel
    from s3prl_tpu_torch.task import UtteranceClassificationTask
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    up = SUpstream("hubert_large_ll60k", extra_conf={"dtype": "bf16", "flash": True,
                                                     "quantize": True})
    head = UtteranceLevel(up.hidden_sizes[-1], 10, (256,), "MeanPooling")
    task = UtteranceClassificationTask(UpstreamDownstreamModel(head, up.num_layers), 10)
    Trainer(up.upstream, task, "exp", TrainerConfig(total_steps=1000)).train(loader)
"""

__version__ = "0.1.0"

SAMPLE_RATE = 16000
