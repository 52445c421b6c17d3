#!/usr/bin/env python3
"""On-card check of the PyTorch + CUDA port (s3prl_tpu_torch) on one GPU.

    python3 chip_smoke.py [--phases 16]

Phases (any failed check raises, so the exit code is not 0 and no result
line is printed; each phase prints its seconds; ``--phases`` runs 1, 2 and
the phases it lists, 3-6 together, and prints no result line):
 1. require a CUDA device; print the card's name and power limit;
 2. build the CUDA kernels from csrc/ (into build/) and print the seconds;
    for the tensor-core kernels - on wgmma the attention (gated_attention.cu:
    K1, K4, K6-K11, K17; six instantiations), the int8 GEMM core (gemm_s8.cu:
    the products of K2, K11 and of K1's, K6's and K12's wide-row route;
    three), the int8 panel projection (int8_panel.cu: K1's and K12's
    projections on bf16 rows, K6's out-proj on f32 rows; three), K13b's conv
    (int8_conv.cu; one), the bf16 GEMM core (gemm_bf16.cu: K4's projections,
    K5, K14; one), K16a (posconv.cu; one) and K16b (posconv.cu: bf16 and f32
    x; two); on mma.sync K3 / K13a on bf16
    waves (conv0_ln_gelu.cu: erf, tanh, q8; three) - print each
    instantiation's registers, stack and spills (ptxas -v, nvcc.log) with any
    ptxas note that its wgmma were serialized, and its HGMMA / IGMMA (wgmma)
    or HMMA (mma.sync) count in the SASS (cuobjdump); K3 / K13a's SASS
    instructions a tile and the issue floor they set at B=32 x 10 s (every
    instruction of the tile loop issued once per warp tile, one a clock on
    each of an SM's 4 schedulers at the card's maximum SM clock); then each
    kernel's shared memory and blocks per SM; fail unless each kernel has
    its count of instantiations, on a stack frame, a spill or an
    instantiation without its tensor-core products, and on any tensor-core
    instruction in K3 / K13a's f32-wave instantiations (conv0_fma_kernel:
    f32 FMAs; three, spills printed);
 3. each kernel against its plain PyTorch version on the same CUDA tensors,
    at the main paths' shapes with unit-scale inputs: cosine > 0.9995 and
    every element within max(3e-2, one bf16 step at the plain value) of
    it (one step is 0.03125 where LayerNorm outputs reach |v| >= 4). K3 in
    both GELU modes, K1 pre-LN and postnorm, K2 in five flag sets at
    C=1024, F=4096 (two chunks) and postnorm at C=768, F=3072 (one chunk),
    K4, K5 (B=4 x 499 frames); K6 and K7 at B=4 x 1,499 frames and at
    B=7 x 65 and 127 frames (and K6 at B=8 x 1,499 launching the packed
    attention and one int8_panel.cu launch, the panel's codes and scales
    on its f32 context bit-equal to quant_rows.cu's and quantize_rows'),
    K8 on [2, 16, 2999, 64] and [7, 16, 2049,
    64], the B=7 cases with kv_lens on the 64-key tile edges (1, 63, 64,
    65, 127, 128, T); WavLM's K9 at B=4 x 499 and B=4 x 1,499 and K10 on
    [2, 16, 2999, 64], with a pos_bias from the bucket table in the main
    path's form (bf16 in a buffer padded to rows of a multiple of 8) and
    gates in (1, 3), K9 at B=4 x 499 and K10 on [2, 16, 2999, 64] again
    with the contiguous f32 bias, K9 at T = 65, 127, 499 and K10 at T =
    2,049 (bf16) and 65 (f32) on B=7 with kv_lens on the 64-key tile edges
    (1, 63, 64, 65, 127, 128, T), both bias forms at K9's; the fused int8
    projections: K11 at B=4 x 499 and B=4 x 1,499 with the ``wavlm_fuse``
    model's f32 bias (rows padded to a multiple of 4 floats), at B=4 x 499
    with the unpadded one (rows T apart: 4-byte copies at odd T), and at
    B=7 x 65, 127 and 499 with kv_lens on the 64-key tile edges (the same
    gates, ragged kv_lens) and K12 in its four (ln,
    residual) sets at [4 x 499, 1024] -> N = 3072 (with the LN) or 1024;
    K1 and K12 launch what their design says (a spy on the C entries: K12
    one int8_panel.cu launch, K1 panel QKV + attention + panel out-proj [+
    LN]) at C = 1,024, and the wide-row route (quant_rows.cu + gemm_s8.cu
    per projection) at C = 1,280 (H = 20), held there against the plain
    versions; the panel kernel alone against the plain projection at C 768
    and 1,024, rows 1, 127, 129 and 15,968, N 8, 264, 1,024 and 3,072, in
    K1's four epilogue sets (QKV with and without the LN, out-proj bf16 and
    f32 out) and K12's two, with its codes and scales (test mode) bit-equal
    to quantize_rows (of the LN recomputed from the kernel's statistics) or
    quantize_context_reference; the share of int8 codes where the kernels' quantizers and the plain
    ones differ is printed (K6's and K11's context codes among them). The
    int8 GEMM alone equals torch._int_mm exactly (QKV, fc2 column ranges,
    M, N, K on the 128 x 256 x 128-byte tile edges, row-group views [3, T',
    512] with lda 1024), and the quantizer rounds constructed ties half to
    even. The bf16 GEMM alone (`gemm`) against F.linear in f32 math on its
    tile edges (M, N, K around 128 x 256 x 64, every epilogue flag) and on
    K14's row-group views (k = 1, 2, 3: rows apart, abutting, overlapping).
    The front-end kernels at the shapes of
    B=2 x 10 s: K13a on the waves, K14 and K13b (codes out, and bf16 out as
    in the last layer) on layer 1's input [2, 31999, 512] (k=3) and layer
    5's [2, 1999, 512] (k=2), K15 (erf, tanh) on those layers' outputs;
    K13a's and K13b's codes may differ from the plain version's in at most
    0.1% of places, by one step, and their scales agree at rtol 1e-5 (the
    share is printed); the pos-conv kernels K16a and K16b at B=4 x 499,
    B=4 x 1,499 and B=3 x 257 frames of HuBERT-Large's pos-conv (C 1024, k
    128, 16 groups),
    K16b's activation codes and scales (`posconv_quant`, and the codes its
    conv kernel writes into its windows: test mode) under the same rule;
    K17 on [4, 16,
    499, 64] and on B=7 x 65 and 127 frames with kv_lens on the tile edges;
    then the post-LN kernel forms at the Base models' widths (C 768, H 12,
    F 3,072) on a unit-scale residual stream: K1 and K4 postnorm at B=32 x
    499, K2 and K5 postnorm and K2 bare at 32 x 499 rows, K6 at [8, 1,499] on
    a QKV made from raw x (int8_matmul), K9 at [32, 12, 499, 64] (padded
    bf16 bias) and K11 at [32, 499, 768]; the same post-LN forms (but K9,
    K11) at data2vec-Large's widths (C 1,024, H 16, F 4,096); and every
    attention kernel with utterances of kv_len 0 (an utterance under 400
    samples has no frame under the conv length rule): K1 and K4 pre-LN and
    postnorm at [4, 499], K6 and K7 at [4, 1,499], K8 and K10 on [2, 16,
    2,999, 64], K9 and K17 on [4, 16, 499, 64], K11 at [4, 499], and K2
    (LN + residual, postnorm, bare) on an utterance of zero rows and one of
    a single repeated row;
 4. the main paths at full width, HuBERT-Large (hub.load(
    "hubert_large_ll60k", bf16, flash, quantize=True) - the int8 serving
    default - and quantize=False) and WavLM-Large (hub.load("wavlm_large",
    ...), the same two paths), one apply_standardized each on mixed
    lengths: B=8 x 10 s, B=8 x 30 s (T' = 1,500) and B=4 x 60 s (T' =
    3,000); then the int8 options of the fused projections at 10 s and
    30 s: HuBERT with ``full_fuse`` (K12, K7, K12, K2 at every T) and with
    ``qkv_fuse`` (inert at 10 s; K12 then K6 at 30 s), WavLM with
    ``wavlm_fuse`` (K11); then the front-end options at 10 s: HuBERT int8
    with ``int8_conv`` (K13a, 6 K13b, no K3), bf16 with ``fused_conv`` (K3,
    6 K14), int8 with ``fused_midln`` (K3, 6 K15), WavLM bf16 with
    ``fused_conv``; then the pos-conv options at 10 s and 30 s: HuBERT bf16
    with ``fused_posconv`` (one K16a a forward) and int8 with
    ``int8_posconv`` (one K16b); then the post-LN Base models, HuBERT-Base
    (hub.load("hubert_base", ...): group-norm extractor, no K3; 12 K1 + 12
    K2 postnorm at 10 s, K6 on raw x (bf16: K7) at 30 s, K8 at 60 s; bf16 12
    K4 + 12 K5 postnorm) and WavLM-Base (hub.load("wavlm_base", ...): 12 K9,
    K10 at 60 s, int8 12 K2 bare), int8 and bf16 on the same three batches,
    and WavLM-Base int8 with ``wavlm_fuse`` (12 K11) at 10 s and 30 s;
    then wav2vec2-Large (hub.load("wav2vec2_large_ll60k", ...): pre-LN, the
    conv length rule) and data2vec-Large (hub.load("data2vec_large_ll60k",
    ...): post-LN, K1 / K4 and K2 / K5 postnorm, K6 on raw x, the depth-5
    pos-conv stack on stock ops), int8 and bf16 on the three batches, whose
    1-sample utterance has no frame there (kv_len 0 in K1, K4, K6, K7, K8),
    and UniSpeech-SAT Base (hub.load("unispeech_sat_base", ...)) int8 and
    bf16 at 10 s;
    checks the [L+1, B, T', C] shape ([25, ..., 1024] Large, [13, ..., 768]
    Base), exact h_lens,
    finite values, and the launch counts of each run, read just after it
    with every count set to 0 just before (RUNS below; every other count 0);
    then HuBERT-Large int8's `apply_weighted` (SUPERB's fused weighted sum)
    on the 10 s batch: its launches, [1, B, T', 1024], within one bf16 step
    of the weighted sum of the same model's apply_standardized states
    (bit-equality printed), and no op of it returning a [25, B, T', 1024]
    stack (a dispatch-mode spy, which sees apply_standardized's); and a
    ``ckpt=``
    round trip: wav2vec2-Large int8's weights saved as an s3prl checkpoint
    in a temporary directory and loaded back through hub.load(ckpt=...),
    its configuration, weights, int8 cache and hidden states bit-equal;
 5. the same seed's models on the CPU (copies of the card's; the kernel
    wrappers' plain versions)
    against the card, per-layer cosine > 0.999 over valid frames, for each
    path: HuBERT on B=2 x 1.5 s, then on B=2 x 3 s with MAX_BLOCK_T = 64 (K6 /
    K7) and with MAX_KERNEL_T = 128 as well (K8); WavLM on B=2 x 1.5 s (K9)
    and B=2 x 3 s with MAX_KERNEL_T = 128 (K10); HuBERT ``full_fuse`` on
    B=2 x 1.5 s and, with MAX_KERNEL_T = 128, B=2 x 3 s (K8), ``qkv_fuse`` on
    B=2 x 3 s with MAX_BLOCK_T = 64, WavLM ``wavlm_fuse`` on B=2 x 1.5 s and,
    with MAX_KERNEL_T = 128, B=2 x 3 s (K10, no K11), and each front-end
    option on B=2 x 1.5 s; each pos-conv option on B=2 x 1.5 s, and again with
    MAX_POSCONV_T = 64 (the stock conv: no K16 launch); HuBERT-Base int8 and
    bf16 on B=2 x 1.5 s (K1 / K4 postnorm) and on B=2 x 3 s with MAX_BLOCK_T =
    64 (K6 on raw x / K7); WavLM-Base int8, bf16 and ``wavlm_fuse`` on B=2 x
    1.5 s (K9; K11) (their K8 / K10 cases, the Large models' routes, cut since
    PR 24); wav2vec2-Large and
    data2vec-Large int8 and bf16 on B=3 x 1.5 s with a 1-sample utterance (K1
    / K4) and on B=3 x 3 s with MAX_BLOCK_T = 64 (K6 / K7), kv_len 0 in
    each (their K8 case, HuBERT's, cut since PR 24); UniSpeech-SAT int8
    and bf16 on B=2 x 1.5 s (K9). Then the JAX
    package's quality gates at full
    depth on the card, against the f32 model (flash=False) of the same
    weights (wav2vec2-Large and data2vec-Large as HuBERT-Large, without
    options; UniSpeech-SAT as WavLM-Base, without options; data2vec-Large
    int8, whose 24 post-LN layers drift below 0.999 at int8 in the JAX
    package itself, is held in both comparisons to its plain versions: its
    card states as close to f32 as the CPU's, within 5e-4 a layer,
    DRIFT_PATHS): int8 per-layer cosine > 0.999 (tests/test_quant.py:82-124,
    :306-333) on B=2 x 0.5 s, B=2 x 30 s and (HuBERT and WavLM) B=1 x 60 s
    (the options on the first two; ``int8_posconv`` among them), bf16 > 0.995
    (tests/test_quant.py:590) on the two long ones (HuBERT) or all three
    (WavLM), HuBERT's bf16 options at 30 s (``fused_posconv`` among them);
    the Base models (12 layers) int8 > 0.999 and bf16 > 0.995
    (tests/test_quant.py:553-591) on B=2 x 0.5 s and B=2 x 30 s, WavLM-Base's
    ``wavlm_fuse`` among them;
 6. timing (printed): extraction audio-s/s of HuBERT-Large's and
    WavLM-Large's int8 and bf16 paths at B=32 x 10 s, B=8 x 30 s and B=4 x
    60 s, best of 2, of every other path at B=32 x 10 s (``qkv_fuse`` at
    30 s), best of 1 (`timed_lengths`, `timing_reps`; two chain lengths,
    marginal rate, CUDA events) with the peak device memory, and each kernel against its
    plain version at those shapes, with its bound (the larger of the
    bytes it must move over 3.35 TB/s and its operations over the peak
    rate of their type; the bias counted at its element size) and, for the
    attention kernels K7-K10, the time of one
    torch.nn.functional.scaled_dot_product_attention on the same bf16 q, k,
    v with its mask (built before the timed region; the port never calls
    it). K9 and K10 are timed with the main path's padded bf16 bias (their
    entries in the kernels line) and again with the contiguous f32 one.
    `_attention` alone (the packed wgmma core of K1, K4, K6 and K7), bf16
    and f32 out, at [32, 499] and [8, 1499] beside SDPA, on a line of its
    own. K11 at [32, 499] and K12 at 32 x 499 rows
    beside the split pairs they replace (K9 with the heads split and merged,
    int8_matmul out-proj and residual; LN and int8_matmul QKV; int8_matmul
    out-proj and residual), which no single library call computes. On lines
    of their own: K2's launches one by one (x-quant, fc1, the two requants,
    the two fc2 chunks) at B=32 x 499, K1's three (panel QKV, attention,
    panel out-proj) and K12's panel launch in its two main-path sets beside
    the wide-row route's pair at the same shape, and the int8 GEMM alone (int32 out)
    beside torch._int_mm at K2's fc1 and fc2-chunk and K1's QKV shapes, with
    TOP/s; the bf16 GEMM alone (`gemm`, the main path's epilogue flags)
    beside F.linear (cuBLAS, with the bias) at K5's fc1 and fc2, K4's QKV
    and out-proj (M = 32 x 499) and K14's layer 1 (32 x 15,999 rows, K =
    1,536: the overlapping im2col view, F.linear on a contiguous copy), with
    TFLOP/s. The
    front-end options' paths are timed at B=32 x 10 s, and every path's
    feature extractor alone; K13b in its test mode on the six mid layers of
    B=32 x 10 s (the f32 tap sums bit-equal to the plain version's, codes,
    scales and the last layer's bf16 rows bit-equal given the kernel's LN
    statistics) and its peak device memory for one call at layer 1 beside
    the per-tap route's f32 tap sum, which it must stay below; K13a, K13b,
    K14 and K15 over the six mid
    layers of B=32 x 10 s (one launch of K13a) beside their plain versions,
    their bounds and the stock ops they replace (K3 tanh + quantize_rows;
    F.conv1d + F.layer_norm + cast + F.gelu; F.layer_norm + cast + F.gelu).
    Every path's feature extractor alone at B=32 x 10 s is printed beside
    its share of that path's forward (the Base models' group-norm extractor
    runs no kernel). The Base-width kernels of phase 3, and the post-LN
    forms at data2vec-Large's width, beside their plain versions and
    bounds, each on a line of its own (not in the kernels line). HuBERT-Large
    int8's `apply_weighted` beside its apply_standardized at B=32 x 10 s
    (the same protocol, each with its peak device memory). The pos-conv
    options' paths at B=32 x 10 s and B=8 x 30 s; K16a and K16b
    at B=32 x 499 beside their plain versions, their bounds, one grouped
    bf16 F.conv1d with its bias (the library figure) and the stock
    F.conv1d + bias + GELU chain they replace; K16b's quantizer alone
    (`posconv_quant`: scales and codes) and its scale pass alone (the part
    of K16b's launch before the conv); K17 on [32, 16, 499, 64]
    beside scaled_dot_product_attention. K17 runs on no main path (no model
    calls it): its launch count in the kernels line is 0;
 7. SUPERB's frozen-upstream probe training at full width, through the
    port's entry points: SUpstream("hubert_large_ll60k", extra_conf={bf16,
    flash, quantize}) on B=32 x 10 s, UpstreamDownstreamModel(
    UtteranceLevel(10, (256,), "MeanPooling")), UtteranceClassificationTask
    and the Trainer with Adam 1e-4 (tools/bench_train.py:50-73's setup):
    8 train steps on one batch, each launching K3 once and K1 and K2 24
    times (every other count 0; the counts set to 0 just before the step and
    read just after it), the upstream in eval() throughout, the loss finite
    and falling; one probe step from the card's states on the card and on
    the CPU (the states moved there, the same probe weights and Adam state):
    loss and gradient norm at rtol 1e-3, each parameter's update at cosine
    > 0.999; the train step and the frozen forward alone timed by
    bench_train's protocol (chains of 3 and 9, marginal, best of 3, CUDA
    events) with the audio-s/s, the peak device memory and the card's name
    and power limit, and under torch.profiler (the device's idle share, the
    kernels the step runs beyond the forward's); then the CommonExample recipe on pseudo audio with
    build_upstream hubert_large_ll60k int8 at full depth through
    Problem.run, all four stages in a temporary directory (result.yaml,
    step_2, step_4 and valid_best, the launches of its 7 forwards) and an
    auto-resume of stage 2 that finds step 4 and trains no step;
 8. SUPERB ASR on the card, through the port's entry points: the same
    SUpstream under UpstreamDownstreamModel(RNNEncoder(31, hidden 1024, 2
    layers, proj 1024, dropout 0.2)), Speech2TextCTCTask and the Trainer
    (Adam 1e-4, clip 1.0) on one B=32 batch of lengths drawn from 5-10 s
    with random letter-and-space transcripts at 12 characters a second: 6
    train steps, each launching K3 once and K1 and K2 24 times (every
    other count 0), the upstream in eval(), the loss finite and falling;
    one probe step from the card's states of 4 utterances on the card and
    on the CPU (the same probe weights and Adam state, dropout off on both:
    their generators differ): loss and gradient norm at rtol 1e-3, each
    parameter's update at cosine > 0.999, bias_ih still zero; the CTC loss
    and its logit gradient on [4, 499, 31] on the card against the CPU with
    a row whose 5 frames cannot emit its 20 tokens and a row with no frame
    (optax's ~1e5): values at rtol 1e-5, each row's gradient within 8 f32
    steps at its loss's magnitude and at cosine > 0.9999; the
    train step and the frozen forward alone timed as in phase 7 with the
    audio-s/s, the peak device memory and the card's name and power limit,
    each LSTM layer's forward and backward alone, then under torch.profiler
    (the idle share, the kernels beyond the forward's grouped as cuDNN's
    RNN cells, CTC, GEMMs and other); Trainer.evaluate
    on the batch (WER, CER) and BeamDecoder(beam 20) on 4 utterances'
    log-probs moved to the host (ids of the vocabulary; a peaked posterior
    decodes to its text); then SuperbASR through Problem.run, all four
    stages, on a LibriSpeech-shaped tree of FLAC files written by the
    port's write_flac (train-clean-100 8, dev-clean 2, test-clean 2
    utterances of 2-4 s) with hubert_large_ll60k int8 and the recipe's
    full-width downstream, 4 steps (result.yaml with the WER, step_2,
    step_4 and valid_best, the launches of its 7 forwards), and inference
    on one FLAC file, which prints its transcription (one forward's
    launches).
 9. SUPERB's speaker tasks on the card over the same SUpstream: ASV
    (SuperbXvector(512, 512, 1500) -> AM-softmax over 1,211 speakers,
    AdamW 1e-4, clip 1e3, accumulation 5; B=10 of 4-10 s from a seed, 10
    micro-steps), GE2E (SapSpeakerHead(256) -> the GE2E loss, AdamW 4e-4;
    B=100 = 10 speakers x 10 crops of 5 s, 4 steps) and SD
    (SuperbDiarizationModel(2, 512, 1 layer) -> PIT BCE, Adam 1e-4, clip
    1, accumulation 4; B=8 chunks of 20 s with two overlapping speakers
    rasterised by rasterize_labels, rows 1 and 5 with the speakers
    swapped; 8 micro-steps): the ASV and GE2E steps launch K3 once and K1
    and K2 24 times, the SD step (999 frames) K3 once and K6 and K2 24
    times and K1 never (every other count 0), the upstream in eval(), the
    loss finite and lower after the updates, SD's permutations not all
    alike; one update of each probe from the card's states on the card
    and on the CPU (the same weights and optimizer state): loss and
    gradient norm at rtol 1e-3, each parameter's update at cosine > 0.999
    (am_weight and ge2e_w included; SAP's attention bias and ge2e_b, whose
    gradient is zero but for rounding, within 2 lr), SD's permutation a
    row the same; each step and the frozen forward alone timed as in
    phase 7 with audio-s/s, the peak device memory and the card's name and
    power limit, then under torch.profiler (the idle share and the
    kernels beyond the forward's: the TDNN convs, cuDNN's LSTM, GEMMs);
    then SuperbASV through Problem.run on a VoxCeleb1 tree whose test
    split holds a 45-s utterance (its test batch launches K8;
    bucket_max 45 s), Voxceleb2AMSoftmaxSegment's four stages with its
    evaluation on 8-s windows at a 4-s stride of a 20-s utterance, and
    SuperbSD on a Kaldi tree of 40-s recordings (two 20-s chunks each):
    result.yaml (EER and minDCF in [0, 1]; the DER), rttm/hyp.rttm and
    each run's launches.
10. SUPERB's frame probes, QbE, HEAR and MOS over the same SUpstream
    (`recipes_phase`).
11. The baseline front ends and SUPERB-SG's SE, SS and ST (`sg_phase`):
    the six baseline entries on the card against the CPU at B=8 x 2-10 s
    (the quantile rule of tests/test_audio_ops.py), the STFT -> iSTFT
    round trip at B=8 x 15 s (atol 1e-4), the fbank entry at B=32 x 10 s,
    the STFT and the iSTFT timed; the SS (SepRNN, B=8 x 3-15 s in the 15-s
    bucket: K3 once, K6 and K2 24 times), SE (B=8 x 2-6 s: K1) and ST
    (the decoder over 8,000 tokens, B=16 x 2-10 s, accumulation 8: K1)
    heads from their recipes' default configs, three updates each on a
    fixed batch (launches a step, the loss lower after two updates), one
    update against the CPU (loss and gradient norm at rtol 1e-3, update
    cosines > 0.999, SS's best permutations equal), each step and the
    frozen forward timed with the peak device memory and the idle share;
    ST's greedy decoding to 128 tokens timed, with the share of rows whose
    tokens match the CPU's; SeExample on fbank (no kernel) and StExample on
    HuBERT-Large int8 through Problem.run, their result.yaml.
12. SUPERB's SLU recipes and the mel-domain upstreams (`slu_phase`): the
    nine models behind the ten new hub names (mockingjay, tera,
    audio_albert, apc, vq_apc, npc, mos_prediction = mos_wav2vec2, mos_apc,
    mos_tera) at their published widths from seed 0 on the card and on the
    CPU at B=8 x 2-10 s (the hidden states' |err| median < 1e-3 and p99 <
    1e-2 over the valid frames and each layer's cosine > 0.999; the MOS
    scores within 1e-3), each forward timed with its audio-s/s; the
    SluATIS (B=1 x 2-4 s) and MoseiSentiment (B=3 x 3-10 s) heads from
    their recipes' default configs over HuBERT-Large int8: six micro-steps
    at accumulation 2 (K3 once, K1 and K2 24 times a micro-step, every
    other count 0; the C entries of one forward; the losses logged), one
    update against the CPU (losses and gradient norms at rtol
    1e-3, update cosines > 0.999, the shifts within 2 lr), each micro-step
    and the frozen forward timed with the peak memory and the idle share;
    SluExample through Problem.run over HuBERT-Large int8.
13. The upstream in train mode and VC (`train_mode_phase`): SUpstream's
    HuBERT-Large int8 and WavLM-Large bf16 with flash=True under the Trainer
    with ``upstream_trainable`` at their config's dropouts on B=32 x 10 s:
    four steps, each launching K7 (WavLM: K9) 24 times and nothing else (no
    block kernel, no K3; a refuse_grad error would raise), the upstream in
    train(), no upstream parameter with a gradient; at rates 0 the card's
    train-mode states against the CPU's (B=2 x 2 s, per-layer cosine >
    0.999) and one probe update from them against the CPU; the train-mode
    step timed beside the frozen step (ms, audio-s/s, peak memory, idle
    share). Then VcVcc2020 at full width over fbank through Problem.run on
    a VCC2020-shaped tree of 1-5 s utterances (four steps of 6, valid,
    evaluate: MCD and Griffin-Lim waves), its train step timed beside the
    fbank forward, one step against the CPU (the prenet's dropout off on
    both), and Griffin-Lim of the predicted mels on the card against the
    CPU (one round's waves; 32 rounds' spectral convergence).
14. The rest of the wav2vec2-style zoo (`zoo_phase`): wav2vec2-Conformer
    with relative positions and with rotary embeddings (24 layers at 1,024
    wide) in bf16 and f32, ESPnet HuBERT-Large in bf16 with flash=True,
    DistilHuBERT, LightHuBERT's base and small subnets and MR-HuBERT-Base
    in f32, each from seed 0 through hub.load on B=8 x 2-10 s: its launches
    (K3 once on the Conformers and LightHuBERT, K3 once and K4 and K5 24
    times on ESPnet, none on DistilHuBERT and MR-HuBERT; every other count
    0), shape, lengths, finite values, the forward timed with its audio-s/s
    and idle share, and the card against the CPU on B=2 x 1.3-2 s (per-layer
    cosine > 0.999).
15. The conv, recurrent and windowed families and the small front ends
    (`zoo2_phase`): wav2vec 1.0 (wav2vec_large), vq-wav2vec (Gumbel and
    k-means), CPC, DeCoAR and DeCoAR-layers in f32, DeCoAR 2.0 in f32 and
    bf16, BYOL-A, BYOL-S with its three window encoders (AudioNTT2020,
    ResNetish34, CvT), wav, log_stft and example, each from seed 0 through
    hub.load at published widths on B=8 x 2-10 s: no kernel launched (every
    count 0), shape, lengths, finite values, the forward timed with its
    audio-s/s and idle share, and the card against the CPU on B=2 x 1.3-2 s
    (per-layer cosine > 0.999; vq-wav2vec's z > 0.999, its codes equal on
    at least 99.5% of the valid frames - a near-tie of a random codebook can
    pick another code on the card - and its aggregator's states > 0.99).
16. The rest of the hub (`zoo3_phase`): SSAST patch and frame, PaSST base,
    base2levelmel and hop100base2lvlmel (the most tokens a clip), VGGish,
    the vq-wav2vec k-means -> RoBERTa pipeline, PASE+, SpecAugment and
    hf_wav2vec2, each from seed 0 through hub.load at its published width,
    and a HuBERT-Large-shaped trunk with activation_fn swish loaded through
    ckpt= from a temporary s3prl checkpoint in f32 and int8, on B=8 x 2-10
    s: the launches (K3 once on hf_wav2vec2 and the swish trunks, K7 24
    times on the swish int8 one - no K1, K2, K4, K5 or K12 - none
    elsewhere; every other count 0), shape, lengths and finite values, the
    forward timed with its audio-s/s and idle share, and the card against
    the CPU on B=2 x 1.3-2 s (the lengths, the model's own too, and
    per-layer cosine > 0.999; the pipeline's codes equal on >= 99.5% of
    the frames and its states > 0.99); SpecAugment's train mode on the card
    (its bands, inside the lengths, the unmasked values eval mode's).
17. SSL pretraining (`pretrain_phase`): every recipe but the Examples
    (Mockingjay, TERA, AudioALBERT, SpecAugment, APC, VQ-APC, NPC,
    DistilHuBERT, HuBERT, data2vec) at its JAX default config and batch
    size (8; 32 for APC, VQ-APC and NPC; 12 for the distiller) on pseudo
    waves of 2-15 s: three Trainer steps, each launching K3 once in
    data2vec's EMA teacher and nothing elsewhere, finite losses, the last two
    timed (ms, audio-s/s, peak memory); one more profiled (idle share,
    "not valid" where kernels overlap on streams);
    data2vec's teacher K3 against its plain version at the step's shapes,
    and again after an EMA moved the teacher (the launch reads the moved
    weights); one update of each against the CPU on B=2 x 1.5-2 s with the
    same draws and dropouts 0 (loss and gradient norm at rtol 1e-3,
    gradients at cosine > 0.999; the update, step and post_update, against
    its replay on the CPU from the card's gradients, each tensor's change
    within 1e-3 in norm);
    PretrainHubert's prepare_units on a minute of audio (the units against
    its centroids; k-means card vs CPU from one init); a whole
    PretrainData2Vec Problem.run of 2 steps (K3 twice) and hub.load
    ("data2vec", ckpt=<its train dir>) on the card against the trained
    student.
18. Parallelism (`parallel_phase`): two ranks spawned over gloo (a
    ``file://`` store) that share the one card, each case on every rank
    against the same computation by that process alone: (a) dp = 2, the
    Trainer on HuBERT-Large int8 + flash, frozen, an UtteranceLevel probe,
    2 steps on a global B=8 x 10 s (losses at rtol 1e-4, the probe's
    weights at max abs 5e-4; K3 once and K1 / K2 24 times a step on each
    rank); (b) tp = 2, HuBERT-Large and WavLM-Large bf16 + flash on B=4 x
    10 s (per-layer cosine >= 0.999 against the tp = 1 forward; K7, then
    K9, 24 times a forward on each rank, K3 once); (c) sp = 2,
    sequence_sharded_extraction of HuBERT-Large bf16 without flash (K3 once
    on each rank's samples) and HuBERT-Base f32 (the group-norm statistics
    all-reduced) on B=2 x 30 s of ragged lengths (lengths equal, cosine >=
    0.999 and max abs 1e-3); (d) ``dryrun_multichip(2)`` as a user calls
    it (its own spawn: on a one-card host two ranks sharing the card over
    gloo), dp = 1 x tp = 2, against one process (loss at rtol 1e-4). Case (a)'s one-process reference runs its frozen upstream on the
    ranks' row groups (`halves_step`), and logs its step with one B=8
    forward (held at rtol 1e-2: the stock bf16 ops round otherwise at
    another batch shape). Each case's ms and
    peak memory a rank are printed, labelled as two ranks sharing one card
    (not scaling figures).
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SR = 16000
MAX_ABS_ERR = 3e-2
COS_KERNEL = 0.9995
COS_LAYER = 0.999


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def compare(got, want):
    """(cosine, max abs error) of two tensors, in f64 on the card."""
    a, b = got.double().flatten(), want.double().flatten()
    cos = float(a @ b / (a.norm() * b.norm()))
    return cos, float((a - b).abs().max())


def within_tolerance(got, want):
    """Largest error over its elementwise bound max(3e-2, one bf16 step at
    the plain value). Two bf16 results whose f32 sums differ in order can
    round one step apart; at |v| >= 4 (LayerNorm outputs' tails) one step
    is 0.03125, beyond the 3e-2 that holds below it."""
    w = want.double()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.double() - w).abs() / step.clamp_min(MAX_ABS_ERR)).max())


def cuda_ms(fn, iters):
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_inputs(B, T, gen, dev, C=1024, F=4096, H=16):
    """Main-path-shaped inputs for the kernels (HuBERT-Large widths by
    default); the int8 weights are the (codes, scales) pairs of the same
    bf16 weights, as the load-time cache holds them."""
    from s3prl_tpu_torch.ops.quant import as_quantized_cols

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    bf = torch.bfloat16
    inp = dict(
        wav=rnd(B, 10 * SR, dtype=bf), conv_w=rnd(512, 1, 10, scale=10 ** -0.5, dtype=bf),
        conv_g=1 + rnd(512, scale=0.1), conv_b=rnd(512, scale=0.1),
        x=rnd(B, T, C, scale=0.5, dtype=bf),
        wq=rnd(3 * C, C, scale=C ** -0.5, dtype=bf), bq=rnd(3 * C, scale=0.02),
        wo=rnd(C, C, scale=C ** -0.5, dtype=bf), bo=rnd(C, scale=0.02),
        ln=(1 + rnd(C, scale=0.1), rnd(C, scale=0.1)),
        kv=torch.tensor(([T, T, (T * 5) // 8, 1] * B)[:B], dtype=torch.int32, device=dev),
        w1=rnd(F, C, scale=C ** -0.5, dtype=bf), b1=rnd(F, scale=0.02),
        w2=rnd(C, F, scale=F ** -0.5, dtype=bf), b2=rnd(C, scale=0.02), H=H)
    inp["res"] = {n: rnd(B, T, n, scale=0.5, dtype=bf) for n in (3 * C, C)}  # K12's residuals
    for name in ("wq", "wo", "w1", "w2"):
        inp[name + "8"] = as_quantized_cols(inp[name])
    return inp


FFN_FLAGS = ((True, True, False), (False, False, False), (True, False, False),
             (False, True, False), (True, True, True))
# K12's (ln, residual) sets; the first two are the main path's QKV and out-proj
K12_SETS = ((True, False), (False, True), (False, False), (True, True))


def kernel_calls(inp, inp_base=None):
    """name -> [(variant, kernel call, plain call)] over the same inputs;
    each name's first variant is the one its main path runs. `inp_base`
    (HuBERT-Base widths) adds K2's one-chunk postnorm case."""
    from s3prl_tpu_torch.kernels import conv_frontend as k3
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4

    i = inp
    conv = (i["wav"], i["conv_w"], i["conv_g"], i["conv_b"])
    attn = (i["x"], i["wq"], i["bq"], i["ln"], i["wo"], i["bo"], i["kv"], i["H"])
    attn8 = (i["x"], i["wq8"], i["bq"], i["ln"], i["wo8"], i["bo"], i["kv"], i["H"])
    ffn = (i["x"], i["w1"], i["b1"], i["w2"], i["b2"])
    ffn8 = (i["x"], i["w18"], i["b1"], i["w28"], i["b2"])
    calls = {
        "conv0_ln_gelu": [
            (mode, lambda m=mode: k3.conv0_ln_gelu(*conv, gelu_mode=m),
             lambda m=mode: k3.conv0_ln_gelu_reference(*conv, gelu_mode=m))
            for mode in ("tanh", "erf")],
        "fused_attention_block": [
            (name, lambda p=p: k4.fused_attention_block(*attn8, postnorm=p),
             lambda p=p: k4.fused_attention_block_reference(*attn8, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_int8_ffn": [],
        "fused_attention_block_bf16": [
            (name, lambda p=p: k4.fused_attention_block_bf16(*attn, postnorm=p),
             lambda p=p: k4.fused_attention_block_bf16_reference(*attn, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_bf16_ffn": [],
        "fused_int8_linear": [],
    }
    for ln, res in K12_SETS:
        w, b = (i["wq8"], i["bq"]) if ln else (i["wo8"], i["bo"])
        kw = dict(ln=i["ln"] if ln else None, residual=i["res"][w[0].shape[0]] if res else None)
        calls["fused_int8_linear"].append((
            f"ln={ln} residual={res} N={w[0].shape[0]}",
            lambda w=w, b=b, kw=kw: k5.fused_int8_linear(i["x"], w, b, **kw),
            lambda w=w, b=b, kw=kw: k5.fused_int8_linear_reference(i["x"], w, b, **kw)))
    for ln, res, post in FFN_FLAGS:
        kw = dict(ln=i["ln"] if ln else None, residual=res, postnorm=post)
        name = f"ln={ln} residual={res} postnorm={post}"
        calls["fused_int8_ffn"].append((
            name + " F=4096", lambda kw=kw: k5.fused_int8_ffn(*ffn8, **kw),
            lambda kw=kw: k5.fused_int8_ffn_reference(*ffn8, **kw)))
        calls["fused_bf16_ffn"].append((
            name, lambda kw=kw: k5.fused_bf16_ffn(*ffn, **kw),
            lambda kw=kw: k5.fused_bf16_ffn_reference(*ffn, **kw)))
    if inp_base is not None:
        b = inp_base
        ffn8b = (b["x"], b["w18"], b["b1"], b["w28"], b["b2"])
        kw = dict(ln=b["ln"], residual=True, postnorm=True)
        calls["fused_int8_ffn"].append((
            "ln=True residual=True postnorm=True C=768 F=3072",
            lambda: k5.fused_int8_ffn(*ffn8b, **kw),
            lambda: k5.fused_int8_ffn_reference(*ffn8b, **kw)))
    return calls


KV_EDGES = (1, 63, 64, 65, 127, 128)  # kv_lens on and beside the 64-key tile edges


def long_inputs(B, T, gen, dev, C=1024, H=16, edges=False):
    """K6/K7 inputs at [B, T] (unit-scale fused QKV, the residual, the
    out-proj's int8 pair, kv_lens [T, T, 5T/8, 1, ...] or with `edges` [T,
    1, 63, 64, 65, 127, 128, T, ...], the edges below T) and K8's [B, H, T,
    64] q (pre-scaled), k, v split from the same QKV as K7 splits it beyond
    MAX_KERNEL_T."""
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.ops.quant import as_quantized_cols

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    kv = [T] + [n for n in KV_EDGES if n < T] if edges else [T, T, (T * 5) // 8, 1]
    inp = dict(qkv=rnd(B, T, 3 * C), x=rnd(B, T, C, scale=0.5),
               wo8=as_quantized_cols(rnd(C, C, scale=C ** -0.5, dtype=torch.float32)),
               bo=rnd(C, scale=0.02, dtype=torch.float32),
               kv=torch.tensor([kv[i % len(kv)] for i in range(B)], dtype=torch.int32,
                               device=dev), H=H)
    inp["q"], inp["k"], inp["v"] = fa._split_heads(inp["qkv"], H)
    return inp


def long_kernel_calls(inps, inps8):
    """K6, K7 on each of `inps` and K8 on each of `inps8` (`long_inputs`):
    name -> [(variant, kernel, plain)]."""
    from s3prl_tpu_torch.kernels import flash_attention as fa

    def k6(i):
        return i["qkv"], i["x"], i["wo8"], i["bo"], i["kv"], i["H"]

    def k8(j):
        return j["q"], j["k"], j["v"], j["kv"]

    def label(i, shape):
        return f"{shape} kv {i['kv'].tolist()[:7]}"

    return {
        "fused_qkv_attention_outproj": [
            (label(i, f"T={i['qkv'].shape[1]}"),
             lambda a=k6(i): fa.fused_qkv_attention_outproj(*a),
             lambda a=k6(i): fa.fused_qkv_attention_outproj_reference(*a)) for i in inps],
        "fused_qkv_attention": [
            (label(i, f"T={i['qkv'].shape[1]}"),
             lambda i=i: fa.fused_qkv_attention(i["qkv"], i["kv"], i["H"]),
             lambda i=i: fa.fused_qkv_attention_reference(i["qkv"], i["kv"], i["H"]))
            for i in inps],
        "online_flash_attention": [
            (label(j, list(j["q"].shape)), lambda a=k8(j): fa.online_flash_attention(*a),
             lambda a=k8(j): fa.online_flash_attention_reference(*a)) for j in inps8],
    }


def gated_bias(B, T, gen, dev, H=16, form="bf16"):
    """A pos_bias [H, T, T] gathered from WavLM's bucket table (320 buckets
    up to distance 800) with a random [320, H] table, and gates in (1, 3).
    `form` "bf16": the table rounded to bf16 and gathered into [H, T, Tp]
    (Tp = T rounded up to 8), the view [:, :, :T], as the bf16 model's
    `WavLMEncoder._layer_args` builds it for K9/K10; "f32-pad4": f32
    gathered likewise with Tp = T rounded up to 4, as the ``wavlm_fuse``
    model builds it for K11; "f32": contiguous f32."""
    from s3prl_tpu_torch.models.wavlm import bucket_table

    table = (torch.randn(320, H, generator=gen) * 0.5).to(dev)
    if form in ("bf16", "f32-pad4"):
        step, dtype = (8, torch.bfloat16) if form == "bf16" else (4, torch.float32)
        Tp = -(-T // step) * step
        pos_bias = table.t().to(dtype)[:, bucket_table(T, 320, 800, dev, cols=Tp)]
        pos_bias = pos_bias[:, :, :T]
    else:
        pos_bias = table.t()[:, bucket_table(T, 320, 800, dev)].contiguous()
    return dict(pos_bias=pos_bias, gate=(1 + 2 * torch.rand(B, H, T, generator=gen)).to(dev))


def gated_inputs(B, T, gen, dev, H=16, form="bf16", edges=False):
    """K9/K10 inputs at WavLM-Large's widths: q (pre-scaled), k, v split
    from a unit-scale fused QKV as the model splits it, `gated_bias` in
    `form` and kv_lens [T, T, 5T/8, 1, ...], or with `edges` [T, 1, 63, 64,
    65, 127, 128, T, ...] (the edges below T)."""
    from s3prl_tpu_torch.kernels import flash_attention as fa

    qkv = torch.randn(B, T, 3 * H * 64, generator=gen).to(dev, torch.bfloat16)
    q, k, v = fa._split_heads(qkv, H)
    kv = [T] + [n for n in KV_EDGES if n < T] if edges else [T, T, (T * 5) // 8, 1]
    return dict(q=q, k=k, v=v, **gated_bias(B, T, gen, dev, H, form),
                kv=torch.tensor([kv[i % len(kv)] for i in range(B)], dtype=torch.int32,
                                device=dev))


def k11_inputs(B, T, gen, dev, H=16, form="f32-pad4", edges=False):
    """K11 inputs at WavLM-Large's widths: `long_inputs` (the unit-scale
    fused QKV, the residual, the out-proj's int8 pair, ragged kv_lens or
    with `edges` the 64-key tile edges, and the split heads) with
    `gated_bias` in f32, padded as the ``wavlm_fuse`` model pads it
    ("f32-pad4") or contiguous ("f32")."""
    return {**long_inputs(B, T, gen, dev, C=H * 64, H=H, edges=edges),
            **gated_bias(B, T, gen, dev, H, form)}


def k11_calls(inps):
    """K11 on each of `inps`: name -> [(variant, kernel, plain)]."""
    from s3prl_tpu_torch.kernels import flash_attention as fa

    def args(i):
        return i["qkv"], i["x"], i["pos_bias"], i["gate"], i["wo8"], i["bo"], i["kv"], i["H"]

    return {"gated_bias_attention_outproj": [
        (f"T={i['qkv'].shape[1]} f32 bias rows {i['pos_bias'].stride(1)} apart, kv "
         f"{i['kv'].tolist()[:7]}", lambda a=args(i): fa.gated_bias_attention_outproj(*a),
         lambda a=args(i): fa.gated_bias_attention_outproj_reference(*a)) for i in inps]}


def split_pairs(inp, inp11):
    """The stock pairs that K12 and K11 replace on the default paths, on the
    same inputs as their timing: the long route's f32 LN rounded to bf16
    and int8_matmul QKV; int8_matmul out-proj and the residual; WavLM's
    heads split, K9, heads merged, int8_matmul out-proj and the residual."""
    import torch.nn.functional as F

    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.ops.quant import int8_matmul

    x, (g, b), bf = inp["x"], inp["ln"], torch.bfloat16
    j = inp11
    B, T, C = j["x"].shape

    def k11_split():
        out = fa.gated_bias_attention(*fa._split_heads(j["qkv"], j["H"]), j["pos_bias"],
                                      j["gate"], j["kv"])
        return j["x"] + int8_matmul(out.transpose(1, 2).reshape(B, T, C), j["wo8"], j["bo"])

    return {
        "fused_int8_linear": [
            ("ln=True residual=False N=3072: LN + int8_matmul QKV",
             lambda: int8_matmul(F.layer_norm(x.float(), (x.shape[-1],), g, b, 1e-5).to(bf),
                                 inp["wq8"], inp["bq"], out_dtype=bf)),
            ("ln=False residual=True N=1024: int8_matmul out-proj + residual",
             lambda: inp["res"][x.shape[-1]] + int8_matmul(x, inp["wo8"], inp["bo"]))],
        "gated_bias_attention_outproj": [
            ("heads split + K9 + merge + int8_matmul out-proj + residual", k11_split)],
    }


def gated_variant(i):
    """A K9/K10 variant's label: the shape, the bias's dtype and row stride,
    the kv_lens."""
    return (f"{list(i['q'].shape)} {str(i['pos_bias'].dtype)[6:]} bias rows "
            f"{i['pos_bias'].stride(1)} apart, kv {i['kv'].tolist()[:7]}")


def gated_kernel_calls(inps9, inps10):
    """K9 on each of `inps9`, K10 on each of `inps10`: name -> [(variant,
    kernel, plain)]."""
    from s3prl_tpu_torch.kernels import flash_attention as fa

    def args(i):
        return i["q"], i["k"], i["v"], i["pos_bias"], i["gate"], i["kv"]

    return {
        "gated_bias_attention": [
            (gated_variant(i), lambda a=args(i): fa.gated_bias_attention(*a),
             lambda a=args(i): fa.gated_bias_attention_reference(*a)) for i in inps9],
        "gated_online_flash_attention": [
            (gated_variant(i), lambda a=args(i): fa.gated_online_flash_attention(*a),
             lambda a=args(i): fa.gated_online_flash_attention_reference(*a)) for i in inps10],
    }


def base_kernel_calls(gen, dev, C=768, F=3072, H=12, gated=True):
    """The post-LN kernel forms at the Base models' widths (C 768, H 12, F
    3,072), or at data2vec-Large's (C 1,024, H 16, F 4,096; ``gated``
    False): K1 and K4 postnorm at B=32 x 499; K2 and K5 postnorm, and K2
    bare (WavLM-Base's FFN), at 32 x 499 rows; K6 at [8, 1,499] on a QKV made
    from raw x (int8_matmul of the unit-scale residual, HuBERT-Base's and
    data2vec's long route); with ``gated`` K9 at [32, 12, 499, 64] with the
    bf16 model's padded bf16 bias and K11 at [32, 499, 768] with the
    ``wavlm_fuse`` model's f32 one. The residual stream x is unit-scale, as
    a post-LN layer's input is (an LN output). Returns (name -> [(variant,
    kernel, plain)], name -> the input dict of its bound)."""
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4
    from s3prl_tpu_torch.ops.quant import int8_matmul

    i = kernel_inputs(32, 499, gen, dev, C=C, F=F, H=H)
    i["x"] = torch.randn(i["x"].shape, generator=gen).to(dev, torch.bfloat16)
    attn = (i["x"], i["wq"], i["bq"], i["ln"], i["wo"], i["bo"], i["kv"], i["H"])
    attn8 = (i["x"], i["wq8"], i["bq"], i["ln"], i["wo8"], i["bo"], i["kv"], i["H"])
    ffn = (i["x"], i["w1"], i["b1"], i["w2"], i["b2"])
    ffn8 = (i["x"], i["w18"], i["b1"], i["w28"], i["b2"])
    post = dict(ln=i["ln"], residual=True, postnorm=True)
    j = long_inputs(8, 1499, gen, dev, C=C, H=H)
    j["x"] = torch.randn(j["x"].shape, generator=gen).to(dev, torch.bfloat16)
    wq8, bq = i["wq8"], i["bq"]
    j["qkv"] = int8_matmul(j["x"], wq8, bq, out_dtype=torch.bfloat16)
    k6 = (j["qkv"], j["x"], j["wo8"], j["bo"], j["kv"], j["H"])
    width = f"C={C} H={H}"
    calls = {
        "fused_attention_block": [(
            f"postnorm {width}", lambda: k4.fused_attention_block(*attn8, postnorm=True),
            lambda: k4.fused_attention_block_reference(*attn8, postnorm=True))],
        "fused_attention_block_bf16": [(
            f"postnorm {width}", lambda: k4.fused_attention_block_bf16(*attn, postnorm=True),
            lambda: k4.fused_attention_block_bf16_reference(*attn, postnorm=True))],
        "fused_int8_ffn": [
            (f"postnorm C={C} F={F}", lambda: k5.fused_int8_ffn(*ffn8, **post),
             lambda: k5.fused_int8_ffn_reference(*ffn8, **post)),
            (f"bare C={C} F={F}", lambda: k5.fused_int8_ffn(*ffn8),
             lambda: k5.fused_int8_ffn_reference(*ffn8))],
        "fused_bf16_ffn": [(
            f"postnorm C={C} F={F}", lambda: k5.fused_bf16_ffn(*ffn, **post),
            lambda: k5.fused_bf16_ffn_reference(*ffn, **post))],
        "fused_qkv_attention_outproj": [(
            f"QKV from raw x {width}", lambda: k4.fused_qkv_attention_outproj(*k6),
            lambda: k4.fused_qkv_attention_outproj_reference(*k6))],
    }
    inputs = {name: i for name in ("fused_attention_block", "fused_attention_block_bf16",
                                   "fused_int8_ffn", "fused_bf16_ffn")}
    inputs.update(fused_qkv_attention_outproj=j)
    if gated:
        g = gated_inputs(32, 499, gen, dev, H=H)
        k9 = (g["q"], g["k"], g["v"], g["pos_bias"], g["gate"], g["kv"])
        h = k11_inputs(32, 499, gen, dev, H=H)
        k11 = (h["qkv"], h["x"], h["pos_bias"], h["gate"], h["wo8"], h["bo"], h["kv"], h["H"])
        calls["gated_bias_attention"] = [(
            gated_variant(g), lambda: k4.gated_bias_attention(*k9),
            lambda: k4.gated_bias_attention_reference(*k9))]
        calls["gated_bias_attention_outproj"] = [(
            f"{width} f32 bias", lambda: k4.gated_bias_attention_outproj(*k11),
            lambda: k4.gated_bias_attention_outproj_reference(*k11))]
        inputs.update(gated_bias_attention=g, gated_bias_attention_outproj=h)
    return calls, inputs


def zero_kv(B, T, dev):
    """kv_lens [T, 0, 5T/8, 0, ...]: every other utterance has no valid key
    (an utterance under 400 samples has no frame under the conv rule)."""
    return torch.tensor([(T, 0, (T * 5) // 8, 0)[b % 4] for b in range(B)], dtype=torch.int32,
                        device=dev)


def zero_kv_calls(gen, dev):
    """Every attention kernel on the main paths' shapes with utterances of
    kv_len 0 (`zero_kv`): K1 and K4 pre-LN and postnorm at [4, 499], K6 and
    K7 at [4, 1,499], K8 on [2, 16, 2999, 64], K9 (the padded bf16 bias) and
    K17 on [4, 16, 499, 64], K10 on [2, 16, 2999, 64], K11 at [4, 499]; and
    K2 (LN + residual, postnorm, bare) on the rows such an utterance gives
    it: one utterance all zero rows, one a single repeated row."""
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4

    i = kernel_inputs(4, 499, gen, dev)
    i["kv"] = zero_kv(4, i["x"].shape[1], dev)
    attn = (i["x"], i["wq"], i["bq"], i["ln"], i["wo"], i["bo"], i["kv"], i["H"])
    attn8 = (i["x"], i["wq8"], i["bq"], i["ln"], i["wo8"], i["bo"], i["kv"], i["H"])
    x2 = i["x"].clone()
    x2[1] = 0
    x2[3] = x2[3, :1]
    ffn8 = (x2, i["w18"], i["b1"], i["w28"], i["b2"])
    j = long_inputs(4, 1499, gen, dev)
    j8 = long_inputs(2, 2999, gen, dev)
    g, g10 = gated_inputs(4, 499, gen, dev), gated_inputs(2, 2999, gen, dev)
    h = k11_inputs(4, 499, gen, dev)
    for d in (j, j8, g, g10, h):  # each holds the split heads q [B, H, T, 64]
        d["kv"] = zero_kv(d["q"].shape[0], d["q"].shape[2], dev)
    k6 = (j["qkv"], j["x"], j["wo8"], j["bo"], j["kv"], j["H"])
    k11 = (h["qkv"], h["x"], h["pos_bias"], h["gate"], h["wo8"], h["bo"], h["kv"], h["H"])

    def gated(d):
        return d["q"], d["k"], d["v"], d["pos_bias"], d["gate"], d["kv"]

    def split(d):
        return d["q"], d["k"], d["v"], d["kv"]

    zero = f"kv {i['kv'].tolist()}"
    return {
        "fused_attention_block": [
            (f"{name} {zero}", lambda p=p: k4.fused_attention_block(*attn8, postnorm=p),
             lambda p=p: k4.fused_attention_block_reference(*attn8, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_attention_block_bf16": [
            (f"{name} {zero}", lambda p=p: k4.fused_attention_block_bf16(*attn, postnorm=p),
             lambda p=p: k4.fused_attention_block_bf16_reference(*attn, postnorm=p))
            for name, p in (("pre-LN", False), ("postnorm", True))],
        "fused_int8_ffn": [
            (f"{name} on zero and repeated rows", lambda kw=kw: k5.fused_int8_ffn(*ffn8, **kw),
             lambda kw=kw: k5.fused_int8_ffn_reference(*ffn8, **kw))
            for name, kw in (("ln residual", dict(ln=i["ln"], residual=True)),
                             ("postnorm", dict(ln=i["ln"], residual=True, postnorm=True)),
                             ("bare", {}))],
        "fused_qkv_attention_outproj": [(
            f"T={j['x'].shape[1]} kv {j['kv'].tolist()}",
            lambda: k4.fused_qkv_attention_outproj(*k6),
            lambda: k4.fused_qkv_attention_outproj_reference(*k6))],
        "fused_qkv_attention": [(
            f"T={j['x'].shape[1]} kv {j['kv'].tolist()}",
            lambda: k4.fused_qkv_attention(j["qkv"], j["kv"], j["H"]),
            lambda: k4.fused_qkv_attention_reference(j["qkv"], j["kv"], j["H"]))],
        "online_flash_attention": [(
            f"{list(j8['q'].shape)} kv {j8['kv'].tolist()}",
            lambda: k4.online_flash_attention(*split(j8)),
            lambda: k4.online_flash_attention_reference(*split(j8)))],
        "gated_bias_attention": [(
            gated_variant(g), lambda: k4.gated_bias_attention(*gated(g)),
            lambda: k4.gated_bias_attention_reference(*gated(g)))],
        "gated_online_flash_attention": [(
            gated_variant(g10), lambda: k4.gated_online_flash_attention(*gated(g10)),
            lambda: k4.gated_online_flash_attention_reference(*gated(g10)))],
        "gated_bias_attention_outproj": [(
            f"T={h['x'].shape[1]} kv {h['kv'].tolist()}",
            lambda: k4.gated_bias_attention_outproj(*k11),
            lambda: k4.gated_bias_attention_outproj_reference(*k11))],
        "flash_attention": [(
            f"{list(g['q'].shape)} kv {g['kv'].tolist()}",
            lambda: k4.flash_attention(*split(g)),
            lambda: k4.flash_attention_reference(*split(g)))],
    }


def time_base_kernels(calls, inputs):
    """Each Base-width kernel of `base_kernel_calls` beside its plain
    version (in turns) and its bound, on a line of its own (not in the
    kernels line: its main-path entry is the Large models' shape)."""
    for name, variants in calls.items():
        for variant, kernel, plain in variants:
            t = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
            bound_ms, bound_by = kernel_bound(name, inputs[name])
            shape = inputs[name]["x"].shape[:2] if "x" in inputs[name] else \
                inputs[name]["q"].shape[:3]
            log(f"[timing] base width {name} {variant} {list(shape)}: kernel "
                f"{(t[1] + t[2]) / 2:.3f} ms, plain {(t[0] + t[3]) / 2:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")


def posconv_inputs(B, T, gen, dev, C=1024, G=16, k=128):
    """K16a/K16b inputs at HuBERT-Large's pos-conv widths: x [B, T, C] in
    bf16 (scale 0.5), an f32 nn.Conv1d weight [C, C/G, k] with its
    load-time forms (K16a's bf16 tap-major GEMM weight, K16b's codes and
    scales), a bias."""
    from s3prl_tpu_torch.kernels import posconv as pc

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    w = rnd(C, C // G, k, scale=(k * C // G) ** -0.5)
    return dict(x=rnd(B, T, C, scale=0.5, dtype=torch.bfloat16), w=w, bias=rnd(C, scale=0.1),
                wg=pc.posconv_gemm_weight(w.to(torch.bfloat16), G),
                w8=pc.quantize_posconv_weight(w, G), G=G)


def posconv_calls(inps):
    """K16a and K16b on each of `inps`: name -> [(variant, kernel, plain)]."""
    from s3prl_tpu_torch.kernels import posconv as pc

    calls = {"pos_conv_gelu": [], "pos_conv_gelu_q8": []}
    for i in inps:
        x, G = i["x"], i["G"]
        calls["pos_conv_gelu"].append((
            str(list(x.shape)), lambda i=i: pc.pos_conv_gelu(i["x"], i["wg"], i["bias"], G),
            lambda i=i: pc.pos_conv_gelu_reference(i["x"], i["wg"], i["bias"], G)))
        calls["pos_conv_gelu_q8"].append((
            str(list(x.shape)), lambda i=i: pc.pos_conv_gelu_q8(i["x"], i["w8"], i["bias"], G),
            lambda i=i: pc.pos_conv_gelu_q8_reference(i["x"], *i["w8"], i["bias"], G)))
    return calls


def check_posconv_codes(inps):
    """K16b's activation codes and scales against the plain version's: the
    quantizer's (`posconv_quant`) and the codes the conv kernel writes into
    its windows (test mode, with the scales of its scale pass): codes equal
    except at most 0.1% one step apart, scales at rtol 1e-5 (the share is
    printed)."""
    from s3prl_tpu_torch.kernels import posconv as pc

    for i in inps:
        q_ref, xs_ref = pc.quantize_posconv_input(i["x"], i["G"])
        in_conv = pc.pos_conv_gelu_q8(i["x"], i["w8"], i["bias"], i["G"], codes=True)[1:]
        for what, (q, xs) in (("posconv_quant", pc.posconv_quant(i["x"], i["G"])),
                              ("the conv's windows", in_conv)):
            torch.cuda.synchronize()
            d = (q.int() - q_ref.int()).abs()
            share = float((d > 0).float().mean())
            rel = float(((xs - xs_ref).abs() / xs_ref).max())
            log(f"[int8 codes] pos_conv_gelu_q8 activations {list(q.shape)}, {what}: "
                f"{share:.3e} of codes differ from the plain version's (max {int(d.max())} "
                f"step), scales rel err {rel:.2e}")
            check(int(d.max()) <= 1 and share <= 1e-3 and rel <= 1e-5,
                  f"K16b activation codes ({what})")


def k17_calls(inps):
    """K17 on the split heads of each of `inps` (`gated_inputs`, without the
    bias)."""
    from s3prl_tpu_torch.kernels import flash_attention as fa

    def args(i):
        return i["q"], i["k"], i["v"], i["kv"]

    return {"flash_attention": [
        (f"{list(i['q'].shape)} kv {i['kv'].tolist()[:7]}",
         lambda a=args(i): fa.flash_attention(*a),
         lambda a=args(i): fa.flash_attention_reference(*a)) for i in inps]}


HBM = 3.35e12  # bytes/s, H100 SXM (NVIDIA's data sheet)
PEAK = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}  # dense, per second


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, moved):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of `moved` bytes over its memory rate and the operations
    (type -> count) over the peak rates of their types."""
    t_ops = sum(n / PEAK[kind] for kind, n in ops.items())
    t_bytes = moved / HBM
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def attention_work(B, T, H, kv, Dh=64):
    """FLOP of Q.K^T and P.V over the keys these kv_lens leave valid."""
    return 4 * Dh * H * T * sum(min(n, T) for n in kv)


def conv0_ops(wav):
    """The type K3 / K13a's conv products run in: bf16 on the tensor cores
    for bf16 waves, f32 FMAs for f32 waves."""
    return "bf16" if wav.dtype == torch.bfloat16 else "f32"


def kernel_bound(name, i, variant=0):
    """The bound of kernel `name` on the timing inputs `i` (each input byte
    read once, each output byte written once; K/V rows past kv_len and
    their work not counted); `variant` indexes K12_SETS for K12."""
    if name in ("pos_conv_gelu", "pos_conv_gelu_q8"):  # 2 B T k cg C, x read, out written
        B, T, C = i["x"].shape
        ops = 2 * B * T * i["w"].shape[-1] * (C // i["G"]) * C
        if name == "pos_conv_gelu":
            return bound({"bf16": ops}, 2 * nbytes(i["x"]) + nbytes(i["wg"], i["bias"]))
        return bound({"int8": ops}, 2 * nbytes(i["x"]) + nbytes(*i["w8"], i["bias"]))
    kv = i["kv"].tolist()
    if name == "conv0_ln_gelu":
        B, N = i["wav"].shape
        frames = (N - 10) // 5 + 1
        return bound({conv0_ops(i["wav"]): 2 * 10 * 512 * B * frames},
                     nbytes(i["wav"], i["conv_w"]) + B * frames * 512 * 2)
    if name == "gated_bias_attention_outproj":
        B, T, C3 = i["qkv"].shape
        C, H = C3 // 3, i["H"]
        ops = {"bf16": attention_work(B, T, H, kv), "f32": 2 * H * T * sum(kv),
               "int8": 2 * B * T * C * C}
        return bound(ops, nbytes(i["qkv"], i["x"], i["gate"], *i["wo8"], i["bo"])
                     + B * T * C * 2 + H * T * max(kv) * i["pos_bias"].element_size())
    if name in ("gated_bias_attention", "gated_online_flash_attention"):
        B, H, T, Dh = i["q"].shape
        valid_kv = sum(kv) * H * Dh * 2
        return bound({"bf16": attention_work(B, T, H, kv), "f32": 2 * H * T * sum(kv)},
                     2 * nbytes(i["q"]) + 2 * valid_kv
                     + H * T * max(kv) * i["pos_bias"].element_size() + nbytes(i["gate"]))
    if name in ("online_flash_attention", "flash_attention"):
        B, H, T, Dh = i["q"].shape
        return bound({"bf16": attention_work(B, T, H, kv)},
                     2 * nbytes(i["q"]) + 2 * sum(kv) * H * Dh * 2)
    if name in ("fused_qkv_attention", "fused_qkv_attention_outproj"):
        B, T, C3 = i["qkv"].shape
        C, H = C3 // 3, i["H"]
        ops = {"bf16": attention_work(B, T, H, kv)}
        moved = nbytes(i["qkv"]) + B * T * C * 2
        if name == "fused_qkv_attention_outproj":
            ops["int8"] = 2 * B * T * C * C
            moved += nbytes(i["x"], *i["wo8"], i["bo"])
        return bound(ops, moved)
    B, T, C = i["x"].shape
    M, H = B * T, i["H"]
    if name == "fused_int8_linear":
        ln, res = K12_SETS[variant]
        w, b = (i["wq8"], i["bq"]) if ln else (i["wo8"], i["bo"])
        N = w[0].shape[0]
        moved = nbytes(i["x"], *w, b) + M * N * 2
        moved += nbytes(*i["ln"]) if ln else 0
        moved += nbytes(i["res"][N]) if res else 0
        return bound({"int8": 2 * M * C * N}, moved)
    if name in ("fused_int8_ffn", "fused_bf16_ffn"):
        F = i["w1"].shape[0]
        if name == "fused_int8_ffn":
            ops, w = {"int8": 4 * M * C * F}, (*i["w18"], *i["w28"])
        else:
            ops, w = {"bf16": 4 * M * C * F}, (i["w1"], i["w2"])
        return bound(ops, 2 * nbytes(i["x"]) + nbytes(*w, i["b1"], i["b2"], *i["ln"]))
    attn = attention_work(B, T, H, kv)  # the QKV and out-proj GEMMs: 8 M C^2
    if name == "fused_attention_block":
        ops, w = {"int8": 8 * M * C * C, "bf16": attn}, (*i["wq8"], *i["wo8"])
    else:
        ops, w = {"bf16": 8 * M * C * C + attn}, (i["wq"], i["wo"])
    return bound(ops, 2 * nbytes(i["x"]) + nbytes(*w, i["bq"], i["bo"], *i["ln"]))


def library_call(name, i):
    """One scaled_dot_product_attention on the same bf16 q, k, v as kernel
    `name` (K7-K10), with its mask built here, outside the timed region:
    a boolean key mask for K7 and K8; for K9 and K10 a float mask of q's
    dtype (SDPA's rule) holding gate * pos_bias, -inf at masked keys.
    For K16a and K16b one grouped bf16 F.conv1d with its bias on a [B, C,
    T] copy of x (the conv without the GELU). None for the kernels that no
    single PyTorch call computes."""
    import torch.nn.functional as F

    if name in ("pos_conv_gelu", "pos_conv_gelu_q8"):
        x = i["x"].transpose(1, 2).contiguous()
        w, b = i["w"].to(x.dtype), i["bias"].to(x.dtype)
        return lambda: F.conv1d(x, w, b, padding=w.shape[-1] // 2, groups=i["G"])
    kv = i["kv"]
    if name == "fused_qkv_attention":
        B, T, C3 = i["qkv"].shape
        q, k, v = (t.contiguous() for t in i["qkv"].view(B, T, 3, i["H"], -1).permute(
            2, 0, 3, 1, 4))
        scale = None  # K7's qkv is unscaled: SDPA's default Dh^-0.5
    elif name in ("online_flash_attention", "gated_bias_attention",
                  "gated_online_flash_attention", "flash_attention"):
        q, k, v = i["q"], i["k"], i["v"]
        scale = 1.0  # q pre-scaled
    else:
        return None
    T = q.shape[2]
    valid = torch.arange(T, device=q.device)[None, :] < kv[:, None]
    if name.startswith("gated"):
        mask = (i["gate"][..., None] * i["pos_bias"][None]).masked_fill(
            ~valid[:, None, None, :], float("-inf")).to(q.dtype)
    else:
        mask = valid[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)


def code_mismatch(inp, inp_long, inp11):
    """Share of int8 codes where the kernels' quantizers and the plain
    versions' differ, on the main path's inputs: K1's and K12's LN prologue
    and K1's bf16 context quantization on the panel kernel (its test mode),
    the context's on quant_rows.cu (the wide-row route), K2's LN prologue
    and its per-chunk requant of the fc1 output (each pair fed the same
    tensor), and K6's and K11's f32 contexts."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import ffn as k5
    from s3prl_tpu_torch.kernels import flash_attention as k4
    from s3prl_tpu_torch.ops.quant import int_mm, quantize_rows

    def share(a, b):
        return float((a != b).float().mean())

    x2 = inp["x"].view(-1, inp["x"].shape[-1])
    x8, xs = kc.quant_rows(x2, ln=inp["ln"])
    codes_plain = quantize_rows(kc.layer_norm_f32(x2, inp["ln"]))[0]
    wq8, bq = inp["wq8"], inp["bq"]
    out = {"K2 LN prologue (quant_rows.cu)": share(x8, codes_plain),
           "K1/K12 LN prologue (int8_panel.cu)": share(
               kc.int8_panel(x2, *wq8, bq, ln=inp["ln"], codes=True)[1], codes_plain)}
    qkv = (inp["x"].float() @ inp["wq"].float().t()).to(torch.bfloat16)
    ctx = k4.attention_reference(qkv, inp["kv"], inp["H"]).view(x2.shape)
    ctx_plain = k4.quantize_context_reference(ctx)[0]
    out["K1 context (bf16, int8_panel.cu)"] = share(
        kc.int8_panel(ctx, *inp["wo8"], inp["bo"], rule=kc.RULE_CTX, codes=True)[1], ctx_plain)
    out["K1 context (bf16, quant_rows.cu: the wide-row route)"] = share(
        kc.quant_rows_bf16(ctx)[0], ctx_plain)
    w1q, w1s = inp["w18"]
    h = kc.gemm_s8(x8, w1q, mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=w1s,
                   bias=inp["b1"], gelu=True, out_f32=True)
    h_plain = kc.gelu_tanh(int_mm(x8, w1q).float() * xs[:, None] * w1s + inp["b1"])
    diffs = []
    for lo, hi in k5._ffn_chunk_bounds(w1q.shape[0]):
        q, _ = kc.quant_rows(h, lo=lo, hi=hi)
        diffs.append(share(q[:, lo:hi], quantize_rows(h_plain[:, lo:hi])[0]))
    out["K2 chunk requant"] = sum(diffs) / len(diffs)
    qkv, kv, H = inp_long["qkv"], inp_long["kv"], inp_long["H"]
    ctx = k4._attention(qkv, kv, H, out_f32=True)
    ctx_plain = k4.attention_reference(qkv, kv, H, out_dtype=torch.float32).view(ctx.shape)
    codes_plain = quantize_rows(ctx_plain)[0]
    out["K6 context (f32 attention + f32 quantizer)"] = share(kc.quant_rows(ctx)[0], codes_plain)
    out["K6 f32 quantizer alone"] = share(kc.quant_rows(ctx_plain)[0], codes_plain)
    bias = (inp11["pos_bias"], inp11["gate"])
    qkv, kv, H = inp11["qkv"], inp11["kv"], inp11["H"]
    ctx = k4._attention(qkv, kv, H, out_f32=True, bias=bias)
    ctx_plain = k4.attention_reference(qkv, kv, H, out_dtype=torch.float32,
                                       bias=bias).view(ctx.shape)
    out["K11 context (gated f32 attention + f32 quantizer)"] = share(
        kc.quant_rows(ctx)[0], quantize_rows(ctx_plain)[0])
    return out


# (k, T) of the six mid layers' inputs at 10 s (160,000 samples): 31,999 frames
# after conv0, 499 after the last
MID = ((3, 31999), (3, 15999), (3, 7999), (3, 3999), (2, 1999), (2, 999))


def frontend_inputs(B, gen, dev, layers=range(len(MID))):
    """The front-end kernels' inputs at B x 10 s: the waves, conv0's weight
    and LN; per mid layer of MID (`layers` picks them) an f32 nn.Conv1d
    weight with its load-time forms (K14's tap-major GEMM weight, K13b's
    per-tap codes and scales), an LN pair, a unit-scale bf16 input [B, T,
    512], its row-quantized codes and scales, and K15's input [B, T', 512]
    (the layer's conv output, scale 2 and shifted)."""
    from s3prl_tpu_torch.kernels.conv_frontend import conv_gemm_weight, quantize_conv_taps
    from s3prl_tpu_torch.ops.quant import quantize_rows

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    bf = torch.bfloat16
    inp = dict(wav=rnd(B, 10 * SR, dtype=bf), w0=rnd(512, 1, 10, scale=10 ** -0.5, dtype=bf),
               ln0=(1 + rnd(512, scale=0.1), rnd(512, scale=0.1)), mid=[])
    for i in layers:
        k, T = MID[i]
        w = rnd(512, 512, k, scale=(512 * k) ** -0.5)
        x = rnd(B, T, 512, dtype=bf)
        xq, xs = quantize_rows(x)
        inp["mid"].append(dict(
            k=k, T=T, last=i == len(MID) - 1, w=w, wg=conv_gemm_weight(w.to(bf)),
            taps=quantize_conv_taps(w), ln=(1 + rnd(512, scale=0.1), rnd(512, scale=0.1)),
            x=x, xq=xq, xs=xs, y=rnd(B, (T - k) // 2 + 1, 512, scale=2, dtype=bf) + 0.3))
    return inp


def frontend_calls(inp, stack=False):
    """K14, K15 (tanh, then erf) and K13b's last-layer form (bf16 out) on
    each mid layer of `inp`: name -> [(variant, kernel, plain)]; with
    `stack`, one variant per name that runs the six layers as the paths do
    (K13b emits codes but in the last layer, K15 in tanh as on the int8
    path). K13a and K13b's codes: `frontend_q8_calls`."""
    from s3prl_tpu_torch.kernels import conv_frontend as cf
    from s3prl_tpu_torch.kernels import ln_gelu as lg

    def k14(m, fn):
        return fn(m["x"], m["wg"], *m["ln"])

    def k15(m, fn, mode):
        return fn(m["y"], *m["ln"], mode)

    def k13b(m, fn, emit_q8):
        return fn(m["xq"], m["xs"], m["taps"], *m["ln"], emit_q8=emit_q8)

    mid = inp["mid"]
    if stack:
        return {
            "fused_conv_ln_gelu": [("six layers", lambda: [k14(m, cf.fused_conv_ln_gelu)
                                                           for m in mid],
                                    lambda: [k14(m, cf.fused_conv_ln_gelu_reference)
                                             for m in mid])],
            "fused_int8_conv_ln_gelu": [
                ("six layers", lambda: [k13b(m, cf.fused_int8_conv_ln_gelu, not m["last"])
                                        for m in mid],
                 lambda: [k13b(m, cf.fused_int8_conv_ln_gelu_reference, not m["last"])
                          for m in mid])],
            "ln_gelu": [("six layers, tanh", lambda: [k15(m, lg.ln_gelu, "tanh") for m in mid],
                         lambda: [k15(m, lg.ln_gelu_reference, "tanh") for m in mid])],
        }
    calls = {"fused_conv_ln_gelu": [], "fused_int8_conv_ln_gelu": [], "ln_gelu": []}
    for m in mid:
        shape = f"[{m['x'].shape[0]}, {m['T']}, 512] k={m['k']}"
        calls["fused_conv_ln_gelu"].append((shape, lambda m=m: k14(m, cf.fused_conv_ln_gelu),
                                            lambda m=m: k14(m, cf.fused_conv_ln_gelu_reference)))
        calls["fused_int8_conv_ln_gelu"].append((
            shape + " bf16 out", lambda m=m: k13b(m, cf.fused_int8_conv_ln_gelu, False)[0],
            lambda m=m: k13b(m, cf.fused_int8_conv_ln_gelu_reference, False)[0]))
        for mode in ("tanh", "erf"):
            calls["ln_gelu"].append((
                f"{mode} {list(m['y'].shape)}", lambda m=m, mode=mode: k15(m, lg.ln_gelu, mode),
                lambda m=m, mode=mode: k15(m, lg.ln_gelu_reference, mode)))
    return calls


def frontend_q8_calls(inp):
    """K13a on the waves and K13b with codes out on each mid layer of `inp`:
    name -> [(variant, kernel, plain)], each returning (codes, scales)."""
    from s3prl_tpu_torch.kernels import conv_frontend as cf

    conv = (inp["wav"], inp["w0"], *inp["ln0"])
    return {
        "conv0_ln_gelu_q8": [(str(list(inp["wav"].shape)), lambda: cf.conv0_ln_gelu_q8(*conv),
                              lambda: cf.conv0_ln_gelu_q8_reference(*conv))],
        "fused_int8_conv_ln_gelu": [
            (f"[{m['x'].shape[0]}, {m['T']}, 512] k={m['k']} codes out",
             lambda m=m: cf.fused_int8_conv_ln_gelu(m["xq"], m["xs"], m["taps"], *m["ln"]),
             lambda m=m: cf.fused_int8_conv_ln_gelu_reference(m["xq"], m["xs"], m["taps"],
                                                              *m["ln"]))
            for m in inp["mid"]],
    }


def check_q8_kernels(calls, max_err):
    """Codes equal to the plain version's except at most 0.1% one step
    apart, scales at rtol 1e-5; the error recorded is that of the
    dequantized rows (codes x scales)."""
    for name, variants in calls.items():
        for variant, kernel, plain in variants:
            (q, s), (q_ref, s_ref) = kernel(), plain()
            torch.cuda.synchronize()
            check(q.shape == q_ref.shape and q.dtype == q_ref.dtype == torch.int8
                  and s.shape == s_ref.shape, f"{name} {variant}: {tuple(q.shape)} {q.dtype}")
            d = (q.int() - q_ref.int()).abs()
            share = float((d > 0).float().mean())
            rel = float(((s - s_ref).abs() / s_ref).max())
            err = float((q.float() * s - q_ref.float() * s_ref).abs().max())
            log(f"[kernel] {name} {variant} {tuple(q.shape)}: {share:.3e} of int8 codes differ "
                f"from the plain version's (max {int(d.max())} step), scales rel err "
                f"{rel:.2e}, dequantized max_abs_err {err:.3e}")
            check(int(d.max()) <= 1 and share <= 1e-3 and rel <= 1e-5, f"{name} {variant}")
            max_err[name] = max(max_err.get(name, 0.0), err)
            del q, s, q_ref, s_ref, d


def check_int8_conv_bits(inp):
    """csrc/int8_conv.cu (K13b) in its test mode on each mid layer of `inp`
    as the path runs it (codes out, bf16 rows in the last layer): the f32 tap
    sum bit-equal to `fused_int8_conv_taps_reference`, the LN statistics at
    rtol 1e-5 of torch's (summed in another order), and given them the codes
    and scales (or bf16 rows) bit-equal to the plain LN -> erf GELU ->
    quantize_rows (or cast). Then layer 1's peak device memory for one call
    of the wrapper beside the f32 tap sum the per-tap route kept in device
    memory (it must stay below)."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import conv_frontend as cf
    from s3prl_tpu_torch.ops.quant import quantize_rows

    B = inp["wav"].shape[0]
    for i, m in enumerate(inp["mid"]):
        what = f"int8_conv layer {i + 1} [{B}, {m['T']}, 512] k={m['k']}"
        out, scale, acc, stats = cf.int8_conv(m["xq"], m["xs"], *m["taps"], *m["ln"],
                                              emit_q8=not m["last"], sums=True)
        want = cf.fused_int8_conv_taps_reference(m["xq"], m["xs"], m["taps"]).view(-1, 512)
        torch.cuda.synchronize()
        check(torch.equal(acc, want), f"{what}: the f32 tap sum is not bit-equal")
        mean = want.mean(-1)
        rstd = 1.0 / torch.sqrt(((want - mean[:, None]) ** 2).mean(-1) + kc.LN_EPS)
        check(torch.allclose(stats[:, 0], mean, rtol=1e-5, atol=1e-6)
              and torch.allclose(stats[:, 1], rstd, rtol=1e-5), f"{what}: LN statistics")
        del want, mean, rstd
        y = kc.ln_gelu_from_stats(acc, stats, *m["ln"])
        if m["last"]:
            check(torch.equal(out.view(-1, 512), y.to(torch.bfloat16)),
                  f"{what}: bf16 rows not bit-equal given the kernel's statistics")
        else:
            q_ref, s_ref = quantize_rows(y)
            check(torch.equal(out.view(-1, 512), q_ref) and torch.equal(scale.view(-1, 1), s_ref),
                  f"{what}: codes and scales not bit-equal given the kernel's statistics")
            del q_ref, s_ref
        del out, scale, acc, stats, y
    log(f"[kernel] int8_conv (K13b) on the six mid layers of B={B} x 10 s: the f32 tap sums "
        "bit-equal to the plain version's, codes, scales and the last layer's bf16 rows "
        "bit-equal given the kernel's LN statistics")
    m = inp["mid"][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = cf.fused_int8_conv_ln_gelu(m["xq"], m["xs"], m["taps"], *m["ln"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    t_out = (m["T"] - m["k"]) // 2 + 1
    acc_bytes = B * t_out * 512 * 4
    log(f"[memory] fused_int8_conv_ln_gelu (K13b) layer 1 [{B}, {m['T']}, 512]: peak device "
        f"memory of one call {peak / 1e9:.4f} GB (its codes and scales "
        f"{B * t_out * (512 + 4) / 1e9:.4f} GB), against {acc_bytes / 1e9:.4f} GB of f32 tap "
        "sum that the per-tap route kept in device memory")
    check(peak < acc_bytes, f"K13b layer 1 peak memory {peak} B, not below {acc_bytes} B")
    del out


def check_k6_panel(inp):
    """K6 at C = 1,024 launches the packed attention and one panel launch on
    its f32 context (no quant_rows.cu), and the panel's codes and scales
    (test mode) on that context are bit-equal to quant_rows.cu's and
    quantize_rows'; its out-proj against the plain f32 rule."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.ops.quant import quantize_rows

    qkv, x, kv, H = inp["qkv"], inp["x"], inp["kv"], inp["H"]
    B, T, C = x.shape
    want = ["s3_qkv_attention", "s3_int8_panel"]
    got = launched_entries(lambda: fa.fused_qkv_attention_outproj(qkv, x, inp["wo8"], inp["bo"],
                                                                  kv, H))
    check(got == want, f"K6 [{B}, {T}] launched {got}, not {want}")
    ctx = fa._attention(qkv, kv, H, out_f32=True)
    y, q, s, _ = kc.int8_panel(ctx, *inp["wo8"], inp["bo"], residual=x.view(B * T, C),
                               codes=True)
    q8, s8 = kc.quant_rows(ctx)
    q_ref, s_ref = quantize_rows(ctx)
    torch.cuda.synchronize()
    check(torch.equal(q, q8) and torch.equal(s, s8) and torch.equal(q, q_ref)
          and torch.equal(s, s_ref[:, 0]),
          f"K6 [{B}, {T}]: the panel's codes and scales on the f32 context are not bit-equal")
    want_y = kc.int8_panel_reference(ctx, *inp["wo8"], inp["bo"], residual=x.view(B * T, C))[0]
    cos, err = compare(y, want_y)
    check(cos > COS_KERNEL and within_tolerance(y, want_y) <= 1.0,
          f"K6 [{B}, {T}] panel out-proj: cos {cos:.7f} max err {err:.3e}")
    log(f"[kernel] K6 [{B}, {T}] launches {got}; the panel's codes and scales on its f32 "
        f"context bit-equal to quant_rows.cu's and quantize_rows'; out-proj vs the plain f32 "
        f"rule cos {cos:.7f} max_abs_err {err:.3e}")
    del ctx, y, q, s, q8, s8, q_ref, s_ref, want_y


def frontend_bound(name, inp):
    """The bound of front-end kernel `name` over all of `inp` (K13a on the
    waves; the others over the mid layers as the paths run them): conv
    products as operations of their type, K13a's in the wave's type (2 x 10
    x 512 per frame, as K3's: bf16 on the tensor cores); the row epilogues'
    elementwise work is not counted. Each input byte read once, each output
    byte written once."""
    B = inp["wav"].shape[0]
    if name == "conv0_ln_gelu_q8":
        frames = (inp["wav"].shape[1] - 10) // 5 + 1
        return bound({conv0_ops(inp["wav"]): 2 * 10 * 512 * B * frames},
                     nbytes(inp["wav"], inp["w0"], *inp["ln0"]) + B * frames * (512 + 4))
    ops, moved = {}, 0
    for m in inp["mid"]:
        M = B * ((m["T"] - m["k"]) // 2 + 1)
        gemm = 2 * M * m["k"] * 512 * 512
        if name == "fused_conv_ln_gelu":
            ops["bf16"] = ops.get("bf16", 0) + gemm
            moved += nbytes(m["x"], m["wg"], *m["ln"]) + M * 512 * 2
        elif name == "fused_int8_conv_ln_gelu":
            ops["int8"] = ops.get("int8", 0) + gemm
            moved += nbytes(m["xq"], m["xs"], *m["taps"], *m["ln"])
            moved += M * 512 * 2 if m["last"] else M * (512 + 4)
        else:  # ln_gelu
            moved += 2 * nbytes(m["y"]) + nbytes(*m["ln"])
    return bound(ops, moved)


def frontend_stock(inp):
    """The stock ops each front-end kernel replaces, over the same inputs:
    K3 (tanh, the int8 path's) + quantize_rows for K13a; per mid layer
    F.conv1d + F.layer_norm (f32) + cast + F.gelu for K14 (erf, the bf16
    path's) and K13b (tanh, the int8 path's; on the bf16 rows its codes
    came from); F.layer_norm + cast + F.gelu (tanh) for K15."""
    import torch.nn.functional as F

    from s3prl_tpu_torch.kernels import conv_frontend as cf
    from s3prl_tpu_torch.ops.quant import quantize_rows

    bf = torch.bfloat16

    def norm_gelu(y, ln, mode):
        y = F.layer_norm(y.float(), (512,), *ln, eps=1e-5).to(bf)
        return F.gelu(y, approximate=mode)

    def layer(m, mode):
        y = F.conv1d(m["x"].transpose(1, 2), m["w"].to(bf), stride=2).transpose(1, 2)
        return norm_gelu(y, m["ln"], mode)

    mid = inp["mid"]
    conv = (inp["wav"], inp["w0"], *inp["ln0"])
    return {
        "conv0_ln_gelu_q8": ("K3 tanh + quantize_rows",
                             lambda: quantize_rows(cf.conv0_ln_gelu(*conv, gelu_mode="tanh"))),
        "fused_conv_ln_gelu": ("F.conv1d + F.layer_norm + cast + F.gelu (erf), six layers",
                               lambda: [layer(m, "none") for m in mid]),
        "fused_int8_conv_ln_gelu": ("F.conv1d + F.layer_norm + cast + F.gelu (tanh), six layers",
                                    lambda: [layer(m, "tanh") for m in mid]),
        "ln_gelu": ("F.layer_norm + cast + F.gelu (tanh), six layers",
                    lambda: [norm_gelu(m["y"], m["ln"], "tanh") for m in mid]),
    }


def time_frontend(inp, entries, launches, max_err):
    """Each front-end kernel (K13a on the waves, the others over the six
    mid layers as the paths run them) against its plain version, in turns,
    with its bound and the stock ops it replaces; fills its entry of the
    kernels line (library_ms null: no single PyTorch call computes it)."""
    calls = {**frontend_calls(inp, stack=True),
             "conv0_ln_gelu_q8": frontend_q8_calls(inp)["conv0_ln_gelu_q8"]}
    stock = frontend_stock(inp)
    B = inp["wav"].shape[0]
    for name in ("conv0_ln_gelu_q8", "fused_int8_conv_ln_gelu", "fused_conv_ln_gelu", "ln_gelu"):
        variant, kernel, plain = calls[name][0]
        t = [cuda_ms(f, 5) for f in (plain, kernel, kernel, plain)]
        ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        what, fn = stock[name]
        stock_ms = (cuda_ms(fn, 5) + cuda_ms(fn, 5)) / 2
        bound_ms, bound_by = frontend_bound(name, inp)
        log(f"[timing] {name} {variant} B={B} x 10 s: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
            f", bound {bound_ms:.4f} ms ({bound_by}), stock ops it replaces ({what}) "
            f"{stock_ms:.3f} ms")
        source, replaces = KERNELS[name]
        entries[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": main_launches(launches, name),
                         "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def time_attention_core(inps):
    """`_attention` alone, the packed wgmma core of K1, K4, K6 and K7, on each
    of `inps` (`long_inputs`), bf16 and f32 out, beside SDPA on the same q,
    k, v (`library_call` of K7) and K7's bound; printed, not in the kernels
    line."""
    from s3prl_tpu_torch.kernels import flash_attention as fa

    for i in inps:
        qkv, kv, H = i["qkv"], i["kv"], i["H"]
        ms = {out_f32: (cuda_ms(lambda: fa._attention(qkv, kv, H, out_f32=out_f32), 10)
                        + cuda_ms(lambda: fa._attention(qkv, kv, H, out_f32=out_f32), 10)) / 2
              for out_f32 in (False, True)}
        sdpa = library_call("fused_qkv_attention", i)
        sdpa_ms = (cuda_ms(sdpa, 10) + cuda_ms(sdpa, 10)) / 2
        bound_ms, bound_by = kernel_bound("fused_qkv_attention", i)
        log(f"[timing] _attention (packed wgmma core of K1/K4/K6/K7) "
            f"{list(qkv.shape[:2])} kv {kv.tolist()[:4]}: bf16 out {ms[False]:.3f} ms, f32 out "
            f"{ms[True]:.3f} ms, SDPA {sdpa_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        del sdpa


# (M, N, K) on and beside the int8 wgmma core's tile edges (128 rows, 256
# columns, 128-byte K stages)
GEMM_EDGES = ((1, 8, 16), (17, 136, 48), (127, 264, 1152), (129, 8, 2048), (255, 136, 16),
              (257, 264, 1152))


def check_gemm_s8_edges(gen, dev):
    """gemm_s8 (kRaw) equals torch._int_mm bit for bit on the tile edges
    and on row-group views [B, T', 512] with lda = 2C (K13b's stride-2 tap
    rows read in place; T' not a multiple of the 128-row tile)."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.ops.quant import int_mm

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(dev)

    for M, N, K in GEMM_EDGES:
        a, w = codes(M, K), codes(N, K)
        check(torch.equal(kc.gemm_s8(a, w), int_mm(a, w)), f"gemm_s8 [{M}, {K}] x [{N}, {K}]")
    for T_out in (1, 63, 129, 499):
        x, w = codes(3, 2 * T_out + 1, 512), codes(264, 512)
        rows = x.as_strided((3, T_out, 512), (x.shape[1] * 512, 1024, 1), 512)
        check(torch.equal(kc.gemm_s8(rows, w), int_mm(rows.reshape(-1, 512).contiguous(), w)),
              f"gemm_s8 row groups [3, {T_out}, 512], lda 1024")
    log(f"[kernel] gemm_s8 equals torch._int_mm exactly on the tile edges {GEMM_EDGES} and on "
        "row groups [3, T', 512] with lda 1024, T' in (1, 63, 129, 499)")


def time_gemm_s8(gen, dev, M=32 * 499):
    """gemm_s8 alone (kRaw, int32 out) beside torch._int_mm on the same
    operands at K2's fc1 and fc2-chunk shapes and K1's QKV shape, M = B=32 x
    499 rows; printed with TOP/s, not in the kernels line."""
    from s3prl_tpu_torch.kernels import _common as kc

    for what, N, K in (("K2 fc1", 4096, 1024), ("K2 fc2 chunk", 1024, 2048),
                       ("K1 QKV", 3072, 1024)):
        a = torch.randint(-127, 128, (M, K), generator=gen, dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (N, K), generator=gen, dtype=torch.int8).to(dev)
        wt = w.t()
        t = [cuda_ms(f, 10) for f in (lambda: torch._int_mm(a, wt), lambda: kc.gemm_s8(a, w),
                                       lambda: kc.gemm_s8(a, w), lambda: torch._int_mm(a, wt))]
        ms, lib_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        tops = 2 * M * N * K / 1e12
        bound_ms, bound_by = bound({"int8": 2 * M * N * K}, M * K + N * K + 4 * M * N)
        log(f"[timing] gemm_s8 alone {what} [{M}, {K}] x [{N}, {K}] -> int32: {ms:.4f} ms "
            f"({tops / ms * 1e3:.0f} TOP/s), torch._int_mm {lib_ms:.4f} ms "
            f"({tops / lib_ms * 1e3:.0f} TOP/s), bound {bound_ms:.4f} ms ({bound_by})")
        del a, w, wt


# (M, N, K) on and beside the bf16 wgmma core's tile edges (128 rows, 256
# columns, 64-element K stages)
GEMM_BF16_EDGES = ((1, 8, 8), (127, 256, 64), (129, 264, 72), (257, 520, 1000), (300, 8, 4096))


def check_gemm_bf16_edges(gen, dev):
    """gemm (csrc/gemm_bf16.cu) against F.linear in f32 math on the tile
    edges, bare (bf16 out) and with every epilogue flag (bias, erf GELU,
    residual, f32 out), and on K14's row-group views [2, T', k * 512] read
    in place from x [2, T, 512] with lda 1024 (k = 1, 2, 3: rows apart,
    abutting, overlapping), f32 out: bf16 results under the kernels' rule,
    f32 ones at atol 1e-4 and rtol 1e-4 (sum order only)."""
    import torch.nn.functional as F

    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels.conv_frontend import _im2col

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    def held(got, want, what):
        if got.dtype == torch.float32:
            check(torch.allclose(got, want, atol=1e-4, rtol=1e-4),
                  f"{what}: max err {float((got - want).abs().max()):.3e}")
        else:
            cos, _ = compare(got, want)
            check(cos > COS_KERNEL and within_tolerance(got, want) <= 1.0,
                  f"{what}: cos {cos:.7f}")

    for M, N, K in GEMM_BF16_EDGES:
        a, w = rnd(M, K, scale=0.5), rnd(N, K, scale=K ** -0.5)
        b, res = rnd(N, scale=0.02, dtype=torch.float32), rnd(M, N, scale=0.5)
        held(kc.gemm(a, w), F.linear(a.float(), w.float()), f"gemm [{M}, {K}] x [{N}, {K}]")
        held(kc.gemm(a, w, b, residual=res, gelu=True, out_f32=True),
             F.gelu(F.linear(a.float(), w.float(), b)) + res.float(),
             f"gemm [{M}, {K}] x [{N}, {K}], bias, GELU, residual, f32 out")
    for k in (1, 2, 3):
        for T in (3, 130, 999):
            x, w = rnd(2, T, 512), rnd(512, k * 512, scale=(k * 512) ** -0.5)
            rows = _im2col(x, k, (T - k) // 2 + 1)
            held(kc.gemm(rows, w, out_f32=True),
                 F.linear(rows.reshape(-1, k * 512).float(), w.float()),
                 f"gemm row groups {list(rows.shape)}, lda 1024")
    log(f"[kernel] gemm (bf16) holds against F.linear in f32 math on the tile edges "
        f"{GEMM_BF16_EDGES} (bare and with every epilogue flag) and on row groups [2, T', k x "
        "512] with lda 1024, k in (1, 2, 3), T in (3, 130, 999)")


def time_gemm_bf16(gen, dev, M=32 * 499):
    """gemm alone (csrc/gemm_bf16.cu) with the main path's epilogue flags
    beside F.linear (cuBLAS, with the bias where the path has one) on the
    same operands, in turns: K5's fc1 (bias, GELU) and fc2 (bias, residual),
    K4's QKV (bias) and out-proj (bias, residual) at M = B=32 x 499 rows,
    and K14's layer 1 (f32 out) on the overlapping k = 3 im2col view of x
    [32, 31999, 512] (F.linear on a contiguous copy of its rows); and gemm
    bare (no bias, bf16 out: the main loop and the stores alone); printed
    with TFLOP/s and the bound, not in the kernels line."""
    import torch.nn.functional as F

    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels.conv_frontend import _im2col

    bf = torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    shapes = (("K5 fc1", M, 4096, 1024, dict(gelu=True)), ("K5 fc2", M, 1024, 4096, "res"),
              ("K4 QKV", M, 3072, 1024, {}), ("K4 out-proj", M, 1024, 1024, "res"),
              ("K14 layer 1", None, 512, 1536, dict(out_f32=True)))
    for what, rows_n, N, K, flags in shapes:
        w = rnd(N, K, scale=K ** -0.5)
        if rows_n is None:  # K14: no bias, f32 out
            x = rnd(32, 31999, 512)
            a = _im2col(x, 3, 15999)
            a_lib, b, kw = a.reshape(-1, K).contiguous(), None, flags
        else:
            a = a_lib = rnd(rows_n, K)
            b = rnd(N, scale=0.02, dtype=torch.float32)
            kw = dict(residual=rnd(rows_n, N)) if flags == "res" else flags
        b_lib = None if b is None else b.to(bf)
        rows = a_lib.shape[0]
        t = [cuda_ms(f, 10) for f in (lambda: F.linear(a_lib, w, b_lib),
                                       lambda: kc.gemm(a, w, b, **kw),
                                       lambda: kc.gemm(a, w, b, **kw),
                                       lambda: F.linear(a_lib, w, b_lib))]
        ms, lib_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
        bare_ms = (cuda_ms(lambda: kc.gemm(a, w), 10) + cuda_ms(lambda: kc.gemm(a, w), 10)) / 2
        flops = 2 * rows * N * K
        out_bytes = rows * N * (4 if kw.get("out_f32") else 2)
        moved = nbytes(a_lib if rows_n is not None else x, w) + out_bytes
        moved += (nbytes(b) if b is not None else 0) + (
            nbytes(kw["residual"]) if "residual" in kw else 0)
        bound_ms, bound_by = bound({"bf16": flops}, moved)
        epilogue = ["bias"] * (b is not None) + sorted(kw)
        log(f"[timing] gemm (bf16) alone {what} [{rows}, {K}] x [{N}, {K}] {epilogue}: "
            f"{ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s), "
            f"F.linear {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.0f} TFLOP/s), "
            f"bare gemm {bare_ms:.4f} ms ({flops / bare_ms / 1e9:.0f} TFLOP/s), "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        del a, a_lib, w


def k2_stages(inp):
    """K2's launches on the main path's flags (pre-LN, residual) as
    `fused_int8_ffn` makes them, on its timing inputs: (stage, call) each,
    the later stages fed the earlier stages' outputs."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import ffn as k5

    x2 = inp["x"].view(-1, inp["x"].shape[-1])
    (w1q, w1s), (w2q, w2s) = inp["w18"], inp["w28"]
    R, Fd = x2.shape[0], w1q.shape[0]
    bounds = k5._ffn_chunk_bounds(Fd)
    x8, xs = kc.quant_rows(x2, ln=inp["ln"])
    h = kc.gemm_s8(x8, w1q, mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=w1s, bias=inp["b1"],
                   gelu=True, out_f32=True)
    h8 = torch.empty(R, Fd, dtype=torch.int8, device=x2.device)
    hs = torch.empty(len(bounds), R, device=x2.device)
    acc = torch.empty(R, x2.shape[1], device=x2.device)
    stages = [("x-quant (LN + quant_rows.cu)", lambda: kc.quant_rows(x2, ln=inp["ln"])),
              ("fc1 (gemm_s8, scale + b1 + tanh GELU, f32 h)",
               lambda: kc.gemm_s8(x8, w1q, mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=w1s,
                                  bias=inp["b1"], gelu=True, out_f32=True))]
    for i, (lo, hi) in enumerate(bounds):
        stages.append((f"requant chunk {i} [{lo}, {hi})",
                       lambda i=i, lo=lo, hi=hi: kc.quant_rows(h, lo=lo, hi=hi, q=h8,
                                                               scale=hs[i])))
    for i, (lo, hi) in enumerate(bounds):
        last = i == len(bounds) - 1
        stages.append((f"fc2 chunk {i} [{lo}, {hi})",
                       lambda i=i, lo=lo, hi=hi, last=last: kc.gemm_s8(
                           h8[:, lo:hi], w2q[:, lo:hi], mode=kc.GEMM_LINEAR, row_scale=hs[i],
                           col_scale=w2s, acc_in=acc if i else None,
                           bias=inp["b2"] if last else None, residual=x2 if last else None,
                           out_f32=not last, out=None if last else acc)))
    return stages


def k12_stages(inp):
    """K12's launch in its two main-path sets ((LN, N = 3C): the QKV under
    ``full_fuse``/``qkv_fuse``; (residual, N = C): the out-proj under
    ``full_fuse``) as `fused_int8_linear` makes it, one panel launch each,
    and beside each the wide-row route's pair (quant_rows.cu + gemm_s8.cu)
    at the same shape: (stage, call) each."""
    from s3prl_tpu_torch.kernels import _common as kc

    x2 = inp["x"].view(-1, inp["x"].shape[-1])
    stages = []
    for ln, w, b in ((True, inp["wq8"], inp["bq"]), (False, inp["wo8"], inp["bo"])):
        N = w[0].shape[0]
        kw = dict(ln=inp["ln"] if ln else None,
                  residual=None if ln else inp["res"][N].view(-1, N))
        what = f"{'LN, N=' if ln else 'residual, N='}{N}"
        stages.append((f"{what} (int8_panel.cu)",
                       lambda w=w, b=b, kw=kw: kc.int8_panel(x2, *w, b, **kw)))

        def pair(w=w, b=b, kw=kw):
            x8, xs = kc.quant_rows(x2, ln=kw["ln"])
            return kc.gemm_s8(x8, w[0], mode=kc.GEMM_LINEAR, row_scale=xs, col_scale=w[1],
                              bias=b, residual=kw["residual"])
        stages.append((f"{what} wide-row route (quant_rows.cu + gemm_s8.cu)", pair))
    return stages


def k1_stages(inp):
    """K1's three launches (pre-LN, the main path's) as `fused_attention_block`
    makes them, on its timing inputs: (stage, call) each, the later stages
    fed the earlier stages' outputs."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import flash_attention as fa

    B, T, C = inp["x"].shape
    x2 = inp["x"].view(B * T, C)
    (wq, wqs), (wo, wos) = inp["wq8"], inp["wo8"]
    qkv = kc.int8_panel(x2, wq, wqs, inp["bq"], ln=inp["ln"], mode=kc.GEMM_QKV)
    attn = fa._attention(qkv.view(B, T, 3 * C), inp["kv"], inp["H"])
    return [("QKV (int8_panel.cu: LN + quant + GEMM + kQkv)",
             lambda: kc.int8_panel(x2, wq, wqs, inp["bq"], ln=inp["ln"], mode=kc.GEMM_QKV)),
            ("attention (gated_attention.cu, packed)",
             lambda: fa._attention(qkv.view(B, T, 3 * C), inp["kv"], inp["H"])),
            ("out-proj (int8_panel.cu: bf16 context quant + GEMM + bo + x)",
             lambda: kc.int8_panel(attn, wo, wos, inp["bo"], rule=kc.RULE_CTX, residual=x2))]


# The int8 panel kernel's edges: rows on and beside the 128-row panel and the
# main path's 32 x 499; N on and beside the 128-column tiles and the main
# path's widths; C of HuBERT-Base and -Large
PANEL_EDGES = dict(C=(768, 1024), M=(1, 127, 129, 32 * 499), N=(8, 264, 1024, 3072))
# (name, row rule, LN, epilogue, residual, f32 out): K1's QKV (pre-LN and
# postnorm) and out-proj (bf16 out, and the postnorm f32 sum), K12's two sets
PANEL_SETS = (("K1 QKV, LN", "f32", True, "qkv", False, False),
              ("K1 QKV, postnorm", "f32", False, "qkv", False, False),
              ("K1 out-proj", "ctx", False, "linear", True, False),
              ("K1 out-proj, postnorm (f32 out)", "ctx", False, "linear", True, True),
              ("K12 LN", "f32", True, "linear", False, False),
              ("K12 residual", "f32", False, "linear", True, False))


def panel_plain(w8, ws, b, xq, xs, qkv, res, out_f32):
    """The plain projection of codes xq and scales xs [M, 1]: exact int32
    sums with K1's QKV cast points, or f32(acc) * xs * ws + b [+ res] cast
    once."""
    from s3prl_tpu_torch.ops.quant import int_mm

    bf = torch.bfloat16
    if qkv:
        return int_mm(xq, w8).to(bf) * (xs * ws).to(bf) + b.to(bf)
    y = int_mm(xq, w8).float() * xs * ws + b
    if res is not None:
        y = y + res.float()
    return y if out_f32 else y.to(bf)


def check_panel_edges(gen, dev):
    """csrc/int8_panel.cu against the plain projection at every (C, M, N) of
    PANEL_EDGES in each of PANEL_SETS: in the test mode its codes and scales
    bit-equal to quantize_context_reference's or quantize_rows' (with the LN,
    of the LN recomputed in f32 from the kernel's statistics, which agree
    with torch's mean and 1 / sqrt(var + eps) at rtol 1e-5: the sums run in
    another order, so at a .5 tie a code of torch's LN can land one step
    apart, and K1's triple-rounded QKV can then land one bf16 step past the
    rule's bound; the wrappers' checks above hold that against the plain
    versions at the main path's shape), and the output under the kernels'
    rule against the plain projection of those codes."""
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels.flash_attention import quantize_context_reference
    from s3prl_tpu_torch.ops.quant import as_quantized_cols, quantize_rows

    def rnd(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    worst = {}
    for C in PANEL_EDGES["C"]:
        ln = (1 + rnd(C, scale=0.1), rnd(C, scale=0.1))
        for M in PANEL_EDGES["M"]:
            x = rnd(M, C, scale=0.5, dtype=torch.bfloat16)
            mean = x.float().mean(-1)
            rstd = 1.0 / torch.sqrt(((x.float() - mean[:, None]) ** 2).mean(-1) + kc.LN_EPS)
            for N in PANEL_EDGES["N"]:
                w8, ws = as_quantized_cols(rnd(N, C, scale=C ** -0.5))
                b, res = rnd(N, scale=0.02), rnd(M, N, scale=0.5, dtype=torch.bfloat16)
                for name, rule, with_ln, epi, with_res, out_f32 in PANEL_SETS:
                    what = f"int8_panel {name} [{M}, {C}] x [{N}, {C}]"
                    got, q, s, stats = kc.int8_panel(
                        x, w8, ws, b, ln=ln if with_ln else None,
                        rule=kc.RULE_CTX if rule == "ctx" else kc.RULE_F32,
                        mode=kc.GEMM_QKV if epi == "qkv" else kc.GEMM_LINEAR,
                        residual=res if with_res else None, out_f32=out_f32, codes=True)
                    if rule == "ctx":
                        want_q, want_s = quantize_context_reference(x)
                    elif with_ln:
                        check(torch.allclose(stats[:, 0], mean, rtol=1e-5, atol=1e-6)
                              and torch.allclose(stats[:, 1], rstd, rtol=1e-5),
                              f"{what}: LN statistics")
                        want_q, want_s = quantize_rows(
                            (x.float() - stats[:, :1]) * stats[:, 1:] * ln[0] + ln[1])
                    else:
                        want_q, want_s = quantize_rows(x)
                    check(torch.equal(q, want_q) and torch.equal(s, want_s[:, 0]),
                          f"{what}: codes and scales not bit-equal")
                    want = panel_plain(w8, ws, b, want_q, want_s, epi == "qkv",
                                       res if with_res else None, out_f32)
                    check(got.shape == want.shape and got.dtype == want.dtype, what)
                    cos, err = compare(got, want)
                    ratio = within_tolerance(got, want)
                    check(cos > COS_KERNEL and ratio <= 1.0,
                          f"{what}: cos {cos:.7f} max err {err:.3e} (/ bound {ratio:.3f})")
                    worst[name] = max(worst.get(name, (0.0, 1.0)), (err, cos))
                del w8, ws, b, res
            del x
    log(f"[kernel] int8_panel holds against the plain projection at C {PANEL_EDGES['C']}, "
        f"rows {PANEL_EDGES['M']}, N {PANEL_EDGES['N']}, codes and scales bit-equal; "
        "max_abs_err (cos at it): " + ", ".join(f"{name} {err:.3e} ({cos:.7f})"
                                                for name, (err, cos) in worst.items()))


def launched_entries(fn):
    """The C entries that fn() launches, in order (a spy on `launch` in the
    modules that launch K1's, K6's, K12's and K13b's kernels)."""
    from s3prl_tpu_torch.kernels import _build
    from s3prl_tpu_torch.kernels import _common as kc
    from s3prl_tpu_torch.kernels import conv_frontend as cf
    from s3prl_tpu_torch.kernels import flash_attention as fa

    names = []

    def spy(name, *args):
        names.append(name)
        return _build.launch(name, *args)

    saved = kc.launch, fa.launch, cf.launch
    kc.launch = fa.launch = cf.launch = spy
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        kc.launch, fa.launch, cf.launch = saved
    return names


def check_projection_routes(inp, inp_wide):
    """K1 and K12 launch what their design says: at C = 1,024 K12 is one
    panel launch and K1 three (panel QKV, the attention, panel out-proj; and
    the LN with ``postnorm``); at C = 1,280 (wider than the panel) both take
    the wide-row route (quant_rows.cu + gemm_s8.cu for each projection),
    whose outputs are then held against the plain versions."""
    from s3prl_tpu_torch.kernels import _common as kc

    panel, attn = "s3_int8_panel", "s3_qkv_attention"
    pair = ["s3_quant_rows", "s3_gemm_s8"]
    expected = {
        1024: {"fused_int8_linear": [[panel]] * len(K12_SETS),
               "fused_attention_block": [[panel, attn, panel],
                                         [panel, attn, panel, "s3_layernorm"]]},
        1280: {"fused_int8_linear": [pair] * len(K12_SETS),
               "fused_attention_block": [pair + [attn, "s3_quant_rows_bf16", "s3_gemm_s8"],
                                         pair + [attn, "s3_quant_rows_bf16", "s3_gemm_s8",
                                                 "s3_layernorm"]]}}
    check(kc.PANEL_MAX_C == 1024, f"PANEL_MAX_C {kc.PANEL_MAX_C}")
    for i, C in ((inp, 1024), (inp_wide, 1280)):
        calls = kernel_calls(i)
        for name, want in expected[C].items():
            for (variant, kernel, _), entries in zip(calls[name], want):
                got = launched_entries(kernel)
                check(got == entries, f"{name} {variant} C={C} launched {got}, not {entries}")
        log(f"[kernel] C={C}: K12 launches {expected[C]['fused_int8_linear'][0]}, K1 "
            f"{expected[C]['fused_attention_block'][0]} (postnorm + s3_layernorm)")
    wide = kernel_calls(inp_wide)  # not the panel kernel: kept out of the kernels line's errors
    check_kernels({name: wide[name] for name in ("fused_int8_linear", "fused_attention_block")},
                  {})


KERNELS = {  # wrapper -> (its main CUDA source, the TPU kernel it replaces)
    "conv0_ln_gelu": ("s3prl_tpu_torch/csrc/conv0_ln_gelu.cu",
                      "s3prl_tpu/kernels/conv_frontend.py:148"),
    "fused_attention_block": ("s3prl_tpu_torch/csrc/int8_panel.cu",
                              "s3prl_tpu/kernels/flash_attention.py:633"),
    "fused_int8_ffn": ("s3prl_tpu_torch/csrc/gemm_s8.cu", "s3prl_tpu/kernels/ffn.py:129"),
    "fused_attention_block_bf16": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                                   "s3prl_tpu/kernels/flash_attention.py:772"),
    "fused_bf16_ffn": ("s3prl_tpu_torch/csrc/gemm_bf16.cu", "s3prl_tpu/kernels/ffn.py:320"),
    "fused_qkv_attention_outproj": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                                    "s3prl_tpu/kernels/flash_attention.py:312"),
    "fused_qkv_attention": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                            "s3prl_tpu/kernels/flash_attention.py:210"),
    "online_flash_attention": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                               "s3prl_tpu/kernels/flash_attention.py:867"),
    "gated_bias_attention": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                             "s3prl_tpu/kernels/flash_attention.py:105"),
    "gated_online_flash_attention": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                                     "s3prl_tpu/kernels/flash_attention.py:963"),
    "gated_bias_attention_outproj": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                                     "s3prl_tpu/kernels/flash_attention.py:423"),
    "fused_int8_linear": ("s3prl_tpu_torch/csrc/int8_panel.cu", "s3prl_tpu/kernels/ffn.py:216"),
    "conv0_ln_gelu_q8": ("s3prl_tpu_torch/csrc/conv0_ln_gelu.cu",
                         "s3prl_tpu/kernels/conv_frontend.py:177"),
    "fused_int8_conv_ln_gelu": ("s3prl_tpu_torch/csrc/int8_conv.cu",
                                "s3prl_tpu/kernels/conv_frontend.py:370"),
    "fused_conv_ln_gelu": ("s3prl_tpu_torch/csrc/gemm_bf16.cu",
                           "s3prl_tpu/kernels/conv_frontend.py:301"),
    "ln_gelu": ("s3prl_tpu_torch/csrc/ln_gelu.cu", "s3prl_tpu/kernels/ln_gelu.py:60"),
    "pos_conv_gelu": ("s3prl_tpu_torch/csrc/posconv.cu", "s3prl_tpu/kernels/posconv.py:182"),
    "pos_conv_gelu_q8": ("s3prl_tpu_torch/csrc/posconv.cu", "s3prl_tpu/kernels/posconv.py:137"),
    "flash_attention": ("s3prl_tpu_torch/csrc/gated_attention.cu",
                        "s3prl_tpu/kernels/flash_attention.py:1020"),
}
MODELS = {"hubert": "hubert_large_ll60k", "wavlm": "wavlm_large",  # model -> hub entry
          "hubert_base": "hubert_base", "wavlm_base": "wavlm_base",
          "wav2vec2": "wav2vec2_large_ll60k", "data2vec": "data2vec_large_ll60k",
          "unispeech_sat": "unispeech_sat_base"}
OPTIONS = {"int8": {}, "bf16": {}, "int8 full_fuse": {"full_fuse": True},  # path -> keywords
           "int8 qkv_fuse": {"qkv_fuse": True}, "int8 wavlm_fuse": {"wavlm_fuse": True},
           "int8 int8_conv": {"int8_conv": True}, "bf16 fused_conv": {"fused_conv": True},
           "int8 fused_midln": {"fused_midln": True},
           "bf16 fused_posconv": {"fused_posconv": True},
           "int8 int8_posconv": {"int8_posconv": True}}
LENS = {  # main-path batch -> utterance lengths in samples (mixed)
    "10 s": [160000, 120000, 40000, 800, 159999, 80000, 16001, 1],
    "30 s": [480000, 400000, 320000, 160000, 479999, 240000, 16001, 1],
    "60 s": [960000, 720000, 480001, 1],
}
# main-path run -> the kernels it launches (24 layers; every other count is 0)
RUNS = {
    ("hubert", "int8", "10 s"): {"conv0_ln_gelu": 1, "fused_attention_block": 24,
                                 "fused_int8_ffn": 24},
    ("hubert", "bf16", "10 s"): {"conv0_ln_gelu": 1, "fused_attention_block_bf16": 24,
                                 "fused_bf16_ffn": 24},
    ("hubert", "int8", "30 s"): {"conv0_ln_gelu": 1, "fused_qkv_attention_outproj": 24,
                                 "fused_int8_ffn": 24},
    ("hubert", "bf16", "30 s"): {"conv0_ln_gelu": 1, "fused_qkv_attention": 24,
                                 "fused_bf16_ffn": 24},
    ("hubert", "int8", "60 s"): {"conv0_ln_gelu": 1, "online_flash_attention": 24,
                                 "fused_int8_ffn": 24},
    ("hubert", "bf16", "60 s"): {"conv0_ln_gelu": 1, "online_flash_attention": 24,
                                 "fused_bf16_ffn": 24},
    # WavLM: K3 in erf mode on both paths, K9 (K10 beyond 2,048 frames), K2 on int8 only
    ("wavlm", "int8", "10 s"): {"conv0_ln_gelu": 1, "gated_bias_attention": 24,
                                "fused_int8_ffn": 24},
    ("wavlm", "bf16", "10 s"): {"conv0_ln_gelu": 1, "gated_bias_attention": 24},
    ("wavlm", "int8", "30 s"): {"conv0_ln_gelu": 1, "gated_bias_attention": 24,
                                "fused_int8_ffn": 24},
    ("wavlm", "bf16", "30 s"): {"conv0_ln_gelu": 1, "gated_bias_attention": 24},
    ("wavlm", "int8", "60 s"): {"conv0_ln_gelu": 1, "gated_online_flash_attention": 24,
                                "fused_int8_ffn": 24},
    ("wavlm", "bf16", "60 s"): {"conv0_ln_gelu": 1, "gated_online_flash_attention": 24},
    # the fused int8 projections: full_fuse at every T, qkv_fuse beyond 512 frames, wavlm_fuse
    ("hubert", "int8 full_fuse", "10 s"): {"conv0_ln_gelu": 1, "fused_int8_linear": 48,
                                           "fused_qkv_attention": 24, "fused_int8_ffn": 24},
    ("hubert", "int8 full_fuse", "30 s"): {"conv0_ln_gelu": 1, "fused_int8_linear": 48,
                                           "fused_qkv_attention": 24, "fused_int8_ffn": 24},
    ("hubert", "int8 qkv_fuse", "10 s"): {"conv0_ln_gelu": 1, "fused_attention_block": 24,
                                          "fused_int8_ffn": 24},
    ("hubert", "int8 qkv_fuse", "30 s"): {"conv0_ln_gelu": 1, "fused_int8_linear": 24,
                                          "fused_qkv_attention_outproj": 24,
                                          "fused_int8_ffn": 24},
    ("wavlm", "int8 wavlm_fuse", "10 s"): {"conv0_ln_gelu": 1, "gated_bias_attention_outproj": 24,
                                           "fused_int8_ffn": 24},
    ("wavlm", "int8 wavlm_fuse", "30 s"): {"conv0_ln_gelu": 1, "gated_bias_attention_outproj": 24,
                                           "fused_int8_ffn": 24},
    # the front-end options: K13a + 6 K13b in place of K3, K3 + 6 K14, K3 + 6 K15
    ("hubert", "int8 int8_conv", "10 s"): {"conv0_ln_gelu_q8": 1, "fused_int8_conv_ln_gelu": 6,
                                           "fused_attention_block": 24, "fused_int8_ffn": 24},
    ("hubert", "bf16 fused_conv", "10 s"): {"conv0_ln_gelu": 1, "fused_conv_ln_gelu": 6,
                                            "fused_attention_block_bf16": 24,
                                            "fused_bf16_ffn": 24},
    ("hubert", "int8 fused_midln", "10 s"): {"conv0_ln_gelu": 1, "ln_gelu": 6,
                                             "fused_attention_block": 24, "fused_int8_ffn": 24},
    ("wavlm", "bf16 fused_conv", "10 s"): {"conv0_ln_gelu": 1, "fused_conv_ln_gelu": 6,
                                           "gated_bias_attention": 24},
    # the pos-conv options: one K16a / K16b a forward in place of the stock grouped conv
    ("hubert", "bf16 fused_posconv", "10 s"): {"conv0_ln_gelu": 1, "pos_conv_gelu": 1,
                                               "fused_attention_block_bf16": 24,
                                               "fused_bf16_ffn": 24},
    ("hubert", "bf16 fused_posconv", "30 s"): {"conv0_ln_gelu": 1, "pos_conv_gelu": 1,
                                               "fused_qkv_attention": 24, "fused_bf16_ffn": 24},
    ("hubert", "int8 int8_posconv", "10 s"): {"conv0_ln_gelu": 1, "pos_conv_gelu_q8": 1,
                                              "fused_attention_block": 24, "fused_int8_ffn": 24},
    ("hubert", "int8 int8_posconv", "30 s"): {"conv0_ln_gelu": 1, "pos_conv_gelu_q8": 1,
                                              "fused_qkv_attention_outproj": 24,
                                              "fused_int8_ffn": 24},
    # the post-LN Base models (12 layers, group-norm extractor: no K3): HuBERT-Base
    # K1 / K4 postnorm, K6 on raw x (K7 in bf16) beyond 512 frames, K8 beyond
    # 2,048, K2 / K5 postnorm; WavLM-Base K9 (K10), K2 bare on int8, K11
    **{("hubert_base", "int8", length): {attn: 12, "fused_int8_ffn": 12} for length, attn in (
        ("10 s", "fused_attention_block"), ("30 s", "fused_qkv_attention_outproj"),
        ("60 s", "online_flash_attention"))},
    **{("hubert_base", "bf16", length): {attn: 12, "fused_bf16_ffn": 12} for length, attn in (
        ("10 s", "fused_attention_block_bf16"), ("30 s", "fused_qkv_attention"),
        ("60 s", "online_flash_attention"))},
    **{("wavlm_base", path, length): {attn: 12, **({"fused_int8_ffn": 12} if path == "int8"
                                                   else {})}
       for path in ("int8", "bf16") for length, attn in (
           ("10 s", "gated_bias_attention"), ("30 s", "gated_bias_attention"),
           ("60 s", "gated_online_flash_attention"))},
    **{("wavlm_base", "int8 wavlm_fuse", length): {"gated_bias_attention_outproj": 12,
                                                   "fused_int8_ffn": 12}
       for length in ("10 s", "30 s")},
    # wav2vec2-Large (pre-LN) and data2vec-Large (post-LN: K1 / K4 and K2 / K5
    # postnorm, K6 on raw x; its depth-5 pos-conv stack runs no kernel), both on
    # the layer-norm extractor (K3) under the conv length rule, whose 1-sample
    # utterance has no frame: kv_len 0 in every attention kernel
    **{(model, "int8", length): {"conv0_ln_gelu": 1, attn: 24, "fused_int8_ffn": 24}
       for model in ("wav2vec2", "data2vec") for length, attn in (
           ("10 s", "fused_attention_block"), ("30 s", "fused_qkv_attention_outproj"),
           ("60 s", "online_flash_attention"))},
    **{(model, "bf16", length): {"conv0_ln_gelu": 1, attn: 24, "fused_bf16_ffn": 24}
       for model in ("wav2vec2", "data2vec") for length, attn in (
           ("10 s", "fused_attention_block_bf16"), ("30 s", "fused_qkv_attention"),
           ("60 s", "online_flash_attention"))},
    # UniSpeech-SAT Base: WavLM-Base's architecture (12 K9, K2 bare on int8)
    ("unispeech_sat", "int8", "10 s"): {"gated_bias_attention": 12, "fused_int8_ffn": 12},
    ("unispeech_sat", "bf16", "10 s"): {"gated_bias_attention": 12},
}
PATHS = list(dict.fromkeys((model, path) for model, path, _ in RUNS))  # the loaded models
# phase 6 times the bench models' default paths on the three batches, best of
# two, every other path at 10 s only, but qkv_fuse (inert at 10 s) at 30 s,
# best of one; phase 5 gates the bench models alone at 60 s (PR 24 cut the
# other models' 30- and 60-s timings and 60-s gates, their second chain
# pair, the options' 30-s timings and the Base models' K8 / K10 card-vs-CPU
# cases, which the Large models' hold, to keep the script's time with phase
# 13; the earlier rates are in PERF.md)
BENCH_MODELS = ("hubert", "wavlm")


def timed_lengths(model, path):
    """The phase 6 batches (labels of LENS) that time `path` of `model`."""
    if path == "int8 qkv_fuse":
        return ("30 s",)
    if model in BENCH_MODELS and path in ("int8", "bf16"):
        return ("10 s", "30 s", "60 s")
    return ("10 s",)


def timing_reps(model, path):
    """Best of how many chain pairs phase 6 takes for `path` of `model`: 2
    for the bench models' default paths, 1 for the others (since PR 24)."""
    return 2 if model in BENCH_MODELS and path in ("int8", "bf16") else 1
# the main-path run each wrapper's launch count is read from: the first that
# launches it; None for K17, which no model calls
MAIN_PATH = {name: next((run for run, expected in RUNS.items() if name in expected), None)
             for name in KERNELS}
COS_F32 = {"int8": 0.999, "bf16": 0.995}  # the JAX package's gates against f32
# Paths held to their plain versions' distance from f32 in place of an absolute
# bar: a 24-layer post-LN model drifts below 0.999 at int8 in the JAX package
# itself (data2vec-Large: JAX int8 0.99849 at layer 24 on its own weights, the
# port's 0.99841 on the same weights; tools/torch_int8_drift.py). The card's
# states must lie as close to f32 as the CPU's (the wrappers' plain versions),
# each layer within DRIFT_MARGIN; the card-vs-CPU cosines are printed.
DRIFT_PATHS = {("data2vec", "int8")}
DRIFT_MARGIN = 5e-4
# the paths whose feature extractor is timed alone: the defaults and the front-end options
FRONT_END_PATHS = ("int8", "bf16", "int8 int8_conv", "bf16 fused_conv", "int8 fused_midln")


def main_launches(launches, name):
    """Kernel `name`'s launches on its main-path run (0 where none runs it)."""
    return launches[MAIN_PATH[name]][name] if MAIN_PATH[name] else 0


def load(hub, model, path, device):
    """`path`'s model (int8 with its option keywords, or bf16) from seed 0."""
    return hub.load(MODELS[model], dtype=torch.bfloat16, flash=True,
                    quantize=path.split()[0] == "int8", device=device, seed=0, **OPTIONS[path])


def load_all(hub, dev):
    """Every path's model of PATHS, loaded four at a time (each draws from
    its own seeded generator, so the weights are those of one load at a
    time; the CPU-bound draws and int8 quantization overlap)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(zip(PATHS, pool.map(lambda key: load(hub, *key, dev), PATHS)))


def on_cpu(up):
    """A copy of `up` with its model on the CPU: the same seed's weights,
    drawn on the CPU by hub.load before the move to the card, with its int8
    cache and option weights, without drawing them a second time."""
    import copy
    import dataclasses

    return dataclasses.replace(up, model=copy.deepcopy(up.model).cpu())


def batch(lens, T, gen, dev):
    wavs = torch.randn(len(lens), T, generator=gen)
    lens_t = torch.tensor(lens)
    wavs = wavs * (torch.arange(T)[None, :] < lens_t[:, None])
    return wavs.to(dev), lens_t.to(dev)


def layer_cosines(a, b, h_lens):
    """Per-layer cosine over the valid frames of every utterance."""
    out = []
    for layer in range(a.shape[0]):
        parts_a = [a[layer, i, :n] for i, n in enumerate(h_lens)]
        parts_b = [b[layer, i, :n] for i, n in enumerate(h_lens)]
        out.append(compare(torch.cat(parts_a), torch.cat(parts_b))[0])
    return out


# gated_attention.cu's instantiations, in the order of its occupancy kinds
GATED_KINDS = ("no bias, split heads (K8, K17)", "bf16 bias (K9, K10)", "f32 bias (K9, K10)",
               "packed, bf16 out (K1, K4, K7)", "packed, f32 out (K6)",
               "gated, packed, f32 bias, f32 out (K11)")
# the tensor-core kernels (their SASS names contain these) -> (instantiations,
# the SASS mnemonic of their products): the wgmma kernels (HGMMA / IGMMA) - the
# attention (K1, K4, K6-K11, K17), the int8 GEMM core (kRaw, kQkv, kLinear: K2,
# K11, and K1's, K6's and K12's wide-row route), the int8 panel projection (kQkv
# and kLinear on bf16 rows: K1, K12; kLinear on f32 rows: K6), K13b's conv
# (int8_conv.cu), the bf16 GEMM core (K4, K5, K14), K16a and K16b (bf16, f32
# x) - and K3 / K13a on
# bf16 waves (conv0_ln_gelu.cu on mma.sync, HMMA: erf, tanh, q8)
TENSOR_KERNELS = {"gated_attention_kernel": (len(GATED_KINDS), "GMMA"),
                  "gemm_s8_kernel": (3, "GMMA"), "int8_panel_kernel": (3, "GMMA"),
                  "int8_conv_kernel": (1, "GMMA"), "gemm_bf16_kernel": (1, "GMMA"),
                  "posconv_bf16_kernel": (1, "GMMA"), "posconv_q8_kernel": (2, "GMMA"),
                  "conv0_mma_kernel": (3, "HMMA")}
# kernels that must not reach the tensor cores: K3 / K13a on f32 waves
# (conv0_ln_gelu.cu: f32 FMAs; erf, tanh, q8)
CUDA_CORE_KERNELS = {"conv0_fma_kernel": 3}
SASS_PRODUCTS = {"GMMA": r"\b[HI]GMMA\.", "HMMA": r"\bHMMA\."}
# conv0_ln_gelu.cu's instantiations, in the order of s3_conv0_occupancy's kinds
CONV0_KINDS = ("bf16 waves, erf (K3)", "bf16 waves, tanh (K3)", "bf16 waves, q8 (K13a)",
               "f32 waves, erf (K3)", "f32 waves, tanh (K3)", "f32 waves, q8 (K13a)")


def tile_loop_instructions(part):
    """The SASS instructions of a kernel's tile loop (the span of its widest
    backward branch), or None where no backward branch is found."""
    import re

    ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)
    addr = [int(a, 16) for a, _ in ins]
    spans = [sum(int(m.group(1), 16) <= x <= int(a, 16) for x in addr)
             for a, t in ins for m in [re.search(r"BRA\s+0x([0-9a-f]+)", t)]
             if m and int(m.group(1), 16) < int(a, 16)]
    return max(spans, default=None)


def conv0_issue_floor(per_tile, B=32, n=10 * SR):
    """(ms, MHz): the least time K3 / K13a's bf16 kernel can take at B x n
    samples when every SASS instruction of its tile loop (`per_tile`, run
    once per warp tile of 8 frames) must issue: tiles x per_tile warp
    instructions over the SMs' 4 schedulers each, one a clock at the card's
    maximum SM clock (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    tiles = B * -(-((n - 10) // 5 + 1) // 8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return tiles * per_tile / (sms * 4 * mhz * 1e6) * 1e3, mhz


def build_report(lib):
    """The tensor-core kernels as built: for each instantiation its
    registers and spills (ptxas -v, from the build's nvcc.log), its count of
    HGMMA / IGMMA (wgmma) or HMMA (mma.sync) instructions (cuobjdump -sass),
    and any ptxas note that its wgmma were serialized; K3 / K13a's tile loop
    in instructions and the issue floor it sets at B=32 x 10 s; then each
    kernel's dynamic (conv0_ln_gelu.cu: static) shared memory and blocks per
    SM (the CUDA occupancy queries; K16a and K16b at k = 128). Fails unless each
    kernel has its count of instantiations, on a stack frame or spill, or on
    an instantiation without its tensor-core products; and on any
    tensor-core instruction in the f32 waves' conv0 kernel."""
    import ctypes
    import re
    from pathlib import Path

    from s3prl_tpu_torch.kernels import _build

    kernels = {**TENSOR_KERNELS, **{k: (n, None) for k, n in CUDA_CORE_KERNELS.items()}}

    def kernel_of(name):
        return next((k for k in kernels if k in name), None)

    lines = (Path(lib._name).parent / "nvcc.log").read_text().splitlines()
    ptxas = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel_of(line):
            name = line.split("'")[1]
            info = " ".join(lines[i + 1:i + 5])
            spills = [int(n) for n in re.findall(r"(\d+) bytes (?:stack frame|spill stores"
                                                 r"|spill loads)", info)]
            regs = re.search(r"Used (\d+) registers", info)
            ptxas[name] = (int(regs.group(1)) if regs else None, sum(spills))
        elif kernel_of(line) and "Performance Loss" in line:
            log(f"[build] ptxas: {line.strip()}")
    sass = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", lib._name],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    products, loop = {}, {}  # tensor-core instructions; conv0's tile loop
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        kernel = kernel_of(name)
        if kernel:  # the CUDA-core kernels: tensor-core instructions of any kind
            mnemonic = kernels[kernel][1]
            pattern = SASS_PRODUCTS[mnemonic] if mnemonic else "|".join(SASS_PRODUCTS.values())
            products[name] = len(re.findall(pattern, part))
        if kernel == "conv0_mma_kernel":
            loop[name] = tile_loop_instructions(part)
    for kernel, (count, _) in kernels.items():
        n_ptxas = sum(kernel_of(name) == kernel for name in ptxas)
        n_sass = sum(kernel_of(name) == kernel for name in products)
        check(n_ptxas == n_sass == count, f"{kernel}: {n_ptxas} instantiations in nvcc.log, "
              f"{n_sass} in the SASS, not {count}")
    for name, (regs, spills) in sorted(ptxas.items()):
        mnemonic = kernels[kernel_of(name)][1]
        what = {"GMMA": "HGMMA/IGMMA (wgmma)", "HMMA": "HMMA (mma.sync)",
                None: "tensor-core instructions (f32 FMAs only)"}[mnemonic]
        log(f"[build] {name}: {regs} registers, {spills} bytes of stack and spills, "
            f"{products.get(name, 0)} {what} in its SASS")
        if mnemonic is None:
            check(products.get(name, 0) == 0, f"{name}: tensor-core instructions on f32 waves")
        else:
            check(spills == 0 and products.get(name, 0) > 0,
                  f"{name}: spills or no tensor-core products")
    for name, per_tile in sorted(loop.items()):
        # the template arguments in the mangled name: int8 out (a), tanh mode (Lb1)
        label = "K13a" if "conv0_mma_kernelIa" in name else \
            f"K3 {'tanh' if 'Lb1' in name else 'erf'}"
        if per_tile is None:
            log(f"[build] {label}: tile loop not found in the SASS (issue floor not measured)")
            continue
        floor, mhz = conv0_issue_floor(per_tile)
        log(f"[build] {label} (bf16 waves): {per_tile} SASS instructions in its tile loop "
            f"({per_tile / 128:.1f} an element); issue floor at B=32 x 10 s "
            f"{floor:.4f} ms (one warp instruction a clock on each of 4 schedulers an SM, "
            f"{mhz:.0f} MHz)")
    library = _build.library()
    queries = [(f"gated_attention_kernel, {what}",
                lambda s, b, kind=kind: library.s3_gated_attention_occupancy(kind, s, b))
               for kind, what in enumerate(GATED_KINDS)]
    queries += [("gemm_s8_kernel", library.s3_gemm_s8_occupancy),
                ("int8_panel_kernel", library.s3_int8_panel_occupancy),
                ("int8_conv_kernel", library.s3_int8_conv_occupancy),
                ("gemm_bf16_kernel", library.s3_gemm_bf16_occupancy),
                ("posconv_bf16_kernel, k = 128",
                 lambda s, b: library.s3_posconv_occupancy(128, s, b)),
                ("posconv_q8_kernel, bf16 x, k = 128",
                 lambda s, b: library.s3_posconv_q8_occupancy(128, s, b))]
    queries += [(f"conv0_ln_gelu.cu, {what}",
                 lambda s, b, kind=kind: library.s3_conv0_occupancy(kind, s, b))
                for kind, what in enumerate(CONV0_KINDS)]
    for what, query in queries:
        smem, blocks = ctypes.c_int(), ctypes.c_int()
        err = query(ctypes.byref(smem), ctypes.byref(blocks))
        check(err == 0, f"occupancy query ({what}): CUDA error {err}")
        kind = "static" if what.startswith("conv0") else "dynamic"
        log(f"[build] {what}: {smem.value} bytes of {kind} shared memory a block, "
            f"{blocks.value} blocks per SM")


class Phase:
    """Prints a phase's seconds when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        log(f"[phase] {self.name}: {time.perf_counter() - self.t0:.1f} s")


def check_kernels(calls, max_err):
    for name, variants in calls.items():
        for variant, kernel, plain in variants:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {variant}: {tuple(got.shape)} {got.dtype} "
                  f"vs {tuple(want.shape)} {want.dtype}")
            cos, err = compare(got, want)
            ratio = within_tolerance(got, want)
            log(f"[kernel] {name} {variant} {tuple(got.shape)}: cos {cos:.7f} "
                f"max_abs_err {err:.3e} (max err / bound {ratio:.3f})")
            check(cos > COS_KERNEL and ratio <= 1.0, f"{name} {variant} vs plain")
            max_err[name] = max(max_err.get(name, 0.0), err)
            del got, want


def time_kernels(calls, inputs, label, entries, launches, max_err, first_only=True):
    """Times each kernel (and its plain version, in turns) on its inputs
    (`inputs`: name -> the input dict its calls were built on, the main
    path's timing shapes); the first variant of each name fills its entry
    of the kernels line, with its bound and the library call's time."""
    for name, variants in calls.items():
        for k, (variant, kernel, plain) in enumerate(variants[:1] if first_only else variants):
            t = [cuda_ms(f, 10) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            bound_ms, bound_by = kernel_bound(name, inputs[name], k)
            if k:
                log(f"[timing] {name} {variant} {label}: kernel {ms:.3f} ms, "
                    f"plain {plain_ms:.3f} ms"
                    + (f", bound {bound_ms:.4f} ms ({bound_by})"
                       if name == "fused_int8_linear" else ""))
                continue
            library = library_call(name, inputs[name])
            library_ms = None
            if library is not None:
                library_ms = (cuda_ms(library, 10) + cuda_ms(library, 10)) / 2
                del library
            log(f"[timing] {name} {variant} {label}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
                f", bound {bound_ms:.4f} ms ({bound_by}), library "
                + ("-" if library_ms is None else f"{library_ms:.3f} ms"))
            source, replaces = KERNELS[name]
            entries[name] = {"name": name, "route": "cuda", "source": source,
                             "replaces": replaces, "launches": main_launches(launches, name),
                             "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": library_ms}


def check_drift(hs_gpu, hs_cpu, hs_f32, h_lens, what):
    """A DRIFT_PATHS path's card states against f32 no farther than its CPU
    states (the wrappers' plain versions) are, layer by layer, within
    DRIFT_MARGIN; all on the CPU."""
    card = layer_cosines(hs_gpu.float(), hs_f32.float(), h_lens)
    cpu = layer_cosines(hs_cpu.float(), hs_f32.float(), h_lens)
    worst = min(c - p for c, p in zip(card, cpu))
    log(f"[drift {what}] card min {min(card):.6f}, CPU min {min(cpu):.6f}, worst card - CPU "
        f"{worst:+.6f}: card " + " ".join(f"{c:.5f}" for c in card))
    check(worst > -DRIFT_MARGIN, f"drift from f32, card vs CPU ({what})")


def weighted_rule(w, hs, T):
    """The JAX package's weighted sum of the stacked states hs [L+1, B, T',
    C] over their first T frames: acc + w.astype(dtype) * h, layer by layer
    in the model dtype (transformer.py:753-786)."""
    w = w.to(hs.dtype)
    acc = torch.zeros_like(hs[0, :, :T])
    for i in range(hs.shape[0]):
        acc = acc + w[i] * hs[i, :, :T]
    return acc


class OpShapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns while it is active."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def check_weighted(up, wrapper, gen, dev):
    """`apply_weighted` on HuBERT-Large int8 on the mixed 10 s batch: its
    launches (those of apply_standardized), [1, B, T', C] finite, against
    the weighted sum of the same model's `apply_standardized` states (within
    one bf16 step: the same states summed in the same order; bit-equality
    is printed), and no op of it returns the [25, B, T', C] stack (nor [24,
    ...]) that apply_standardized's make (a dispatch-mode spy); the peak
    device memory of each is printed (the extractor's temporaries set it)."""
    lens = LENS["10 s"]
    wavs, lens_t = batch(lens, max(lens), gen, dev)
    w = torch.softmax(torch.randn(up.num_layers, generator=gen), 0).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    peak, shapes = {}, {}
    for what in ("weighted", "standardized"):
        for x in wrapper.values():
            x.launches = 0
        torch.cuda.reset_peak_memory_stats()
        with OpShapes() as spy:
            if what == "weighted":
                fused, feat_lens = up.apply_weighted(w, wavs, lens_t)
            else:
                hs, _ = up.apply_standardized(wavs, lens_t)
            torch.cuda.synchronize()
        peak[what], shapes[what] = (torch.cuda.max_memory_allocated() - base) / 2**20, spy.shapes
        counts = {name: x.launches for name, x in wrapper.items() if x.launches}
        check(counts == {"conv0_ln_gelu": 1, "fused_attention_block": 24, "fused_int8_ffn": 24},
              f"apply_weighted ({what}) launch counts {counts}")
    B, T = len(lens), fused.shape[2]
    stacks = {(up.num_layers, B, T, up.hidden_size), (up.num_layers - 1, B, T, up.hidden_size)}
    check(bool(stacks & shapes["standardized"]) and not stacks & shapes["weighted"],
          "apply_weighted made a per-layer stack (or the spy saw none in apply_standardized)")
    check(tuple(fused.shape) == (1, B, T, up.hidden_size) and fused.dtype == torch.bfloat16,
          f"apply_weighted shape {tuple(fused.shape)} {fused.dtype}")
    check(bool(torch.isfinite(fused).all()), "non-finite weighted sum")
    r = max(lens) // T  # HuBERT's block rule: ceil(len / r) frames, at most T'
    check(feat_lens.tolist() == [min(-(-n // r), T) for n in lens],
          f"apply_weighted feat_lens {feat_lens.tolist()}")
    want = weighted_rule(w, hs, T)
    cos, err = compare(fused[0], want)
    ratio = within_tolerance(fused[0], want)
    log(f"[weighted] hubert int8 10 s B={B}: {tuple(fused.shape)}, vs the weighted sum of its "
        f"apply_standardized states cos {cos:.7f} max_abs_err {err:.3e} (max err / bound "
        f"{ratio:.3f}), bit-equal {torch.equal(fused[0], want)}; no [{up.num_layers}, {B}, "
        f"{T}, {up.hidden_size}] stack; peak device memory above the resident models "
        f"{peak['weighted']:.1f} MiB (apply_standardized {peak['standardized']:.1f} MiB)")
    check(cos > COS_KERNEL and ratio <= 1.0, "apply_weighted vs the weighted sum")


def check_checkpoint(hub, up, gen, dev):
    """ckpt= on the card: `up`'s model (wav2vec2-Large int8, seeded random
    weights) saved as an s3prl checkpoint (its state_dict, a fairseq
    model_cfg, task_cfg normalize) in a temporary directory, loaded back
    with hub.load(ckpt=...): the same configuration, the same weights and
    int8 cache, and bit-equal hidden states on the mixed 10 s batch."""
    import dataclasses
    import tempfile

    cfg = up.model.cfg
    model_cfg = {"_name": "wav2vec2", "extractor_mode": cfg.extractor_mode,
                 "conv_feature_layers": str(list(cfg.conv_feature_layers)),
                 "conv_bias": cfg.conv_bias, "encoder_layers": cfg.encoder_layers,
                 "encoder_embed_dim": cfg.encoder_embed_dim,
                 "encoder_ffn_embed_dim": cfg.encoder_ffn_embed_dim,
                 "encoder_attention_heads": cfg.encoder_attention_heads,
                 "layer_norm_first": cfg.layer_norm_first, "conv_pos": cfg.conv_pos,
                 "conv_pos_groups": cfg.conv_pos_groups, "dropout": 0.0,
                 "attention_dropout": 0.0}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wav2vec2_large.pt")
        torch.save({"model_weight": up.model.state_dict(), "model_cfg": model_cfg,
                    "task_cfg": {"normalize": cfg.normalize}}, path)
        size = os.path.getsize(path) / 2**30
        loaded = hub.load(MODELS["wav2vec2"], ckpt=path, dtype=torch.bfloat16, flash=True,
                          quantize=True, device=dev)
    seconds = time.perf_counter() - t0
    arch = ("extractor_mode", "conv_feature_layers", "conv_bias", "encoder_layers",
            "encoder_embed_dim", "encoder_ffn_embed_dim", "encoder_attention_heads",
            "layer_norm_first", "conv_pos", "conv_pos_groups", "pos_conv_depth",
            "feat_pad_rule", "normalize")
    got_cfg = dataclasses.asdict(loaded.model.cfg)
    want_cfg = dataclasses.asdict(cfg)
    check(all(got_cfg[f] == want_cfg[f] for f in arch), f"ckpt config {got_cfg}")
    a, b = up.model.state_dict(), loaded.model.state_dict()
    check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a),
          "ckpt state_dict differs")
    for la, lb in zip(up.model.encoder.layers, loaded.model.encoder.layers):
        pairs = [(la.self_attn, lb.self_attn, n) for n in ("qkv", "out_proj")]
        pairs += [(la, lb, n) for n in ("fc1", "fc2")]
        check(all(torch.equal(x, y) for ma, mb, n in pairs
                  for x, y in zip(ma.qpair(n), mb.qpair(n))), "ckpt int8 cache differs")
    lens = LENS["10 s"]
    wavs, lens_t = batch(lens, max(lens), gen, dev)
    hs_a, hl_a = up.apply_standardized(wavs, lens_t)
    hs_b, hl_b = loaded.apply_standardized(wavs, lens_t)
    check(torch.equal(hs_a, hs_b) and torch.equal(hl_a, hl_b), "ckpt hidden states differ")
    log(f"[ckpt] wav2vec2_large_ll60k int8: a {size:.2f} GiB s3prl checkpoint saved and loaded "
        f"back in {seconds:.1f} s: configuration, weights, int8 cache and hidden states "
        f"{tuple(hs_b.shape)} bit-equal")


def time_weighted(up, wavs, lens_t, gen, it_lo, it_hi):
    """`apply_weighted` beside `apply_standardized` on the same model and
    batch (two chain lengths, marginal, best of 2, in turns), each with its
    peak device memory."""
    w = torch.softmax(torch.randn(up.num_layers, generator=gen), 0).to(wavs.device)
    B, secs = wavs.shape[0], wavs.shape[1] / SR
    fns = {"apply_standardized": lambda: up.apply_standardized(wavs, lens_t),
           "apply_weighted": lambda: up.apply_weighted(w, wavs, lens_t)}
    best = {(what, it): float("inf") for what in fns for it in (it_lo, it_hi)}
    for _ in range(2):
        for what, fn in fns.items():
            for it in (it_lo, it_hi):
                best[what, it] = min(best[what, it], it * cuda_ms(fn, it))
    for what, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        per_iter = (best[what, it_hi] - best[what, it_lo]) / (it_hi - it_lo)
        log(f"[timing] weighted sum hubert int8 B={B} x {secs:.0f} s, {what}: "
            f"{per_iter:.2f} ms/forward, {B * secs / (per_iter / 1e3):.1f} audio-s/s, peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# the probe training phase: tools/bench_train.py:50-73's setup (B, SECS,
# NUM_CLASSES, ITERS, Adam 1e-4) through the port's Trainer
PROBE_B, PROBE_SECS, PROBE_CLASSES, PROBE_ITERS, PROBE_LR = 32, 10.0, 10, 9, 1e-4
PROBE_STEPS = 8  # training steps on one fixed batch: the loss must fall
PROBE_RUN = {"conv0_ln_gelu": 1, "fused_attention_block": 24, "fused_int8_ffn": 24}
PROBE_COS = 0.999  # card vs CPU: each probe parameter's update, cosine


def probe_task(up):
    """bench_train's probe: featurizer -> UtteranceLevel(10, (256,),
    MeanPooling) -> CE."""
    from s3prl_tpu_torch.nn import UpstreamDownstreamModel, UtteranceLevel
    from s3prl_tpu_torch.task import UtteranceClassificationTask

    head = UtteranceLevel(up.hidden_size, PROBE_CLASSES, (256,), "MeanPooling")
    return UtteranceClassificationTask(UpstreamDownstreamModel(head, up.num_layers),
                                       PROBE_CLASSES)


def probe_optimizer(params):
    from s3prl_tpu_torch.train import Optimizer

    return Optimizer(params, name="Adam", lr=PROBE_LR, total_steps=1000, gradient_clipping=1.0)


def check_probe_training(up, wrapper, batch, exp_dir):
    """PROBE_STEPS train steps of the port's Trainer on one batch: each
    step's launches (PROBE_RUN, every other count 0, read just after the
    step with every count set to 0 just before it), the upstream in eval()
    and the probe in train() after each, the loss finite and falling."""
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    trainer = Trainer(up, probe_task(up), exp_dir, TrainerConfig(
        total_steps=1000, tensorboard=False, optimizer={"name": "Adam", "lr": PROBE_LR}))
    trainer.init(resume=False)
    losses = []
    for _ in range(PROBE_STEPS):
        for w in wrapper.values():
            w.launches = 0
        loss, _, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrapper.items()}
        check(launches == {name: PROBE_RUN.get(name, 0) for name in wrapper},
              f"probe train step launches {launches}")
        check(not up.model.training and trainer.task.module.training,
              "the upstream left eval() or the probe left train()")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"loss {losses}")
    log(f"[probe] hubert int8 B={PROBE_B} x {PROBE_SECS:.0f} s, Trainer + Adam {PROBE_LR}: "
        f"launches a step {PROBE_RUN} (every other count 0), upstream in eval(); losses over "
        f"{PROBE_STEPS} steps on one batch " + " ".join(f"{v:.5f}" for v in losses))
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return trainer


def check_probe_step_on_cpu(up, trainer, batch, train=False):
    """One probe step from the card's states (frozen, or in train mode with
    `train`), on the card and on the CPU from the same probe weights and
    Adam state (the states moved to the CPU): loss and gradient norm at
    rtol 1e-3, each parameter's update at cosine > PROBE_COS."""
    import copy

    hs, h_lens = up(batch["x"], batch["x_len"], train=train)
    task_cpu = probe_task(up)
    task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                     trainer.task.module.state_dict().items()})
    opt_cpu = probe_optimizer(task_cpu.module.parameters())
    opt_cpu.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
    before = {k: v.detach().cpu().clone() for k, v in trainer.task.module.state_dict().items()}
    loss_card, _, norm_card = trainer.probe_step(hs, h_lens, batch)
    t0 = time.perf_counter()
    loss_cpu, _ = task_cpu.loss_and_cache(hs.cpu(), h_lens.cpu(), batch, None, True)
    loss_cpu.backward()
    loss_cpu = loss_cpu.detach()
    from s3prl_tpu_torch.train.optimizers import global_norm

    norm_cpu = global_norm([p.grad for p in opt_cpu.params])
    opt_cpu.step()
    seconds = time.perf_counter() - t0
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss = {}
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = (abs(float(loss_card) / float(loss_cpu) - 1), abs(float(norm_card) / float(norm_cpu) - 1))
    log(f"[probe] one step from the card's states [{', '.join(map(str, hs.shape))}] "
        f"{hs.dtype}, card vs CPU ({seconds:.1f} s): loss {float(loss_card):.6f} / "
        f"{float(loss_cpu):.6f}, grad norm {float(norm_card):.6f} / {float(norm_cpu):.6f} "
        f"(rel {rel[0]:.2e}, {rel[1]:.2e}), update cosines "
        + " ".join(f"{k} {c:.6f}" for k, c in coss.items()))
    check(max(rel) < 1e-3 and min(coss.values()) > PROBE_COS, "probe step card vs CPU")


def profile_calls(fn, iters=3, warm=True):
    """(device idle share, {kernel name: device ms a call}) over `iters`
    calls (after one unprofiled call unless `warm` is False: the caller
    has just run it): 1 - the profiler's summed kernel time over the event
    time (tools/torch_wavlm_breakdown.py's `idle_share`). The device is
    traced alone (no host op events: less host overhead in the traced
    calls, and far less to sum where a step launches ~10^4 kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    kernels = {evt.key: evt.self_device_time_total / 1e3 / iters for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA}
    return 1.0 - sum(kernels.values()) / (start.elapsed_time(end) / iters), kernels


def idle_text(idle):
    """An idle share from `profile_calls` as printed: "not valid" where the
    kernel time summed over streams exceeds the calls' time (below 0)."""
    return f"{idle:.3f}" if idle >= 0 else f"not valid ({idle:.3f}: kernels overlap on streams)"


def time_probe_step(up, trainer, batch, smi):
    """The train step by tools/bench_train.py's protocol (chains of ITERS
    // 3 and ITERS steps, marginal, best of 3; CUDA events), beside the
    frozen forward alone, each with its peak device memory; then both
    under the profiler: the device's idle share and the kernels the step
    runs beyond the forward's."""
    lo, hi = max(PROBE_ITERS // 3, 1), PROBE_ITERS
    fns = {"train step": lambda: trainer.train_step(batch),
           "frozen forward alone": lambda: up(batch["x"], batch["x_len"])}
    best = {(what, n): float("inf") for what in fns for n in (lo, hi)}
    for _ in range(3):
        for what, fn in fns.items():
            for n in (lo, hi):
                best[what, n] = min(best[what, n], n * cuda_ms(fn, n))
    out = {}
    for what, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        per = (best[what, hi] - best[what, lo]) / (hi - lo)
        out[what] = per
        log(f"[timing] probe {what} hubert int8 B={PROBE_B} x {PROBE_SECS:.0f} s: {per:.2f} "
            f"ms/step, {PROBE_B * PROBE_SECS / (per / 1e3):.1f} audio-s/s (chains {lo}: "
            f"{best[what, lo]:.1f} ms, {hi}: {best[what, hi]:.1f} ms), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    log(f"[timing] probe step beyond the frozen forward: "
        f"{out['train step'] - out['frozen forward alone']:.2f} ms "
        f"({100 * (1 - out['frozen forward alone'] / out['train step']):.1f}% of the step)")
    prof = {what: profile_calls(fn) for what, fn in fns.items()}
    step_k, fwd_k = prof["train step"][1], prof["frozen forward alone"][1]
    extra = {name: ms - fwd_k.get(name, 0.0) for name, ms in step_k.items()}
    top = sorted(extra.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] probe hubert int8 B={PROBE_B}: device idle share train step "
        f"{idle_text(prof['train step'][0])}, frozen forward alone "
        f"{idle_text(prof['frozen forward alone'][0])};"
        f" kernel time a step {sum(step_k.values()):.2f} ms, forward {sum(fwd_k.values()):.2f} "
        f"ms; the step's kernels beyond the forward's (ms a step): "
        + "; ".join(f"{name[:70]} {ms:.3f}" for name, ms in top))


def check_recipe(wrapper, exp_dir):
    """CommonExample (pseudo audio, 4 steps of batch 4, valid every 2,
    test) through Problem.run, all four stages, on HuBERT-Large int8 at
    full depth: result.yaml, the step checkpoints and valid_best, the
    launches (K3 once and K1, K2 24 times a forward: 4 train steps, 2
    valid and 1 test batch), and an auto-resume of stage 2 that trains no
    step."""
    import yaml

    from s3prl_tpu_torch.problem import CommonExample
    from s3prl_tpu_torch.train import checkpoint as ckpt

    problem = CommonExample()
    config = problem.default_config()
    config.pop("target_dir")
    config["build_upstream"] = {"name": "hubert_large_ll60k", "extra_conf": {
        "dtype": "bf16", "flash": True, "quantize": True, "seed": 0}}
    config["train"]["tensorboard"] = False
    t0 = time.perf_counter()
    for w in wrapper.values():
        w.launches = 0
    run_recipe(problem, exp_dir, **config)
    launches = {name: w.launches for name, w in wrapper.items()}
    forwards = 4 + 2 + 1
    check(launches == {name: forwards * PROBE_RUN.get(name, 0) for name in wrapper},
          f"recipe launches {launches}")
    result = yaml.safe_load((exp_dir / "result.yaml").read_text())
    check(set(result) == {"test"} and 0.0 <= result["test"]["accuracy"] <= 1.0
          and np.isfinite(result["test"]["loss"]), f"result.yaml {result}")
    train_dir = exp_dir / "train"
    steps = sorted(d.name for d in train_dir.glob("step_*"))
    check(steps == ["step_2", "step_4"] and (train_dir / "valid_best").exists(),
          f"checkpoints {steps}")
    lines = (train_dir / "metrics.jsonl").read_text().splitlines()
    resumed = run_recipe(problem, exp_dir, start=2, stop=2, **config)["train_stage"]
    check(resumed.step == 4 and (train_dir / "metrics.jsonl").read_text().splitlines() == lines
          and ckpt.latest_checkpoint(train_dir).name == "step_4", "auto-resume")
    log(f"[recipe] CommonExample on hubert_large_ll60k int8 (24 layers), all four stages and "
        f"a resumed stage 2 in {time.perf_counter() - t0:.1f} s: result.yaml {result}, "
        f"checkpoints {steps} + valid_best, launches {forwards} forwards x {PROBE_RUN}; the "
        f"resume found step 4 and trained no step")


def probe_phase(wrapper, gen, dev, smi):
    """Phase 7: SUpstream's HuBERT-Large int8 on the card, the Trainer's
    steps on one B=32 x 10 s batch, one step against the CPU, the step's
    rate, then the CommonExample recipe, in a temporary directory."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch.nn import SUpstream

    up = SUpstream(MODELS["hubert"], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                 "quantize": True, "seed": 0}).upstream
    n = int(PROBE_SECS * SR)
    labels = np.random.RandomState(0).randint(0, PROBE_CLASSES, PROBE_B).astype(np.int32)
    batch = {"x": torch.randn(PROBE_B, n, generator=gen).to(dev),
             "x_len": torch.full((PROBE_B,), n).to(dev), "class_id": labels}
    with tempfile.TemporaryDirectory() as tmp:
        trainer = check_probe_training(up, wrapper, batch, Path(tmp) / "probe")
        check_probe_step_on_cpu(up, trainer, batch)
        time_probe_step(up, trainer, batch, smi)
        del trainer, up, batch
        check_recipe(wrapper, Path(tmp) / "recipe")



# the CTC phase: SUPERB ASR's probe (superb_asr.py:184-252's downstream and
# optimizer) on one fixed batch with lengths drawn from 5-10 s
ASR_B, ASR_SECS, ASR_STEPS, ASR_LR, ASR_ITERS = 32, (5.0, 10.0), 6, 1e-4, 9
ASR_CHARS_PER_SEC = 12  # random letters and spaces, about read speech's rate
ASR_ALPHABET = "abcdefghijklmnopqrstuvwxyz '"  # LibriSpeech's characters: 31 tokens
ASR_CPU_B = 4  # the card-vs-CPU step's utterances (the BLSTM's f32 step on the CPU)
ASR_COS = 0.999


def asr_task(up, tok, dropout=0.2):
    """SuperbASR's probe: featurizer -> RNNEncoder(hidden 1024, 2 layers,
    proj 1024) -> CTC over the characters."""
    from s3prl_tpu_torch.nn import RNNEncoder, UpstreamDownstreamModel
    from s3prl_tpu_torch.task import Speech2TextCTCTask

    head = RNNEncoder(up.hidden_size, tok.vocab_size, 1024, 2, proj_size=1024, dropout=dropout)
    return Speech2TextCTCTask(UpstreamDownstreamModel(head, up.num_layers), tok)


def asr_batch(gen, dev, tok, B=ASR_B, seed=0):
    """B utterances of lengths drawn from 5-10 s, transcripts of random
    words at ASR_CHARS_PER_SEC, collated as the recipe collates them."""
    from s3prl_tpu_torch.data.collate import pad_collate

    rng = np.random.RandomState(seed)
    lens = rng.randint(int(ASR_SECS[0] * SR), int(ASR_SECS[1] * SR) + 1, B)
    items = []
    for b, n in enumerate(lens):
        words, chars = [], int(ASR_CHARS_PER_SEC * n / SR)
        while sum(len(w) + 1 for w in words) < chars:
            words.append("".join(rng.choice(list(ASR_ALPHABET[:26]), rng.randint(2, 8))))
        text = " ".join(words)[:chars].strip()
        items.append({"class_ids": np.asarray(tok.encode(text), np.int32), "labels": text,
                      "unique_name": f"asr_{b}"})
    x = torch.randn(B, int(lens.max()), generator=gen) * (torch.arange(int(lens.max()))[None]
                                                          < torch.from_numpy(lens)[:, None])
    return {"x": x.to(dev), "x_len": torch.from_numpy(lens).to(dev), **pad_collate(items)}


def sub_batch(batch, n):
    return {k: v[:n] for k, v in batch.items()}


def check_asr_training(up, wrapper, batch, exp_dir, tok):
    """ASR_STEPS train steps of the Trainer (Adam 1e-4, clip 1.0) on one
    batch: each step's launches (PROBE_RUN, every other count 0, the counts
    set to 0 just before the step and read just after it), the upstream in
    eval() and the probe in train(), the loss finite and falling."""
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    trainer = Trainer(up, asr_task(up, tok), exp_dir, TrainerConfig(
        total_steps=1000, tensorboard=False, gradient_clipping=1.0,
        optimizer={"name": "Adam", "lr": ASR_LR}))
    trainer.init(resume=False)
    losses = []
    for _ in range(ASR_STEPS):
        for w in wrapper.values():
            w.launches = 0
        loss, _, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrapper.items()}
        check(launches == {name: PROBE_RUN.get(name, 0) for name in wrapper},
              f"asr train step launches {launches}")
        check(not up.model.training and trainer.task.module.training,
              "the upstream left eval() or the probe left train()")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"loss {losses}")
    frames = int(((batch["x_len"] - 1) // 320 + 1).sum())
    log(f"[asr] hubert int8 B={ASR_B} x {ASR_SECS[0]:.0f}-{ASR_SECS[1]:.0f} s ({frames} valid "
        f"frames), RNNEncoder(1024, 2 layers, proj 1024, dropout 0.2) -> CTC over "
        f"{tok.vocab_size} tokens, Trainer + Adam {ASR_LR}: launches a step {PROBE_RUN} (every "
        f"other count 0), upstream in eval(); losses over {ASR_STEPS} steps on one batch "
        + " ".join(f"{v:.4f}" for v in losses))
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    return trainer


def check_asr_step_on_cpu(up, trainer, batch, tok):
    """One probe step from the card's states of ASR_CPU_B utterances, on
    the card and on the CPU from the same probe weights and Adam state,
    dropout off on both (their generators differ): loss and gradient norm
    at rtol 1e-3, each parameter's update at cosine > ASR_COS."""
    import copy

    from s3prl_tpu_torch.train.optimizers import global_norm

    sub = sub_batch(batch, ASR_CPU_B)
    hs, h_lens = up(sub["x"], sub["x_len"])
    task_cpu = asr_task(up, tok, dropout=0.0)
    task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                     trainer.task.module.state_dict().items()})
    opt_cpu = probe_optimizer(task_cpu.module.parameters())
    opt_cpu.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
    before = {k: v.detach().cpu().clone() for k, v in trainer.task.module.state_dict().items()}
    head = trainer.task.module.downstream
    dropout, head.p = head.p, 0.0
    try:
        loss_card, _, norm_card = trainer.probe_step(hs, h_lens, sub)
    finally:
        head.p = dropout
    t0 = time.perf_counter()
    loss_cpu, _ = task_cpu.loss_and_cache(hs.cpu(), h_lens.cpu(), sub, None, True)
    loss_cpu.backward()
    loss_cpu = loss_cpu.detach()
    norm_cpu = global_norm([p.grad for p in opt_cpu.params])
    opt_cpu.step()
    seconds = time.perf_counter() - t0
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss = {}
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        if a.norm() == 0 and b.norm() == 0:  # bias_ih: held at zero
            continue
        coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = (abs(float(loss_card) / float(loss_cpu) - 1),
           abs(float(norm_card) / float(norm_cpu) - 1))
    log(f"[asr] one step from the card's states [{', '.join(map(str, hs.shape))}] {hs.dtype}, "
        f"card vs CPU ({seconds:.1f} s on the CPU): loss {float(loss_card):.6f} / "
        f"{float(loss_cpu):.6f}, grad norm {float(norm_card):.6f} / {float(norm_cpu):.6f} "
        f"(rel {rel[0]:.2e}, {rel[1]:.2e}), update cosines min {min(coss.values()):.6f}: "
        + " ".join(f"{k.replace('downstream.', '')} {c:.6f}" for k, c in coss.items()))
    check(max(rel) < 1e-3 and min(coss.values()) > ASR_COS, "asr step card vs CPU")
    check(all(not v.any() for k, v in after_card.items() if ".bias_ih_" in k),
          "bias_ih left zero")


def check_ctc_edges(gen, dev, tok):
    """The CTC loss and its logit gradient on the card against the CPU on
    [4, 499, V] logits: a feasible row, one with repeats, one whose 5 frames
    cannot emit its 20 tokens and one with no frame (optax's ~1e5 for the
    last two): values at rtol 1e-5; each row's gradient within 8 f32 steps
    at its loss's magnitude (the gradient is exp(log-probability sums of
    that magnitude minus the loss), so one rounding step there is a
    relative error of one step: 1.2e-4 at a loss of 1,800, 7.8e-3 at 1e5)
    and at cosine > 0.9999."""
    from s3prl_tpu_torch.ops.ctc import ctc_loss

    V = tok.vocab_size
    logits = torch.randn(4, 499, V, generator=gen) * 2
    rng = np.random.RandomState(1)
    labels = rng.randint(3, V, (4, 60))
    labels[1, :6] = [5, 5, 5, 7, 7, 5]
    label_lens = np.asarray([60, 40, 20, 10])
    frame_lens = torch.tensor([499, 300, 5, 0])
    out = {}
    for where in ("cpu", dev):
        z = logits.to(where, copy=True).requires_grad_()
        per_seq = ctc_loss(z, frame_lens, labels, label_lens)
        per_seq.sum().backward()
        out[str(where)] = per_seq.detach().cpu().double(), z.grad.cpu().double()
    (v_card, g_card), (v_cpu, g_cpu) = out["cuda"], out["cpu"]
    rel = float(((v_card - v_cpu).abs() / v_cpu.abs()).max())
    err = (g_card - g_cpu).abs().flatten(1).max(1).values
    step = torch.exp2(torch.floor(torch.log2(v_cpu.abs())) - 23)
    cos = [float(a @ b / (a.norm() * b.norm())) if b.norm() > 0 else float(a.norm() == 0)
           for a, b in zip(g_card.flatten(1), g_cpu.flatten(1))]
    log(f"[asr] CTC on the card vs the CPU, rows (frames, tokens) (499, 60) (300, 40 with "
        f"repeats) (5, 20) (0, 10): card {v_card.tolist()}, CPU {v_cpu.tolist()} (rel "
        f"{rel:.2e}); logit gradient max abs error by row {[f'{e:.2e}' for e in err.tolist()]} "
        f"(bounds {[f'{8 * s:.2e}' for s in step.tolist()]}), cosines "
        f"{[f'{c:.7f}' for c in cos]}")
    check(rel < 1e-5 and bool((err <= 8 * step).all()) and min(cos) > 0.9999
          and float(v_card[2]) > 9e4 and float(v_card[3]) > 9e4
          and bool(torch.isfinite(g_card).all()), "CTC loss card vs CPU")


def time_asr_step(up, trainer, batch, smi):
    """The ASR train step and the frozen forward alone by phase 7's
    protocol (chains of ASR_ITERS // 3 and ASR_ITERS, marginal, best of 3,
    CUDA events), each with its peak device memory; then both under the
    profiler: the device's idle share and the kernels the step runs beyond
    the forward's."""
    lo, hi = max(ASR_ITERS // 3, 1), ASR_ITERS
    fns = {"train step": lambda: trainer.train_step(batch),
           "frozen forward alone": lambda: up(batch["x"], batch["x_len"])}
    best = {(what, n): float("inf") for what in fns for n in (lo, hi)}
    for _ in range(3):
        for what, fn in fns.items():
            for n in (lo, hi):
                best[what, n] = min(best[what, n], n * cuda_ms(fn, n))
    audio = float(batch["x_len"].sum()) / SR
    out = {}
    for what, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        per = (best[what, hi] - best[what, lo]) / (hi - lo)
        out[what] = per
        log(f"[timing] asr {what} hubert int8 B={ASR_B} x {ASR_SECS[0]:.0f}-{ASR_SECS[1]:.0f} s "
            f"({audio:.1f} s of audio, padded to {batch['x'].shape[1] / SR:.2f} s): {per:.2f} "
            f"ms/step, {audio / (per / 1e3):.1f} audio-s/s (chains {lo}: {best[what, lo]:.1f} "
            f"ms, {hi}: {best[what, hi]:.1f} ms), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    log(f"[timing] asr step beyond the frozen forward: "
        f"{out['train step'] - out['frozen forward alone']:.2f} ms "
        f"({100 * (1 - out['frozen forward alone'] / out['train step']):.1f}% of the step)")
    head = trainer.task.module.downstream
    lens = ((batch["x_len"] - 1) // 320 + 1).cpu()
    x = torch.randn(ASR_B, int(lens.max()), 1024, device=batch["x"].device, requires_grad=True)
    for i in range(2):  # each LSTM layer's forward and backward alone on its input's shape
        lstm = getattr(head, f"lstm_{i}")
        ms = min(cuda_ms(lambda: lstm(x, lens).sum().backward(), 3) for _ in range(3))
        log(f"[timing] asr lstm_{i} (both directions) forward + backward alone on [{ASR_B}, "
            f"{x.shape[1]}, 1024]: {ms:.2f} ms ({100 * ms / out['train step']:.1f}% of the step)")
    trainer.task.module.zero_grad(set_to_none=True)
    prof = {what: profile_calls(fn) for what, fn in fns.items()}
    step_k, fwd_k = prof["train step"][1], prof["frozen forward alone"][1]
    extra = {name: ms - fwd_k.get(name, 0.0) for name, ms in step_k.items()}
    groups = {"cuDNN RNN cells": ("rnn", "lstm", "RNN", "LSTM", "elemWise", "ersist"),
              "CTC": ("ctc",), "GEMM (cuDNN's recurrence and cuBLAS)": ("gemm", "Kernel2")}
    shares = dict.fromkeys([*groups, "other"], 0.0)
    for name, ms in extra.items():
        shares[next((g for g, keys in groups.items() if any(k in name for k in keys)),
                    "other")] += ms
    top = sorted(extra.items(), key=lambda kv: -kv[1])[:12]
    # cuDNN runs the two directions on streams of their own: kernel time
    # summed over streams can exceed the step's time, so this idle share is
    # a lower bound
    log(f"[profile] asr hubert int8 B={ASR_B}: device idle share train step "
        f"{idle_text(prof['train step'][0])}, frozen forward alone "
        f"{idle_text(prof['frozen forward alone'][0])};"
        f" kernel time a step {sum(step_k.values()):.2f} ms, forward {sum(fwd_k.values()):.2f} "
        f"ms, beyond it {sum(extra.values()):.2f} ms (by name: "
        + ", ".join(f"{g} {ms:.2f} ms" for g, ms in shares.items())
        + "); the step's kernels beyond the forward's (ms a step): "
        + "; ".join(f"{name[:80]} {ms:.3f}" for name, ms in top))


def check_asr_decoding(up, trainer, batch, tok):
    """Trainer.evaluate on the batch (greedy CTC: WER, CER); then
    BeamDecoder(beam 20) on 4 utterances' log-probs moved to the host: ids
    of the vocabulary; and a peaked posterior decodes to its text."""
    from s3prl_tpu_torch.nn import BeamDecoder

    t0 = time.perf_counter()
    logs = trainer.evaluate([batch], mode="asr-check")
    check(set(logs) == {"loss", "wer", "cer"} and all(np.isfinite(v) for v in logs.values())
          and logs["wer"] >= 0 and logs["cer"] >= 0, f"evaluate {logs}")
    seconds = time.perf_counter() - t0
    module = trainer.task.module.eval()
    sub = sub_batch(batch, 4)
    with torch.no_grad():
        hs, h_lens = up(sub["x"], sub["x_len"])
        logits, lens = module(hs, h_lens.cpu())
    log_probs = torch.log_softmax(logits.float(), -1).cpu().numpy()
    decoder = BeamDecoder(tok, beam_size=20)
    t1 = time.perf_counter()
    hyps = [decoder.decode_ids(log_probs[b], int(lens[b])) for b in range(4)]
    beam_s = time.perf_counter() - t1
    check(all(all(0 < i < tok.vocab_size for i in h) for h in hyps), f"beam ids {hyps}")
    text = "HELLO WORLD"
    ids = [i for c in tok.encode(text) for i in (c, c, 0)]
    peaked = np.full((len(ids), tok.vocab_size), -20.0, np.float32)
    peaked[np.arange(len(ids)), ids] = -0.01
    check(decoder.decode(peaked) == text, f"peaked posterior -> {decoder.decode(peaked)!r}")
    log(f"[asr] Trainer.evaluate on the batch ({seconds:.1f} s): {logs}; BeamDecoder(beam 20) "
        f"on 4 utterances' log-probs ({beam_s * 1e3:.0f} ms on the host, frames "
        f"{[int(n) for n in lens]}): {[len(h) for h in hyps]} tokens, first "
        f"{tok.decode(hyps[0])[:40]!r}; a peaked posterior decodes to {text!r}")
    module.train()


def librispeech_flac_tree(root, gen):
    """LibriSpeech-shaped: train-clean-100 8, dev-clean 2 and test-clean 2
    utterances of 2-4 s as 16-bit FLAC (the port's write_flac), with their
    .trans.txt."""
    from s3prl_tpu_torch.data.flac import write_flac

    rng = np.random.RandomState(2)
    for split, n in (("train-clean-100", 8), ("dev-clean", 2), ("test-clean", 2)):
        d = root / split / "1089" / "134686"
        d.mkdir(parents=True)
        lines = []
        for i in range(n):
            uid = f"1089-134686-{i:04d}"
            secs = float(rng.uniform(2.0, 4.0))
            pcm = (torch.randn(int(secs * SR), generator=gen) * 3000).round().to(torch.int32)
            write_flac(d / f"{uid}.flac", pcm.numpy(), SR)
            words = ["".join(rng.choice(list(ASR_ALPHABET[:26]), rng.randint(2, 8)))
                     for _ in range(int(secs * 2.5))]
            lines.append(f"{uid} {' '.join(words).upper()}")
        (d / "1089-134686.trans.txt").write_text("\n".join(lines) + "\n")
    return root


def check_asr_recipe(wrapper, exp_dir, gen):
    """SuperbASR through Problem.run, all four stages, on a LibriSpeech
    tree of FLAC files with build_upstream hubert_large_ll60k int8 at full
    depth and the recipe's full-width downstream (4 steps of batch 32,
    valid every 2): result.yaml with the WER, step_2, step_4 and
    valid_best, the launches of its 7 forwards; then inference on one FLAC
    file, which prints its transcription."""
    import yaml

    from s3prl_tpu_torch.problem import SuperbASR

    corpus = librispeech_flac_tree(exp_dir / "LibriSpeech", gen)
    problem = SuperbASR()
    config = problem.default_config()
    config.pop("target_dir")
    config["prepare_data"] = {"librispeech": str(corpus)}
    config["build_upstream"] = {"name": "hubert_large_ll60k", "extra_conf": {
        "dtype": "bf16", "flash": True, "quantize": True, "seed": 0}}
    config["train"].update(total_steps=4, log_step=2, eval_step=2, save_step=2, tensorboard=False)
    work = exp_dir / "superb_asr"
    t0 = time.perf_counter()
    for w in wrapper.values():
        w.launches = 0
    run_recipe(problem, work, **config)
    launches = {name: w.launches for name, w in wrapper.items()}
    forwards = 4 + 2 + 1  # train steps, two valid passes of one batch, one test batch
    check(launches == {name: forwards * PROBE_RUN.get(name, 0) for name in wrapper},
          f"recipe launches {launches}")
    result = yaml.safe_load((work / "result.yaml").read_text())
    check(set(result) == {"test"} and set(result["test"]) == {"loss", "wer", "cer"}
          and np.isfinite(result["test"]["loss"]) and result["test"]["wer"] >= 0,
          f"result.yaml {result}")
    train_dir = work / "train"
    steps = sorted(d.name for d in train_dir.glob("step_*"))
    check(steps == ["step_2", "step_4"] and (train_dir / "valid_best").exists(),
          f"checkpoints {steps}")
    seconds = time.perf_counter() - t0
    wav = next((corpus / "test-clean").rglob("*.flac"))
    for w in wrapper.values():
        w.launches = 0
    t1 = time.perf_counter()
    text = problem.inference(work, config, str(wav))
    launches = {name: w.launches for name, w in wrapper.items()}
    check(isinstance(text, str) and launches == {name: PROBE_RUN.get(name, 0) for name in wrapper}
          and (work / "inference.txt").read_text() == f"{wav.stem} {text}\n",
          f"inference {text!r} launches {launches}")
    log(f"[recipe] SuperbASR on a FLAC LibriSpeech tree (8 / 2 / 2 utterances of 2-4 s) with "
        f"hubert_large_ll60k int8 (24 layers) and RNNEncoder(1024, 2, 1024): all four stages "
        f"in {seconds:.1f} s: result.yaml {result}, checkpoints {steps} + valid_best, launches "
        f"{forwards} forwards x {PROBE_RUN}; inference on {wav.name} in "
        f"{time.perf_counter() - t1:.1f} s (one forward): {text!r}")


def asr_phase(wrapper, gen, dev, smi):
    """Phase 8: SUPERB ASR on the card: the BLSTM-CTC probe over
    SUpstream's HuBERT-Large int8 on one B=32 x 5-10 s batch (training,
    a step against the CPU, the CTC edge rows, timing, decoding), then the
    SuperbASR recipe on FLAC files with inference, in a temporary
    directory."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch.data.encoder import CharacterTokenizer
    from s3prl_tpu_torch.nn import SUpstream

    tok = CharacterTokenizer.from_text([ASR_ALPHABET])
    check(tok.vocab_size == 31, f"vocab {tok.vocab_size}")
    up = SUpstream(MODELS["hubert"], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                 "quantize": True, "seed": 0}).upstream
    batch = asr_batch(gen, dev, tok)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = check_asr_training(up, wrapper, batch, Path(tmp) / "asr", tok)
        check_asr_step_on_cpu(up, trainer, batch, tok)
        check_ctc_edges(gen, dev, tok)
        time_asr_step(up, trainer, batch, smi)
        check_asr_decoding(up, trainer, batch, tok)
        del trainer, up, batch
        check_asr_recipe(wrapper, Path(tmp), gen)


# the speaker phase: SUPERB ASV (superb_asv.py:134-151: SuperbXvector(512,
# 512, 1500), AM-softmax over VoxCeleb1's 1,211 dev speakers, AdamW 1e-4,
# clip 1e3, accumulation 5), the GE2E recipe's batch (10 speakers x 10
# utterances of 5 s, SAP(256), AdamW 4e-4) and SUPERB SD (superb_sd.py:
# 67-90: 20-s chunks, one LSTM layer of 512, PIT, Adam 1e-4, clip 1,
# accumulation 4)
SPK_ITERS, SPK_COS, SPK_CPU_B = 9, 0.999, 4
SD_RUN = {"conv0_ln_gelu": 1, "fused_qkv_attention_outproj": 24, "fused_int8_ffn": 24}
K8_RUN = {"conv0_ln_gelu": 1, "online_flash_attention": 24, "fused_int8_ffn": 24}
# task -> (batch B, seconds (a range or one), micro-steps run, optimizer, clip,
# accumulation, launches a step)
SPEAKER = {
    "asv": (10, (4.0, 10.0), 10, {"name": "AdamW", "lr": 1e-4}, 1000.0, 5, PROBE_RUN),
    "ge2e": (100, (5.0, 5.0), 4, {"name": "AdamW", "lr": 4e-4}, 1000.0, 1, PROBE_RUN),
    "sd": (8, (20.0, 20.0), 8, {"name": "Adam", "lr": 1e-4}, 1.0, 4, SD_RUN),
}
ASV_SPEAKERS, GE2E_M, SD_FRAMES = 1211, 10, 2000  # 2,000 label frames of 160 samples


def speaker_task(name, up):
    """The recipes' probes at full width over `up`'s states."""
    from s3prl_tpu_torch.nn import (SapSpeakerHead, SuperbDiarizationModel, SuperbXvector,
                                    UpstreamDownstreamModel)
    from s3prl_tpu_torch.task import (DiarizationPITTask, Ge2eVerificationTask,
                                      SpeakerVerificationTask)

    if name == "asv":
        return SpeakerVerificationTask(UpstreamDownstreamModel(
            SuperbXvector(up.hidden_size, 512, 512, 1500), up.num_layers), ASV_SPEAKERS)
    if name == "ge2e":
        return Ge2eVerificationTask(UpstreamDownstreamModel(
            SapSpeakerHead(up.hidden_size, 256), up.num_layers), GE2E_M)
    return DiarizationPITTask(UpstreamDownstreamModel(
        SuperbDiarizationModel(up.hidden_size, 2, 512, 1), up.num_layers))


def sd_labels(B, rng):
    """Two speakers' overlapping segments over a 20-s chunk rasterised by
    rasterize_labels (2,000 frames): A from 0 to 7-10 s and again from 14
    s, B from 6-9 s to 16 s; rows 1 and 5 list the speakers the other way
    round, so their PIT permutation is the other one."""
    from s3prl_tpu_torch.data.corpus.kaldi_diar import rasterize_labels

    out = []
    for b in range(B):
        a_end, b_start = rng.uniform(7.0, 10.0), rng.uniform(6.0, 9.0)
        segments = [("A", 0.0, a_end), ("A", 14.0, 20.0), ("B", b_start, 16.0)]
        out.append(rasterize_labels(segments, SD_FRAMES, ["B", "A"] if b in (1, 5) else
                                    ["A", "B"]))
    return np.stack(out)


def speaker_batch(name, gen, dev, seed=0):
    """The task's fixed batch: waves of lengths drawn from its range (4-10
    s for ASV; 100 crops of 5 s in speaker-major order for GE2E; 8 chunks
    of 20 s for SD), its labels as the recipe's collation gives them."""
    B, secs = SPEAKER[name][:2]
    rng = np.random.RandomState(seed)
    lens = rng.randint(int(secs[0] * SR), int(secs[1] * SR) + 1, B)
    n = int(lens.max())
    x = torch.randn(B, n, generator=gen) * (torch.arange(n)[None] < torch.from_numpy(lens)[:, None])
    batch = {"x": x.to(dev), "x_len": torch.from_numpy(lens).to(dev)}
    if name == "asv":
        batch["class_id"] = rng.randint(0, ASV_SPEAKERS, B).astype(np.int32)
    elif name == "sd":
        batch["label"] = sd_labels(B, rng)
        batch["label_len"] = np.full(B, SD_FRAMES, np.int32)
    return batch


def speaker_trainer(name, up, exp_dir):
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    _, _, _, optimizer, clip, accumulate, _ = SPEAKER[name]
    trainer = Trainer(up, speaker_task(name, up), exp_dir, TrainerConfig(
        total_steps=1000, tensorboard=False, gradient_clipping=clip,
        gradient_accumulate=accumulate, optimizer=optimizer))
    trainer.init(resume=False)
    return trainer


def check_speaker_training(name, up, wrapper, batch, exp_dir):
    """The task's micro-steps on its fixed batch through the Trainer: each
    step's launches (its run, every other count 0, the counts set to 0
    just before the step and read just after it), the upstream in eval()
    and the probe in train(), the loss finite and lower after the updates
    than at the first step."""
    B, secs, steps, optimizer, clip, accumulate, run = SPEAKER[name]
    trainer = speaker_trainer(name, up, exp_dir)
    losses, perms = [], None
    for _ in range(steps):
        for w in wrapper.values():
            w.launches = 0
        loss, cache, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == {k: run.get(k, 0) for k in wrapper}, f"{name} step launches {launches}")
        check(not up.model.training and trainer.task.module.training,
              "the upstream left eval() or the probe left train()")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"{name} loss {losses}")
        if name == "sd":
            perms = cache["best_perm"].tolist()
    frames = int(((batch["x_len"] - 1) // 320 + 1).sum())
    log(f"[speaker] {name} hubert int8 B={B} x {secs[0]:.0f}-{secs[1]:.0f} s ({frames} valid "
        f"frames, padded to {(batch['x'].shape[1] - 1) // 320 + 1}), "
        f"{type(trainer.task.module.downstream).__name__} -> {type(trainer.task).__name__}, "
        f"{optimizer['name']} {optimizer['lr']}, clip {clip}, accumulation {accumulate}: "
        f"launches a step {run} (every other count 0), upstream in eval(); losses over {steps} "
        f"micro-steps ({steps // accumulate} updates) " + " ".join(f"{v:.5f}" for v in losses)
        + (f"; the last step's permutation a row {perms}" if perms else ""))
    check(losses[-1] < losses[0], f"{name}: the loss did not fall: {losses}")
    if perms is not None:
        check(len(set(perms)) == 2, f"sd permutations {perms}")
    return trainer


def one_update(name, task, state, hs, h_lens, batch):
    """One micro-step and one update of task `name`'s probe on the states,
    from the optimizer state `state` in an optimizer of accumulation 1:
    (loss, cache, gradient norm)."""
    from s3prl_tpu_torch.train import Optimizer
    from s3prl_tpu_torch.train.optimizers import global_norm

    _, _, _, optimizer, clip, _, _ = SPEAKER[name]
    opt = Optimizer(task.module.parameters(), total_steps=1000, gradient_clipping=clip,
                    **optimizer)
    opt.load_state_dict(state)
    loss, cache = task.loss_and_cache(hs, h_lens, batch, None, True)
    loss.backward()
    norm = global_norm([p.grad for p in opt.params])
    check(opt.step(), f"{name}: the update was skipped")
    return loss.detach(), cache, norm


# parameters whose gradient is zero but for rounding: each adds one value to
# every logit of a softmax (SAP's scores over time; GE2E's logits over the
# speakers), so Adam scales each device's rounding to a move of up to lr
SHIFT_PARAMS = (".attn.bias", "ge2e_b")


def check_speaker_step_on_cpu(name, up, trainer, batch):
    """One update of the probe from the card's states (the first
    SPK_CPU_B utterances; GE2E's 2 speakers x 10), on the card and on the
    CPU from the same probe weights and optimizer state: loss and gradient
    norm at rtol 1e-3, each parameter's update at cosine > SPK_COS (the
    task's parameters included; bias_ih held at zero; SHIFT_PARAMS' updates
    within 2 lr of each other), SD's permutation a row the same on both."""
    import copy

    sub = sub_batch(batch, 2 * GE2E_M if name == "ge2e" else SPK_CPU_B)
    hs, h_lens = up(sub["x"], sub["x_len"])
    task_cpu = speaker_task(name, up)
    task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                     trainer.task.module.state_dict().items()})
    state = trainer.optimizer.state_dict()
    check(state["mini_step"] == 0, f"{name}: mid-accumulation")
    before = {k: v.detach().cpu().clone() for k, v in trainer.task.module.state_dict().items()}
    card = one_update(name, trainer.task, copy.deepcopy(state), hs, h_lens, sub)
    t0 = time.perf_counter()
    cpu = one_update(name, task_cpu, copy.deepcopy(state), hs.cpu(), h_lens.cpu(), sub)
    seconds = time.perf_counter() - t0
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss, shifts = {}, {}
    lr = SPEAKER[name][3]["lr"]
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        if k.endswith(SHIFT_PARAMS):
            shifts[k] = float((a - b).abs().max())
        elif a.norm() > 0 or b.norm() > 0:  # bias_ih: held at zero
            coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = (abs(float(card[0]) / float(cpu[0]) - 1), abs(float(card[2]) / float(cpu[2]) - 1))
    perm = "" if not shifts else f", {SHIFT_PARAMS} updates apart by {shifts} (lr {lr})"
    if name == "sd":
        p_card, p_cpu = card[1]["best_perm"].tolist(), cpu[1]["best_perm"].tolist()
        check(p_card == p_cpu, f"sd permutations card {p_card} CPU {p_cpu}")
        perm = f", permutation a row {p_card} on both"
    log(f"[speaker] {name}: one update from the card's states [{', '.join(map(str, hs.shape))}] "
        f"{hs.dtype}, card vs CPU ({seconds:.1f} s on the CPU): loss {float(card[0]):.6f} / "
        f"{float(cpu[0]):.6f}, grad norm {float(card[2]):.6f} / {float(cpu[2]):.6f} (rel "
        f"{rel[0]:.2e}, {rel[1]:.2e}){perm}, update cosines min {min(coss.values()):.6f}: "
        + " ".join(f"{k.replace('downstream.', '')} {c:.6f}" for k, c in coss.items()))
    check(max(rel) < 1e-3 and min(coss.values()) > SPK_COS
          and all(d <= 2 * lr for d in shifts.values()), f"{name} step card vs CPU")
    check(all(not v.any() for k, v in after_card.items() if ".bias_ih_" in k),
          "bias_ih left zero")


SPEAKER_GROUPS = {"TDNN convs (cuDNN)": ("conv", "Conv", "implicit", "xmma_fprop", "dgrad",
                                         "wgrad"),
                  "cuDNN LSTM": ("rnn", "lstm", "RNN", "LSTM", "elemWise", "ersist"),
                  "GEMMs": ("gemm", "Gemm", "Kernel2", "cutlass")}


def time_speaker_step(name, up, trainer, batch, smi):
    """The task's train step (accumulation included: chains average its
    updates) and the frozen forward alone by phase 7's protocol (chains of
    SPK_ITERS // 3 and SPK_ITERS, marginal, best of 3, CUDA events), each
    with its audio-s/s and peak device memory; then both under the
    profiler: the device's idle share and the kernels the step runs beyond
    the forward's, grouped."""
    lo, hi = max(SPK_ITERS // 3, 1), SPK_ITERS
    fns = {"train step": lambda: trainer.train_step(batch),
           "frozen forward alone": lambda: up(batch["x"], batch["x_len"])}
    best = {(what, n): float("inf") for what in fns for n in (lo, hi)}
    for _ in range(3):
        for what, fn in fns.items():
            for n in (lo, hi):
                best[what, n] = min(best[what, n], n * cuda_ms(fn, n))
    audio = float(batch["x_len"].sum()) / SR
    B = batch["x"].shape[0]
    out = {}
    for what, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        per = (best[what, hi] - best[what, lo]) / (hi - lo)
        out[what] = per
        log(f"[timing] {name} {what} hubert int8 B={B} ({audio:.1f} s of audio, padded to "
            f"{batch['x'].shape[1] / SR:.2f} s): {per:.2f} ms/step, {audio / (per / 1e3):.1f} "
            f"audio-s/s (chains {lo}: {best[what, lo]:.1f} ms, {hi}: {best[what, hi]:.1f} ms), "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    log(f"[timing] {name} step beyond the frozen forward: "
        f"{out['train step'] - out['frozen forward alone']:.2f} ms "
        f"({100 * (1 - out['frozen forward alone'] / out['train step']):.1f}% of the step)")
    prof = {what: profile_calls(fn) for what, fn in fns.items()}
    step_k, fwd_k = prof["train step"][1], prof["frozen forward alone"][1]
    extra = {k: ms - fwd_k.get(k, 0.0) for k, ms in step_k.items()}
    shares = dict.fromkeys([*SPEAKER_GROUPS, "other"], 0.0)
    for k, ms in extra.items():
        shares[next((g for g, keys in SPEAKER_GROUPS.items() if any(s in k for s in keys)),
                    "other")] += ms
    top = sorted(extra.items(), key=lambda kv: -kv[1])[:10]
    log(f"[profile] {name} hubert int8 B={B}: device idle share train step "
        f"{idle_text(prof['train step'][0])}, frozen forward alone "
        f"{idle_text(prof['frozen forward alone'][0])};"
        f" kernel time a step {sum(step_k.values()):.2f} ms, forward {sum(fwd_k.values()):.2f} "
        f"ms, beyond it {sum(extra.values()):.2f} ms (by name: "
        + ", ".join(f"{g} {ms:.2f} ms" for g, ms in shares.items())
        + "); the step's kernels beyond the forward's (ms a step): "
        + "; ".join(f"{k[:80]} {ms:.3f}" for k, ms in top))


def voxceleb1_tree(root, gen, test_secs):
    """VoxCeleb1-shaped: wav/id1000{1,2,3}/s/0000{0..3}.wav (2-4 s, the
    dev speakers) and wav/id10270/s/ and id10271/s/ holding the test
    utterances of `test_secs` seconds, with veri_test_v2.txt over every
    test pair."""
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    rng = np.random.RandomState(3)
    test = []
    for spk, secs in [*((f"id1000{s}", [rng.uniform(2.0, 4.0) for _ in range(4)])
                        for s in (1, 2, 3)),
                      ("id10270", test_secs[::2]), ("id10271", test_secs[1::2])]:
        for u, sec in enumerate(secs):
            path = root / "wav" / spk / "s" / f"{u:05d}.wav"
            path.parent.mkdir(parents=True, exist_ok=True)
            _write_wav(path, (torch.randn(int(sec * SR), generator=gen) * 0.1).numpy())
            if spk in ("id10270", "id10271"):
                test.append(f"{spk}/s/{u:05d}.wav")
    lines = [f"{int(a.split('/')[0] == b.split('/')[0])} {a} {b}"
             for i, a in enumerate(test) for b in test[i + 1:]]
    (root / "veri_test_v2.txt").write_text("\n".join(lines) + "\n")
    return root


def speaker_recipe(problem, work, config, wrapper):
    """`run_recipe` with every count set to 0 before it: the launches."""
    for w in wrapper.values():
        w.launches = 0
    run_recipe(problem, work, **config)
    return {k: w.launches for k, w in wrapper.items()}


_RECIPE_UPSTREAMS = {}  # (entry, hub.load keywords) -> the Upstream recipe runs share


def run_recipe(problem, work, **config):
    """problem.run(work, **config), each upstream its stages build taken
    from one hub.load a configuration for every recipe run of the script:
    the first run loads it through the registry, the later
    stages and runs reuse it in place of drawing the same seed's weights
    again (seconds of a host's time each at full width)."""
    from s3prl_tpu_torch.upstream import registry

    load = registry.load

    def shared(name, **kwargs):
        key = (name, repr(sorted(kwargs.items())))
        if key not in _RECIPE_UPSTREAMS:
            _RECIPE_UPSTREAMS[key] = load(name, **kwargs)
        return _RECIPE_UPSTREAMS[key]

    registry.load = shared
    try:
        return problem.run(str(work), **config)
    finally:
        registry.load = load


def expect(*runs):
    """The launches of (forwards, run) pairs, every other count 0."""
    out = {}
    for forwards, run in runs:
        for k, n in run.items():
            out[k] = out.get(k, 0) + forwards * n
    return out


def check_speaker_recipes(wrapper, exp_dir, gen):
    """SuperbASV through Problem.run (all four stages, total_steps 4) on a
    VoxCeleb1 tree whose test split holds a 45-s utterance, so the test
    batch (padded to 45 s: bucket_max raised from the default 30 s, which
    pad_collate cannot fit) takes K8; Voxceleb2AMSoftmaxSegment's four
    stages, its evaluation on 8-s windows at a 4-s stride of a 20-s
    utterance (4 segments, one forward); SuperbSD's three stages on a Kaldi
    tree of 40-s recordings (two 20-s chunks each): result.yaml (EER and
    minDCF in [0, 1]; the DER), rttm/hyp.rttm and each run's launches."""
    import yaml

    from s3prl_tpu_torch.problem import SuperbASV, SuperbSD, Voxceleb2AMSoftmaxSegment
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    upstream = {"name": "hubert_large_ll60k", "extra_conf": {
        "dtype": "bf16", "flash": True, "quantize": True, "seed": 0}}
    steps = {"total_steps": 4, "log_step": 2, "save_step": 2, "tensorboard": False}
    for cls, test_secs, forwards in ((SuperbASV, [45.0, 3.0, 5.0], None),
                                     (Voxceleb2AMSoftmaxSegment, [20.0, 3.0, 5.0], 3)):
        t0 = time.perf_counter()
        name = cls.__name__
        corpus = voxceleb1_tree(exp_dir / f"{name}_corpus", gen, test_secs)
        problem = cls()
        config = problem.default_config()
        config.pop("target_dir")
        config.update(prepare_data={"voxceleb1": str(corpus)}, build_upstream=upstream,
                      bucket_max=16000 * 45)
        config["train"].update(steps)
        launches = speaker_recipe(problem, exp_dir / name, config, wrapper)
        # 12 training utterances in batches of 10 and 2: 4 steps; SuperbASV's test
        # batch holds the 45-s utterance (K8), the segment recipe one forward an
        # utterance, its 20-s one 4 segments of 8 s (K1 route)
        want = expect((4, PROBE_RUN), (1, K8_RUN) if forwards is None else (forwards, PROBE_RUN))
        check(launches == {k: want.get(k, 0) for k in wrapper}, f"{name} launches {launches}")
        result = yaml.safe_load((exp_dir / name / "result.yaml").read_text())["test"]
        check(set(result) == {"eer", "minDCF"} and all(0.0 <= v <= 1.0 for v in result.values()),
              f"{name} result.yaml {result}")
        log(f"[recipe] {name} on a VoxCeleb1 tree (3 dev speakers x 4 utterances of 2-4 s; test "
            f"utterances of {test_secs} s, {len(test_secs) * (len(test_secs) - 1) // 2} trials) "
            f"with hubert_large_ll60k int8 and its full-width downstream, 4 steps, in "
            f"{time.perf_counter() - t0:.1f} s: result.yaml {result}, launches {launches}")

    t0 = time.perf_counter()
    rng = np.random.RandomState(4)
    for split, n in (("train", 2), ("valid", 1), ("test", 1)):
        d = exp_dir / "kaldi" / split
        d.mkdir(parents=True)
        scp, segs, utt2spk = [], [], []
        for r in range(n):
            reco = f"{split}_reco{r}"
            path = exp_dir / "kaldi" / f"{reco}.wav"
            _write_wav(path, (torch.randn(40 * SR, generator=gen) * 0.05).numpy())
            scp.append(f"{reco} {path}")
            for u, (spk, s, e) in enumerate([("A", 0.0, rng.uniform(18, 24)),
                                             ("B", rng.uniform(14, 20), 33.0),
                                             ("A", 30.0, 40.0)]):
                segs.append(f"{reco}_u{u} {reco} {s:.2f} {e:.2f}")
                utt2spk.append(f"{reco}_u{u} {spk}")
        (d / "wav.scp").write_text("\n".join(scp) + "\n")
        (d / "segments").write_text("\n".join(segs) + "\n")
        (d / "utt2spk").write_text("\n".join(utt2spk) + "\n")
    problem = SuperbSD()
    config = problem.default_config()
    config.pop("target_dir")
    config.update(build_upstream=upstream, prepare_data={
        f"{s}_dir": str(exp_dir / "kaldi" / s) for s in ("train", "valid", "test")})
    config["train"].update(steps, eval_step=2)
    work = exp_dir / "SuperbSD"
    launches = speaker_recipe(problem, work, config, wrapper)
    want = expect((4 + 2 + 1, SD_RUN))  # 4 train steps, 2 valid passes, 1 test batch
    check(launches == {k: want.get(k, 0) for k in wrapper}, f"SuperbSD launches {launches}")
    result = yaml.safe_load((work / "result.yaml").read_text())["test"]
    check(set(result) == {"der", "loss"} and result["der"] >= 0 and np.isfinite(result["loss"]),
          f"SuperbSD result.yaml {result}")
    rttm = (work / "rttm" / "hyp.rttm").read_text().splitlines()
    check(all(line.split()[0] == "SPEAKER" and len(line.split()) == 10 for line in rttm),
          f"hyp.rttm {rttm[:3]}")
    chunks = len((work / "test.csv").read_text().splitlines()) - 1
    log(f"[recipe] SuperbSD on a Kaldi tree (train 2, valid 1, test 1 recordings of 40 s: "
        f"{chunks} test chunks of 20 s) with hubert_large_ll60k int8 and LSTM(512, 1 layer), 4 "
        f"steps of accumulation 4, valid every 2, in {time.perf_counter() - t0:.1f} s: "
        f"result.yaml {result}, hyp.rttm {len(rttm)} lines (first {rttm[:1]}), launches "
        f"{launches}")


def speaker_phase(wrapper, gen, dev, smi):
    """Phase 9: SUPERB's speaker tasks on the card over SUpstream's
    HuBERT-Large int8: ASV, GE2E and SD training on their fixed batches,
    one update of each against the CPU, their timing and profile, then the
    SuperbASV, segment-eval and SuperbSD recipes, in a temporary
    directory."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch.nn import SUpstream

    up = SUpstream(MODELS["hubert"], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                 "quantize": True, "seed": 0}).upstream
    with tempfile.TemporaryDirectory() as tmp:
        for name in SPEAKER:
            batch = speaker_batch(name, gen, dev)
            trainer = check_speaker_training(name, up, wrapper, batch, Path(tmp) / name)
            check_speaker_step_on_cpu(name, up, trainer, batch)
            time_speaker_step(name, up, trainer, batch, smi)
            del trainer, batch
        del up
        check_speaker_recipes(wrapper, Path(tmp), gen)



# the recipes phase: SUPERB's frame probes, QbE, HEAR and MOS over
# SUpstream's HuBERT-Large int8. Each head comes from its recipe's default
# config (build_task): TimitPhoneConvBank (ConvBank(3, 5, 7) over 41
# phones, AdamW 2e-4), QbeEmbeddingQuesst14 (bottleneck 256, two LSTMs of
# 1,024, AdamW 1e-5), HearFSD (FSD50k's 200 labels, multilabel,
# UtteranceLevel(1024), Adam 1e-3), HearDcase2016Task2 (11 classes,
# FrameLevel(256), Adam 1e-3) and MosPrediction (projector 256, 5,000
# judges, Adam 1e-4, accumulation 2)
REC_ITERS, REC_COS, REC_STEPS = 6, 0.9999, 6
# family -> (recipe, batch rows (QbE: pairs), seconds (a range), optimizer,
# accumulation, launches a step, rows (pairs) of the CPU update)
RECIPE = {
    "timit": ("TimitPhoneConvBank", 32, (10.0, 10.0), {"name": "AdamW", "lr": 2e-4}, 1,
              PROBE_RUN, 4),
    "qbe": ("QbeEmbeddingQuesst14", 16, (2.0, 10.0), {"name": "AdamW", "lr": 1e-5}, 1,
            PROBE_RUN, 2),
    "hear scene": ("HearFSD", 32, (5.0, 5.0), {"name": "Adam", "lr": 1e-3}, 1, PROBE_RUN, 4),
    "hear event": ("HearDcase2016Task2", 8, (30.0, 30.0), {"name": "Adam", "lr": 1e-3}, 1,
                   SD_RUN, 2),
    "mos": ("MosPrediction", 8, (2.0, 6.0), {"name": "Adam", "lr": 1e-4}, 2, PROBE_RUN, 4),
}
TIMIT_PHONES, FSD_LABELS, DCASE_CLASSES, MOS_JUDGES = 41, 200, 11, 5000
# parameters whose gradient is zero but for rounding: the attention
# poolings' score biases (each adds one value to every logit of a softmax)
REC_SHIFTS = ("attention_linear.bias", "_net_pooling.bias")


def recipe_task(name, up):
    """Family `name`'s task over `up`, built by its recipe from the
    recipe's default config."""
    import types

    import s3prl_tpu_torch.problem as problems
    from s3prl_tpu_torch.data import CategoryEncoder

    recipe = getattr(problems, RECIPE[name][0])()
    config = recipe.default_config()
    sup = types.SimpleNamespace(num_layers=up.num_layers, hidden_sizes=up.hidden_sizes)
    if name == "timit":
        return recipe.build_task(sup, None, config)
    if name == "hear scene":
        labels = [f"label{i:03d}" for i in range(FSD_LABELS)]
        return recipe.build_task(sup, CategoryEncoder(labels), config)
    if name == "hear event":
        return recipe.build_task(sup, {**config, "num_classes": DCASE_CLASSES})
    return recipe.build_task(sup, config)


def recipe_batch(name, gen, dev, seed=0):
    """The family's fixed batch: waves of lengths drawn from its range
    (QbE: the pairs' queries then their documents), its labels as the
    recipe's collation gives them (phone labels at 100 fps, event labels
    on 10-ms frames)."""
    _, B, secs = RECIPE[name][:3]
    rng = np.random.RandomState(seed)
    rows = 2 * B if name == "qbe" else B
    lens = rng.randint(int(secs[0] * SR), int(secs[1] * SR) + 1, rows)
    n = int(lens.max())
    x = torch.randn(rows, n, generator=gen) * (torch.arange(n)[None] <
                                               torch.from_numpy(lens)[:, None])
    batch = {"x": x.to(dev), "x_len": torch.from_numpy(lens).to(dev)}
    if name == "timit":
        batch["frame_labels"] = rng.randint(0, TIMIT_PHONES, (B, n // 160)).astype(np.int32)
    elif name == "qbe":
        batch["pair_label"] = np.tile(np.where(np.arange(B) % 2 == 0, 1, -1), 2).astype(np.int32)
    elif name == "hear scene":
        hot = np.zeros((B, FSD_LABELS), np.float32)
        for b in range(B):
            hot[b, rng.choice(FSD_LABELS, rng.randint(1, 4), replace=False)] = 1.0
        batch["multilabel"] = hot
    elif name == "hear event":
        labels = np.zeros((B, n // 160, DCASE_CLASSES), np.int32)
        for b in range(B):
            for _ in range(6):
                s = rng.randint(0, n // 160 - 300)
                labels[b, s:s + rng.randint(20, 300), rng.randint(DCASE_CLASSES)] = 1
        batch["frame_labels"] = labels
    else:
        batch.update(mean=rng.uniform(1, 5, B).astype(np.float32),
                     mos=rng.uniform(1, 5, B).astype(np.float32),
                     judge_id=rng.randint(0, MOS_JUDGES, B).astype(np.int32))
    return batch


def check_recipe_training(name, up, wrapper, batch, exp_dir):
    """REC_STEPS micro-steps of the family's task on its fixed batch through
    the Trainer: each step's launches (its run, every other count 0, the
    counts set to 0 just before the step and read just after it), the
    upstream in eval() and the probe in train(), the loss finite and lower
    after the updates than at the first step."""
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    recipe, _, secs, optimizer, accumulate, run, _ = RECIPE[name]
    trainer = Trainer(up, recipe_task(name, up), exp_dir, TrainerConfig(
        total_steps=1000, tensorboard=False, gradient_accumulate=accumulate,
        optimizer=optimizer))
    trainer.init(resume=False)
    losses = []
    for _ in range(REC_STEPS):
        for w in wrapper.values():
            w.launches = 0
        loss, _, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == {k: run.get(k, 0) for k in wrapper}, f"{name} step launches {launches}")
        check(not up.model.training and trainer.task.module.training,
              "the upstream left eval() or the probe left train()")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"{name} loss {losses}")
    head = getattr(trainer.task.module, "downstream", trainer.task.module)
    log(f"[recipes] {name} ({recipe}'s head) hubert int8 {batch['x'].shape[0]} rows x "
        f"{secs[0]:.0f}-{secs[1]:.0f} s (padded to {(batch['x'].shape[1] - 1) // 320 + 1} "
        f"frames), {type(head).__name__} -> {type(trainer.task).__name__}, {optimizer['name']} "
        f"{optimizer['lr']}, accumulation {accumulate}: launches a step {run} (every other "
        f"count 0), upstream in eval(); losses over {REC_STEPS} micro-steps "
        + " ".join(f"{v:.5f}" for v in losses))
    check(np.mean(losses[-accumulate:]) < np.mean(losses[:accumulate]),
          f"{name}: the loss did not fall: {losses}")
    return trainer


def recipe_rows(name, batch):
    """The first rows of the batch for the CPU update (QbE: the first
    pairs' queries and documents)."""
    n, B = RECIPE[name][6], RECIPE[name][1]
    if name != "qbe":
        return sub_batch(batch, n)
    idx = list(range(n)) + list(range(B, B + n))
    return {k: v[idx] for k, v in batch.items()}


def check_recipe_step_on_cpu(name, up, trainer, batch):
    """One update of the probe from the card's states of a few rows, on
    the card and on the CPU from the same weights and optimizer state
    (dropout off on both): loss and gradient norm at rtol 1e-3, each
    parameter's update at cosine > REC_COS (bias_ih held at zero;
    REC_SHIFTS within 2 lr of each other)."""
    import copy

    from s3prl_tpu_torch.train import Optimizer
    from s3prl_tpu_torch.train.optimizers import global_norm

    sub = recipe_rows(name, batch)
    hs, h_lens = up(sub["x"], sub["x_len"])
    task_cpu = recipe_task(name, up)
    task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                     trainer.task.module.state_dict().items()})
    heads = [t.module.downstream for t in (trainer.task, task_cpu)] if name == "timit" else []
    for h in heads:
        h.p = 0.0
    state = trainer.optimizer.state_dict()
    check(state["mini_step"] == 0, f"{name}: mid-accumulation")
    optimizer = RECIPE[name][3]

    def update(task, hs, h_lens):
        opt = Optimizer(task.module.parameters(), total_steps=1000, gradient_clipping=1.0,
                        **optimizer)
        opt.load_state_dict(copy.deepcopy(state))
        loss, _ = task.loss_and_cache(hs, h_lens, sub, None, True)
        loss.backward()
        norm = global_norm([p.grad for p in opt.params])
        check(opt.step(), f"{name}: the update was skipped")
        return float(loss.detach()), float(norm)

    before = {k: v.detach().cpu().clone() for k, v in trainer.task.module.state_dict().items()}
    card = update(trainer.task, hs, h_lens)
    t0 = time.perf_counter()
    cpu = update(task_cpu, hs.cpu(), h_lens.cpu())
    seconds = time.perf_counter() - t0
    for h in heads:
        h.p = 0.5  # the recipe's dropout
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss, shifts = {}, {}
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        if k.endswith(REC_SHIFTS):
            shifts[k] = float((a - b).abs().max())
        elif a.norm() > 0 or b.norm() > 0:  # bias_ih: held at zero
            coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = (abs(card[0] / cpu[0] - 1), abs(card[1] / cpu[1] - 1))
    lr = optimizer["lr"]
    log(f"[recipes] {name}: one update from the card's states [{', '.join(map(str, hs.shape))}] "
        f"{hs.dtype}, card vs CPU ({seconds:.1f} s on the CPU): loss {card[0]:.6f} / "
        f"{cpu[0]:.6f}, grad norm {card[1]:.6f} / {cpu[1]:.6f} (rel {rel[0]:.2e}, {rel[1]:.2e})"
        + (f", score biases' updates apart by {shifts} (lr {lr})" if shifts else "")
        + f", update cosines min {min(coss.values()):.6f}: "
        + " ".join(f"{k.replace('downstream.', '')} {c:.6f}" for k, c in coss.items()))
    check(max(rel) < 1e-3 and min(coss.values()) > REC_COS
          and all(d <= 2 * lr for d in shifts.values()), f"{name} step card vs CPU")


def time_recipe_step(name, up, trainer, batch, smi):
    """The family's train (micro-)step and the frozen forward alone (chains
    of REC_ITERS // 3 and REC_ITERS, marginal, one pair, CUDA events), each
    with its audio-s/s, its peak device memory and the profiler's device
    idle share over one call."""
    lo, hi = REC_ITERS // 3, REC_ITERS
    fns = {"train step": lambda: trainer.train_step(batch),
           "frozen forward alone": lambda: up(batch["x"], batch["x_len"])}
    chain = {(what, n): n * cuda_ms(fn, n) for what, fn in fns.items() for n in (lo, hi)}
    audio = float(batch["x_len"].sum()) / SR
    out = {}
    for what, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        out[what] = ((chain[what, hi] - chain[what, lo]) / (hi - lo),
                     torch.cuda.max_memory_allocated() / 2**30, profile_calls(fn, iters=1)[0])
    (step, peak, idle), (fwd, peak_fwd, idle_fwd) = out["train step"], out["frozen forward alone"]
    log(f"[timing] {name} hubert int8 {batch['x'].shape[0]} rows ({audio:.1f} s of audio, padded "
        f"to {batch['x'].shape[1] / SR:.2f} s): train step {step:.2f} ms ("
        f"{audio / (step / 1e3):.1f} audio-s/s, peak {peak:.2f} GiB, idle {idle_text(idle)}), "
        f"frozen forward alone {fwd:.2f} ms (peak {peak_fwd:.2f} GiB, idle "
        f"{idle_text(idle_fwd)}), beyond it "
        f"{step - fwd:.2f} ms; {smi}")


def qbe_corpus(root, gen):
    """8 queries of 0.25-2 s (the first 0.25 s) and 32 documents of 2-30 s
    (the first 30 s) from seed 0: WAV files and the recipe's CSVs."""
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    rng = np.random.RandomState(0)
    secs = {"queries": np.concatenate([[0.25], rng.uniform(0.25, 2.0, 7)]),
            "docs": np.concatenate([[30.0], rng.uniform(2.0, 30.0, 31)])}
    (root / "wavs").mkdir(parents=True)
    for split, values in secs.items():
        rows = ["id,wav_path"]
        for i, s in enumerate(values):
            path = root / "wavs" / f"{split}_{i}.wav"
            _write_wav(path, (torch.randn(int(s * SR), generator=gen) * 0.1).numpy())
            rows.append(f"{split}_{i},{path}")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")
    return secs


def check_qbe_dtw(sup, wrapper, hub, gen, exp_dir, smi):
    """QbeDTW's extraction (`_extract`: one utterance at a time, B = 1, the
    last layer's states kept on the card) of 8 queries and 32 documents,
    twice (cold, then warm), with its launches (K1 up to 512 frames, K6
    beyond); the card's DTW scores against the CPU's DTW on the same
    features at rtol 1e-5 with the same ranking for each query; the
    extraction and DTW times apart; then the 12-frame query's and the 30-s
    document's states against the CPU's plain versions (per-layer cosine >
    COS_LAYER)."""
    import s3prl_tpu_torch.models.transformer as port_transformer
    from s3prl_tpu_torch.data.dataset import _CsvDataset
    from s3prl_tpu_torch.kernels import flash_attention as fa
    from s3prl_tpu_torch.ops.dtw import qbe_scores
    from s3prl_tpu_torch.problem import QbeDTW
    from s3prl_tpu_torch.problem.qbe import pad_features

    secs = qbe_corpus(exp_dir, gen)
    want = expect(*((1, PROBE_RUN if (int(s * SR) - 400) // 320 + 1 <= fa.MAX_BLOCK_T
                     else SD_RUN) for values in secs.values() for s in values))
    extract_s = []
    for _ in range(2):  # the first pass cold (the forward's first lengths), the second warm
        for w in wrapper.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = {split: QbeDTW()._extract(sup, exp_dir / f"{split}.csv", -1, 30.0)[0]
                 for split in secs}
        torch.cuda.synchronize()
        extract_s.append(time.perf_counter() - t0)
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == {k: want.get(k, 0) for k in wrapper},
              f"QbE extraction launches {launches}")
    check(all(f.is_cuda and f.dtype == torch.float32 for fs in feats.values() for f in fs),
          "QbE features left the card")
    q, ql = pad_features(feats["queries"])
    d, dl = pad_features(feats["docs"])
    qbe_scores(q, ql, d, dl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = qbe_scores(q, ql, d, dl)
    torch.cuda.synchronize()
    dtw_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores_cpu = qbe_scores(q.cpu(), ql.cpu(), d.cpu(), dl.cpu())
    dtw_cpu_s = time.perf_counter() - t0
    check(scores.is_cuda and bool(torch.isfinite(scores).all()), "QbE scores")
    err = float(((scores.cpu() - scores_cpu).abs() / scores_cpu.abs()).max())
    same_rank = torch.equal(scores.cpu().argsort(dim=1), scores_cpu.argsort(dim=1))
    audio = float(secs["queries"].sum() + secs["docs"].sum())
    log(f"[qbe] {len(ql)} queries ({ql.tolist()} frames) and {len(dl)} documents (up to "
        f"{int(dl.max())} frames), {audio:.1f} s of audio, extracted at B = 1 (files read, "
        f"each forward, the layer kept) in {extract_s[0]:.2f} s cold, {extract_s[1]:.2f} s warm "
        f"({audio / extract_s[1]:.1f} audio-s/s), launches a pass {launches}; DTW of "
        f"{scores.shape[0]} x {scores.shape[1]} pairs on the card {dtw_s * 1e3:.1f} ms, on the "
        f"CPU {dtw_cpu_s:.2f} s, scores apart by rel {err:.2e}, the same ranking a query: "
        f"{same_rank}; {smi}")
    check(err <= 1e-5 and same_rank, "QbE DTW card vs CPU")
    t0 = time.perf_counter()
    up_cpu = load(hub, "hubert", "int8", "cpu")
    available = port_transformer._fused_block_available
    port_transformer._fused_block_available = lambda x: True
    try:
        for split in secs:
            ds = _CsvDataset(exp_dir / f"{split}.csv")
            x = torch.from_numpy(ds._load_wav(ds.df.iloc[0])[None])
            n = torch.tensor([x.shape[1]])
            hs_cpu, hl = up_cpu.apply_standardized(x, n)
            hs_gpu, _ = sup.upstream.apply_standardized(x.cuda(), n.cuda())
            coss = layer_cosines(hs_gpu.cpu(), hs_cpu, hl.tolist())
            log(f"[qbe] {split}[0] ({x.shape[1] / SR:.2f} s, {int(hl[0])} frames) card vs CPU "
                f"per-layer cosine min {min(coss):.6f}")
            check(min(coss) > COS_LAYER, f"QbE {split}[0] states card vs CPU")
    finally:
        port_transformer._fused_block_available = available
    del up_cpu
    log(f"[qbe] the CPU model and its two forwards: {time.perf_counter() - t0:.1f} s")


def hear_kfold_tree(root, gen):
    """A HEAR k-fold task directory: 16000/foldNN/ holding two clips of 1-3
    s a fold, foldNN.json mapping each clip to one of three labels."""
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    rng = np.random.RandomState(5)
    for fold in range(5):
        clips = {}
        for i in range(2):
            path = root / "16000" / f"fold{fold:02d}" / f"f{fold}_{i}.wav"
            path.parent.mkdir(parents=True, exist_ok=True)
            _write_wav(path, (torch.randn(int(rng.uniform(1.0, 3.0) * SR), generator=gen)
                              * 0.1).numpy())
            clips[path.name] = ["dog", "rain", "bird"][(fold + i) % 3]
        (root / f"fold{fold:02d}.json").write_text(json.dumps(clips))
    return root


# recipe -> (forwards of its run: train steps, valid and test batches; the
# keys of its result.yaml, None for QbeExample's scores.csv)
RECIPE_RUNS = {
    "FrameProbeExample": (4 + 2 + 1, {"accuracy", "loss"}),
    "QbeExample": (3, None),
    "QbeEmbeddingExample": (4 + 2, {"loss", "pair_auc"}),
    "HearEventExample": (4 + 2 + 1, {"loss", "event_f1"}),
    "MosExample": (4 + 4 + 2, {"loss", "utt_MSE", "utt_LCC", "utt_SRCC", "sys_MSE", "sys_LCC",
                               "sys_SRCC"}),
    "HearESC50": (4 + 2 + 1, {"loss", "top1_acc", "mAP", "d_prime", "aucroc", "accuracy"}),
}


def check_new_recipes(wrapper, exp_dir, gen):
    """The five Example recipes and HearESC50 (k-fold, on a tiny task
    directory, test fold 0, batch 2) through Problem.run with
    hubert_large_ll60k int8 (total_steps 4): each run's launches (K3 once,
    K1 and K2 24 times a forward; every other count 0), result.yaml's keys
    and finite values (QbeExample: scores.csv)."""
    import yaml

    import s3prl_tpu_torch.problem as problems

    upstream = {"name": "hubert_large_ll60k", "extra_conf": {
        "dtype": "bf16", "flash": True, "quantize": True, "seed": 0}}
    task_dir = hear_kfold_tree(exp_dir / "hear_task", gen)
    for name, (forwards, keys) in RECIPE_RUNS.items():
        t0 = time.perf_counter()
        problem = getattr(problems, name)()
        config = problem.default_config()
        config.pop("target_dir")
        config["build_upstream"] = upstream
        if "train" in config:
            config["train"] = {**config["train"], "tensorboard": False}
        if name == "HearESC50":
            config.update(prepare_data={"task_dir": str(task_dir), "test_fold": 0},
                          build_batch_sampler={"batch_size": 2})
            config["train"].update(total_steps=4, log_step=2, eval_step=2, save_step=2)
        launches = speaker_recipe(problem, exp_dir / name, config, wrapper)
        want = expect((forwards, PROBE_RUN))
        check(launches == {k: want.get(k, 0) for k in wrapper}, f"{name} launches {launches}")
        if keys is None:
            rows = (exp_dir / name / "scores.csv").read_text().splitlines()
            result = {r.split(",")[1]: float(r.split(",")[2]) for r in rows[1:]}
            check(len(result) == 2 and all(np.isfinite(v) for v in result.values()),
                  f"{name} scores {rows}")
        else:
            result = yaml.safe_load((exp_dir / name / "result.yaml").read_text())["test"]
            check(set(result) == keys and all(np.isfinite(v) for v in result.values()),
                  f"{name} result.yaml {result}")
        log(f"[recipe] {name} with hubert_large_ll60k int8 in {time.perf_counter() - t0:.1f} s: "
            f"{result}, launches {forwards} forwards x {PROBE_RUN}")


def recipes_phase(wrapper, gen, dev, smi):
    """Phase 10: SUPERB's frame probes, QbE, HEAR and MOS on the card over
    SUpstream's HuBERT-Large int8: QbE's extraction and DTW against the
    CPU, one fixed-batch train step of each head (launches, one update
    against the CPU, timing, peak memory, idle share), then the Example
    recipes and a HEAR k-fold recipe through Problem.run, in a temporary
    directory."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.nn import SUpstream

    sup = SUpstream(MODELS["hubert"], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                  "quantize": True, "seed": 0})
    with tempfile.TemporaryDirectory() as tmp:
        check_qbe_dtw(sup, wrapper, hub, gen, Path(tmp) / "qbe", smi)
        for name in RECIPE:
            batch = recipe_batch(name, gen, dev)
            trainer = check_recipe_training(name, sup.upstream, wrapper, batch, Path(tmp) / name)
            check_recipe_step_on_cpu(name, sup.upstream, trainer, batch)
            time_recipe_step(name, sup.upstream, trainer, batch, smi)
            del trainer, batch
        del sup
        check_new_recipes(wrapper, Path(tmp), gen)


# the SUPERB-SG phase: the baseline front ends, SE, SS and ST over
# SUpstream's HuBERT-Large int8. Each head comes from its recipe's default
# config (build_task): SuperbSS's SepRNN (3 x BLSTM 256, two sigmoid masks
# of 257 bins, PIT, AdamW 1e-3), SuperbSE's (one mask) and SuperbST's
# FrameLevelLinear(256) encoder with the decoder 256 / 3 layers / 4 heads /
# FFN 1,024 over 8,000 tokens (label-smoothed CE, Adam 1e-3, linear
# schedule, accumulation 8)
SG_COS = 0.999
# family -> (recipe, batch rows, seconds (a range), padded seconds (the
# recipe's 1-s bucket), launches a step, rows of the CPU update)
SG = {
    "ss": ("SuperbSS", 8, (3.0, 15.0), 15, SD_RUN, 2),
    "se": ("SuperbSE", 8, (2.0, 6.0), 6, PROBE_RUN, 2),
    "st": ("SuperbST", 16, (2.0, 10.0), 10, PROBE_RUN, 4),
}
ST_VOCAB, ST_TOKENS_PER_SEC, ST_DECODE_ROWS = 8000, 4, 2


class _Vocab:
    """SuperbST's tokenizer's face for build_task and the task: 8,000 ids
    (pad 0, unk 1, eos 2), as the recipe's BPE at its default vocab_size."""

    vocab_size, pad_idx, eos_idx = ST_VOCAB, 0, 2

    def decode(self, ids):
        return " ".join(f"w{i}" for i in ids if i > 2)


def sg_task(name, up):
    """Family `name`'s task over `up`, built by its recipe from the
    recipe's default config."""
    import types

    import s3prl_tpu_torch.problem as problems

    recipe = getattr(problems, SG[name][0])()
    config = recipe.default_config()
    sup = types.SimpleNamespace(num_layers=up.num_layers, hidden_sizes=up.hidden_sizes)
    if name == "st":
        return recipe.build_task(sup, _Vocab(), config), config
    return recipe.build_task(sup, config), config


def sg_batch(name, gen, dev, seed=0):
    """The family's fixed batch, padded to its 1-s bucket: mixtures of two
    (SS) or one (SE) seeded sources plus noise, with the sources [B, S, T];
    ST's waves with targets of ST_TOKENS_PER_SEC random tokens a second."""
    _, B, secs, padded = SG[name][:4]
    rng = np.random.RandomState(seed)
    lens = rng.randint(int(secs[0] * SR), int(secs[1] * SR) + 1, B)
    lens[0] = int(secs[1] * SR)
    n = padded * SR
    valid = (torch.arange(n)[None] < torch.from_numpy(lens)[:, None]).float()
    batch = {"x_len": torch.from_numpy(lens).to(dev)}
    if name == "st":
        batch["x"] = (torch.randn(B, n, generator=gen) * 0.1 * valid).to(dev)
        counts = np.maximum(lens * ST_TOKENS_PER_SEC // SR, 1)
        ids = np.zeros((B, int(counts.max())), np.int32)
        for b, c in enumerate(counts):
            ids[b, :c] = rng.randint(3, ST_VOCAB, c)
        batch.update(class_ids=ids, class_ids_len=counts.astype(np.int32))
        return batch
    S = 2 if name == "ss" else 1
    sources = torch.randn(B, S, n, generator=gen) * 0.1 * valid[:, None]
    batch["sources"] = sources.to(dev)
    batch["x"] = (sources.sum(1) + 0.03 * torch.randn(B, n, generator=gen) * valid).to(dev)
    return batch


def sg_dropout(task, p):
    """Sets the head's dropout (SepRNN's; the decoder's) to p."""
    import dataclasses

    if isinstance(task.module, torch.nn.ModuleDict):
        dec = task.module["decoder"]
        dec.cfg = dataclasses.replace(dec.cfg, dropout=p)
    else:
        task.module.downstream.p = p


def check_sg_training(name, up, wrapper, batch, exp_dir):
    """Three updates of the family's task on its fixed batch through the
    Trainer (3 x its accumulation micro-steps), each step's launches (its
    run, every other count 0, counted from 0 just before the step), the
    upstream in eval() and the head in train(), the loss finite and lower
    after two updates (the mean of the last accumulation window) than
    before any (the first window's). total_steps 20: ST's linear schedule
    then warms up over one update (lr 0), so its second update takes the
    full lr."""
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    recipe, _, secs, padded, run, _ = SG[name]
    task, config = sg_task(name, up)
    accumulate = config["train"].get("gradient_accumulate", 1)
    trainer = Trainer(up, task, exp_dir, TrainerConfig(
        total_steps=20, tensorboard=False, gradient_accumulate=accumulate,
        optimizer=config["build_optimizer"]))
    trainer.init(resume=False)
    losses = []
    for _ in range(3 * accumulate):
        for w in wrapper.values():
            w.launches = 0
        loss, cache, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == {k: run.get(k, 0) for k in wrapper}, f"{name} step launches {launches}")
        check(not up.model.training and trainer.task.module.training,
              "the upstream left eval() or the head left train()")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"{name} loss {losses}")
    extra = ""
    if name == "ss":
        perms = cache["best_perm"].tolist()
        extra = f", the last step's best permutations {perms}"
    log(f"[sg] {name} ({recipe}'s head) hubert int8 {batch['x'].shape[0]} rows x "
        f"{secs[0]:.0f}-{secs[1]:.0f} s (padded to {padded} s, "
        f"{(batch['x'].shape[1] - 1) // 320 + 1} frames), {type(trainer.task).__name__}, "
        f"{config['build_optimizer']}, accumulation {accumulate}: launches a step {run} (every "
        f"other count 0), upstream in eval(); losses over {len(losses)} micro-steps "
        + " ".join(f"{v:.5f}" for v in losses) + extra)
    check(np.mean(losses[-accumulate:]) < np.mean(losses[:accumulate]),
          f"{name}: the loss did not fall: {losses}")
    return trainer


def check_sg_step_on_cpu(name, up, trainer, batch):
    """One update of the head from the card's states of a few rows, on the
    card and on the CPU from the same weights and optimizer state (dropout
    off on both): loss and gradient norm at rtol 1e-3, each parameter's
    update at cosine > SG_COS (bias_ih held at zero; the attention keys'
    biases, whose gradient is zero but for rounding, within 2 lr), SS's
    best permutation a row the same."""
    import copy

    from s3prl_tpu_torch.train import Optimizer
    from s3prl_tpu_torch.train.optimizers import global_norm

    sub = sub_batch(batch, SG[name][5])
    hs, h_lens = up(sub["x"], sub["x_len"])
    task_cpu, config = sg_task(name, up)
    task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                     trainer.task.module.state_dict().items()})
    for t in (trainer.task, task_cpu):
        sg_dropout(t, 0.0)
    state = trainer.optimizer.state_dict()
    check(state["mini_step"] == 0, f"{name}: mid-accumulation")
    optimizer = config["build_optimizer"]

    def update(task, hs, h_lens, rows):
        opt = Optimizer(task.module.parameters(), total_steps=1000, gradient_clipping=1.0,
                        **optimizer)
        opt.load_state_dict(copy.deepcopy(state))
        loss, cache = task.loss_and_cache(hs, h_lens, rows, None, True)
        loss.backward()
        norm = global_norm([p.grad for p in opt.params])
        check(opt.step(), f"{name}: the update was skipped")
        return float(loss.detach()), float(norm), cache

    before = {k: v.detach().cpu().clone() for k, v in trainer.task.module.state_dict().items()}
    card = update(trainer.task, hs, h_lens, sub)
    t0 = time.perf_counter()
    cpu = update(task_cpu, hs.cpu(), h_lens.cpu(),
                 {k: v.cpu() if torch.is_tensor(v) else v for k, v in sub.items()})
    seconds = time.perf_counter() - t0
    default = 0.1  # the recipes' dropout (SepRNN's and the decoder's)
    for t in (trainer.task, task_cpu):
        sg_dropout(t, default)
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss, shifts = {}, {}
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        if k.endswith(".k.bias"):
            shifts[k] = float((a - b).abs().max())
        elif a.norm() > 0 or b.norm() > 0:  # bias_ih: held at zero
            coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = (abs(card[0] / cpu[0] - 1), abs(card[1] / cpu[1] - 1))
    lr = optimizer["lr"]
    same_perm = True
    if name == "ss":
        same_perm = card[2]["best_perm"].tolist() == cpu[2]["best_perm"].tolist()
    worst = sorted(coss.items(), key=lambda kv: kv[1])[:4]
    log(f"[sg] {name}: one update from the card's states [{', '.join(map(str, hs.shape))}] "
        f"{hs.dtype}, card vs CPU ({seconds:.1f} s on the CPU): loss {card[0]:.6f} / "
        f"{cpu[0]:.6f}, grad norm {card[1]:.6f} / {cpu[1]:.6f} (rel {rel[0]:.2e}, {rel[1]:.2e})"
        + (f", key biases' updates apart by at most {max(shifts.values()):.2e} (lr {lr})"
           if shifts else "")
        + (f", best permutations card {card[2]['best_perm'].tolist()} CPU "
           f"{cpu[2]['best_perm'].tolist()}" if name == "ss" else "")
        + f", update cosines over {len(coss)} tensors min {min(coss.values()):.6f}: "
        + " ".join(f"{k} {c:.6f}" for k, c in worst))
    check(max(rel) < 1e-3 and min(coss.values()) > SG_COS and same_perm
          and all(d <= 2 * lr for d in shifts.values()), f"{name} step card vs CPU")


def check_sg_decode(up, batch, smi):
    """ST's greedy decoding to 128 tokens on the card (CUDA events, best of
    2; the profiler's device idle share of one more) and on the CPU for
    ST_DECODE_ROWS rows from the same states: the share of rows whose
    tokens match. The recipe's head at its seed-0 initialisation: the head
    trained above emits <eos> first, which would make the comparison
    trivial (the timed work is the same: 128 steps either way)."""
    hs, h_lens = up(batch["x"], batch["x_len"])
    task = sg_task("st", up)[0]
    task.init_params(torch.Generator().manual_seed(0))
    task.module.to(hs.device)
    best = float("inf")
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        tokens = task.greedy_decode(hs, h_lens)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    idle = profile_calls(lambda: task.greedy_decode(hs, h_lens), iters=1)[0]
    n = ST_DECODE_ROWS
    task.module.cpu()
    t0 = time.perf_counter()
    cpu = task.greedy_decode(hs[:, :n].cpu(), h_lens[:n].cpu())
    seconds = time.perf_counter() - t0
    match = float(np.mean([np.array_equal(a, b) for a, b in zip(tokens[:n], cpu)]))
    lengths = [int(np.argmax(r == 2)) if (r == 2).any() else len(r) for r in tokens]
    check(tokens.shape == (batch["x"].shape[0], task.max_decode_len), f"decode {tokens.shape}")
    log(f"[timing] st greedy_decode hubert int8 {tokens.shape[0]} rows x {task.max_decode_len} "
        f"steps (the decoder over the whole [B, {task.max_decode_len + 1}] buffer each step): "
        f"{best:.1f} ms ({best / task.max_decode_len:.3f} ms a step, idle "
        f"{idle_text(idle)}); {smi}; "
        f"tokens before <eos> a row {lengths}; rows matching the CPU's tokens {match:.2f} of "
        f"{n} ({seconds:.1f} s on the CPU)")


def check_sg_features(gen, dev, smi):
    """The six baseline entries on the card against the CPU at B=8 x 10 s
    (2-10 s utterances) under tests/test_audio_ops.py's quantile rule; the
    STFT -> iSTFT round trip of SS's mixtures on the card (atol 1e-4
    against the waves); the fbank entry at B=32 x 10 s, the STFT and the
    iSTFT timed (CUDA events)."""
    from s3prl_tpu_torch.models.baseline import BASELINE_CONFIGS
    from s3prl_tpu_torch.nn import SUpstream
    from s3prl_tpu_torch.ops import audio

    rng = np.random.RandomState(1)
    lens = torch.from_numpy(np.concatenate([[10 * SR], rng.randint(2 * SR, 10 * SR, 7)]))
    x = torch.randn(8, 10 * SR, generator=gen) * 0.1 * (torch.arange(10 * SR)[None] < lens[:, None])
    for name in BASELINE_CONFIGS:
        card, card_lens = SUpstream(name)(x.to(dev), lens.to(dev))
        cpu, cpu_lens = SUpstream(name, extra_conf={"device": "cpu"})(x, lens)
        err = (card.cpu() - cpu).abs().numpy()
        want = cpu.numpy()
        strong = want > np.median(want)
        stats = (float(np.median(err)), float(np.percentile(err, 99)), float(err[strong].max()))
        log(f"[sg] {name} on the card vs the CPU, B=8 x 2-10 s {tuple(card.shape)}: |err| "
            f"median {stats[0]:.2e}, p99 {stats[1]:.2e}, max above the median {stats[2]:.2e}")
        check(torch.equal(card_lens.cpu(), cpu_lens) and card.dtype == torch.float32
              and stats[0] < 1e-3 and stats[1] < 1e-2 and stats[2] < 5e-3, f"{name} card vs CPU")
    mix = (torch.randn(8, 15 * SR, generator=gen) * 0.1).to(dev)
    spec = audio.stft_complex(mix)
    back = audio.istft(spec, length=mix.shape[1])
    err = float((back - mix).abs().max())
    log(f"[sg] STFT -> iSTFT on the card, B=8 x 15 s ({tuple(spec.shape)} complex): max |x' - x| "
        f"{err:.2e}")
    check(back.shape == mix.shape and err < 1e-4, "STFT round trip")
    x32 = (torch.randn(32, 10 * SR, generator=gen) * 0.1).to(dev)
    lens32 = torch.full((32,), 10 * SR, device=dev)
    fbank = SUpstream("fbank")
    spec16 = audio.stft_complex(torch.cat([mix, mix]))
    times = {"fbank entry B=32 x 10 s": cuda_ms(lambda: fbank(x32, lens32), 5),
             "stft_complex B=8 x 15 s": cuda_ms(lambda: audio.stft_complex(mix), 10),
             "istft B=16 x 15 s (SS's two sources)": cuda_ms(
                 lambda: audio.istft(spec16, length=15 * SR), 10)}
    log("[timing] " + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()) + f"; {smi}")


# recipe -> (upstream, forwards of its run: train steps, valid and test
# batches, and the keys of its result.yaml)
SG_RUNS = {
    "SeExample": ({"name": "fbank"}, 0, {"loss", "si_sdr", "si_sdri", "stoi", "pesq"}),
    "StExample": ({"name": "hubert_large_ll60k", "extra_conf": {
        "dtype": "bf16", "flash": True, "quantize": True, "seed": 0}}, 4 + 2 + 1, {"bleu"}),
}


def check_sg_recipes(wrapper, exp_dir):
    """SeExample on its default upstream (fbank on the card: no kernel)
    and StExample over hubert_large_ll60k int8 through Problem.run (total
    steps 4): each run's launches, result.yaml's keys and finite values."""
    import yaml

    import s3prl_tpu_torch.problem as problems

    for name, (upstream, forwards, keys) in SG_RUNS.items():
        t0 = time.perf_counter()
        problem = getattr(problems, name)()
        config = problem.default_config()
        config.pop("target_dir")
        config["build_upstream"] = upstream
        config["train"] = {**config["train"], "tensorboard": False}
        launches = speaker_recipe(problem, exp_dir / name, config, wrapper)
        want = expect((forwards, PROBE_RUN))
        check(launches == {k: want.get(k, 0) for k in wrapper}, f"{name} launches {launches}")
        result = yaml.safe_load((exp_dir / name / "result.yaml").read_text())["test"]
        check(set(result) == keys and all(np.isfinite(v) for v in result.values()),
              f"{name} result.yaml {result}")
        log(f"[recipe] {name} with {upstream['name']} in {time.perf_counter() - t0:.1f} s: "
            f"{result}, launches {forwards} forwards x {PROBE_RUN if forwards else {}}")


def sg_phase(wrapper, gen, dev, smi):
    """Phase 11: the baseline front ends and SUPERB-SG's SE, SS and ST on the
    card: the six entries against the CPU, the STFT round trip and their
    times; one fixed-batch train step of each head over SUpstream's
    HuBERT-Large int8 (launches, the loss falling, one update against the
    CPU, timing, peak memory, idle share) and ST's greedy decoding; then
    SeExample and StExample through Problem.run, in a temporary
    directory."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch.nn import SUpstream

    t0 = time.perf_counter()
    check_sg_features(gen, dev, smi)
    sup = SUpstream(MODELS["hubert"], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                  "quantize": True, "seed": 0})
    log(f"[sg] the features and the upstream's load: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        for name in SG:
            t0 = time.perf_counter()
            batch = sg_batch(name, gen, dev)
            trainer = check_sg_training(name, sup.upstream, wrapper, batch, Path(tmp) / name)
            check_sg_step_on_cpu(name, sup.upstream, trainer, batch)
            time_recipe_step(name, sup.upstream, trainer, batch, smi)
            if name == "st":
                check_sg_decode(sup.upstream, batch, smi)
            del trainer, batch
            log(f"[sg] {name}: {time.perf_counter() - t0:.1f} s")
        del sup
        check_sg_recipes(wrapper, Path(tmp))


# the SLU and mel-upstream phase: the nine models behind the ten new hub names
# (mos_wav2vec2 is mos_prediction's alias) at their published widths from
# seed 0, and SluATIS's / MoseiSentiment's heads from their recipes' default
# configs (the transformer head 512 / 2 layers / 8 heads / FFN 2,048 over 26
# ATIS intents; UtteranceLevel(256, MeanPooling) over 2 sentiment classes;
# AdamW 2e-4) over SUpstream's HuBERT-Large int8
MEL_MODELS = ("mockingjay", "tera", "audio_albert", "apc", "vq_apc", "npc", "mos_prediction",
              "mos_apc", "mos_tera")
MEL_ITERS = 3
# family -> (recipe, batch rows, seconds (a range), padded seconds, classes)
SLU = {"slu": ("SluATIS", 1, (2.0, 4.0), 4, 26), "mosei": ("MoseiSentiment", 3, (3.0, 10.0), 10, 2)}
SLU_ACCUMULATE, SLU_STEPS, SLU_COS = 2, 6, 0.999
# shifts: each adds one value to every score of a softmax row, so its
# gradient is zero but for rounding
SLU_SHIFTS = ("sap.attn.bias", "attention.self.key.bias")


def check_mel_models(gen, dev, smi):
    """The nine models on the card and on the CPU (the same seed's weights,
    drawn on the CPU; the CPU's a copy of the card's) on B=8 x 2-10 s: |err|
    of the hidden states over the valid frames (median, p99, max) and each
    layer's cosine there, the MOS scores' |err|; each model's forward on the
    card timed (CUDA events) with its audio-s/s."""
    from s3prl_tpu_torch import hub

    rng = np.random.RandomState(12)
    lens = torch.from_numpy(np.concatenate([[10 * SR], rng.randint(2 * SR, 10 * SR, 7)]))
    x = torch.randn(8, 10 * SR, generator=gen) * 0.1 * (torch.arange(10 * SR)[None] <
                                                        lens[:, None])
    xd, ld = x.to(dev), lens.to(dev)
    audio = float(lens.sum()) / SR
    for name in MEL_MODELS:
        t0 = time.perf_counter()
        card = hub.load(name, seed=0)
        cpu = on_cpu(card)
        loaded = time.perf_counter() - t0
        hs, h_lens = card.apply_standardized(xd, ld)
        t0 = time.perf_counter()
        ref, ref_lens = cpu.apply_standardized(x, lens)
        cpu_s = time.perf_counter() - t0
        hs = hs.float().cpu()
        check(tuple(hs.shape) == tuple(ref.shape) and torch.equal(h_lens.cpu(), ref_lens)
              and bool(torch.isfinite(hs).all()), f"{name} card vs CPU shapes")
        valid = torch.arange(hs.shape[2])[None] < ref_lens[:, None]
        err = (hs - ref).abs()[:, valid]
        if name.startswith("mos_"):
            scores, want = hs[0, :, 0, 0], ref[0, :, 0, 0]
            detail = (f"scores {' '.join(f'{v:.4f}' for v in scores.tolist())}, max |err| "
                      f"{float(err.max()):.2e}")
            ok = float(err.max()) < 1e-3
        else:
            a, b = hs[:, valid].double(), ref[:, valid].double()
            coss = [float((u * v).sum() / (u.norm() * v.norm())) for u, v in zip(a, b)]
            stats = (float(err.median()), float(np.percentile(err.numpy(), 99)),
                     float(err.max()))
            detail = (f"|err| median {stats[0]:.2e}, p99 {stats[1]:.2e}, max {stats[2]:.2e}, "
                      f"layer cosines min {min(coss):.6f}")
            ok = stats[0] < 1e-3 and stats[1] < 1e-2 and min(coss) > 0.999
        ms = cuda_ms(lambda: card.apply_standardized(xd, ld), MEL_ITERS)
        params = sum(p.numel() for p in card.model.parameters()) / 1e6
        log(f"[mel] {name} ({params:.1f}M parameters, {card.num_layers} x "
            f"{card.hidden_size}) B=8 x 2-10 s {tuple(hs.shape)} on the card vs the CPU: "
            f"{detail}; {ms:.2f} ms a forward ({audio / (ms / 1e3):.1f} audio-s/s); loads "
            f"{loaded:.1f} s, CPU forward {cpu_s:.1f} s; {smi}")
        check(ok, f"{name} card vs CPU")
        del card, cpu, hs, ref


def slu_task(name, up):
    """Family `name`'s task over `up`, built by its recipe from the recipe's
    default config (its encoder over the family's class count)."""
    import types

    import s3prl_tpu_torch.problem as problems
    from s3prl_tpu_torch.data import CategoryEncoder

    recipe = getattr(problems, SLU[name][0])()
    config = recipe.default_config()
    sup = types.SimpleNamespace(num_layers=up.num_layers, hidden_sizes=up.hidden_sizes)
    encoder = CategoryEncoder([f"class{i:02d}" for i in range(SLU[name][4])])
    return recipe.build_task(sup, encoder, config), config


def slu_batches(name, gen, dev):
    """The family's two fixed batches (seeds 0 and 1; the second for the
    update against the CPU): waves of lengths drawn from its range (the
    first row of the first batch the longest), padded to its bucket, with
    class ids."""
    _, B, secs, padded, classes = SLU[name]
    out = []
    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        lens = rng.randint(int(secs[0] * SR), int(secs[1] * SR) + 1, B)
        if seed == 0:
            lens[0] = int(secs[1] * SR)
        n = padded * SR
        valid = torch.arange(n)[None] < torch.from_numpy(lens)[:, None]
        out.append({"x": (torch.randn(B, n, generator=gen) * 0.1 * valid).to(dev),
                    "x_len": torch.from_numpy(lens).to(dev),
                    "class_id": rng.randint(0, classes, B).astype(np.int32)})
    return out


def slu_dropout(task, p):
    """Sets the SLU head's encoder dropout to p (MoseiSentiment's head has none)."""
    import dataclasses

    from s3prl_tpu_torch.models.mockingjay import MockingjayConfig

    for m in task.module.modules():
        if isinstance(getattr(m, "cfg", None), MockingjayConfig):
            m.cfg = dataclasses.replace(m.cfg, hidden_dropout_prob=p)


def check_slu_training(name, up, wrapper, batches, exp_dir):
    """SLU_STEPS micro-steps of the family's task on its first batch
    through the Trainer (accumulation SLU_ACCUMULATE): each step's launches
    (K3 once, K1 and K2 24 times; every other count 0; the counts set to 0
    just before the step and read just after), the upstream in eval() and
    the head in train(), the loss and gradient norm finite. The losses are
    logged, not gated: on the random trunk's states AdamW's first moves of
    2e-4 overshoot MoseiSentiment's mean-pooled head (0.665 -> 1.363 ->
    1.169 on one fixed batch, the same update on the CPU)."""
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    recipe, B, secs, padded, classes = SLU[name]
    task, config = slu_task(name, up)
    trainer = Trainer(up, task, exp_dir, TrainerConfig(
        total_steps=1000, tensorboard=False, gradient_accumulate=SLU_ACCUMULATE,
        optimizer=config["build_optimizer"]))
    trainer.init(resume=False)
    losses = []
    for _ in range(SLU_STEPS):
        for w in wrapper.values():
            w.launches = 0
        loss, _, grad_norm = trainer.train_step(batches[0])
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == {k: PROBE_RUN.get(k, 0) for k in wrapper},
              f"{name} step launches {launches}")
        check(not up.model.training and trainer.task.module.training,
              "the upstream left eval() or the head left train()")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"{name} loss {losses}")
    entries = launched_entries(lambda: up(batches[0]["x"], batches[0]["x_len"]))
    counted = {e: entries.count(e) for e in sorted(set(entries))}
    head = trainer.task.module.downstream
    log(f"[slu] {name} ({recipe}'s head {type(head).__name__}, {classes} classes) hubert int8 "
        f"B={B} x {secs[0]:.0f}-{secs[1]:.0f} s padded to {padded} s "
        f"({(padded * SR - 1) // 320 + 1} frames), {config['build_optimizer']}, accumulation "
        f"{SLU_ACCUMULATE} (the recipe's {config['train']['gradient_accumulate']}): launches a "
        f"micro-step {PROBE_RUN} (every other count 0), the C entries of one frozen forward "
        f"{counted}; losses over {SLU_STEPS} micro-steps " + " ".join(f"{v:.5f}" for v in losses))
    return trainer


def check_slu_update_on_cpu(name, up, trainer, batches):
    """One update (two micro-steps, accumulation 2) of the head from the
    card's states, on the card and on the CPU from the same weights and
    optimizer state (dropout off on both): each micro-step's loss and
    gradient norm at rtol 1e-3, each parameter's update at cosine >
    SLU_COS (SLU_SHIFTS within 2 lr)."""
    import copy

    from s3prl_tpu_torch.train import Optimizer
    from s3prl_tpu_torch.train.optimizers import global_norm

    states = [up(b["x"], b["x_len"]) for b in batches]
    task_cpu, config = slu_task(name, up)
    task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                     trainer.task.module.state_dict().items()})
    for t in (trainer.task, task_cpu):
        slu_dropout(t, 0.0)
    state = trainer.optimizer.state_dict()
    check(state["mini_step"] == 0, f"{name}: mid-accumulation")
    optimizer = config["build_optimizer"]

    def update(task, device):
        opt = Optimizer(task.module.parameters(), total_steps=1000, gradient_clipping=1.0,
                        gradient_accumulate=SLU_ACCUMULATE, **optimizer)
        opt.load_state_dict(copy.deepcopy(state))
        out = []
        for (hs, h_lens), batch in zip(states, batches):
            rows = {k: v.to(device) if torch.is_tensor(v) else v for k, v in batch.items()}
            loss, _ = task.loss_and_cache(hs.to(device), h_lens.to(device), rows, None, True)
            loss.backward()
            out += [float(loss.detach()), float(global_norm([p.grad for p in opt.params
                                                             if p.grad is not None]))]
            stepped = opt.step()
        check(stepped, f"{name}: the update was not applied")
        return out

    before = {k: v.detach().cpu().clone() for k, v in trainer.task.module.state_dict().items()}
    card = update(trainer.task, up.device)
    t0 = time.perf_counter()
    cpu = update(task_cpu, "cpu")
    seconds = time.perf_counter() - t0
    slu_dropout(trainer.task, 0.1)  # the recipe's
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss, shifts = {}, {}
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        if k.endswith(SLU_SHIFTS):
            shifts[k] = float((a - b).abs().max())
        elif a.norm() > 0 or b.norm() > 0:
            coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = max(abs(g / c - 1) for g, c in zip(card, cpu))
    lr = optimizer["lr"]
    worst = sorted(coss.items(), key=lambda kv: kv[1])[:4]
    log(f"[slu] {name}: one update (accumulation {SLU_ACCUMULATE}) from the card's states "
        f"{[tuple(h.shape) for h, _ in states]} {states[0][0].dtype}, card vs CPU "
        f"({seconds:.1f} s on the CPU): losses / grad norms card "
        + " ".join(f"{v:.6f}" for v in card) + " CPU " + " ".join(f"{v:.6f}" for v in cpu)
        + f" (rel {rel:.2e})"
        + (f", shifts apart by at most {max(shifts.values()):.2e} (lr {lr})" if shifts else "")
        + f", update cosines over {len(coss)} tensors min {min(coss.values()):.6f}: "
        + " ".join(f"{k.replace('downstream.', '')} {c:.6f}" for k, c in worst))
    check(rel < 1e-3 and min(coss.values()) > SLU_COS
          and all(d <= 2 * lr for d in shifts.values()), f"{name} update card vs CPU")


def check_slu_example(wrapper, exp_dir):
    """SluExample through Problem.run over hubert_large_ll60k int8 (4
    micro-steps, accumulation 2, valid every 2: 4 + 4 + 2 forwards): its
    launches and result.yaml's accuracy."""
    import yaml

    import s3prl_tpu_torch.problem as problems

    t0 = time.perf_counter()
    problem = problems.SluExample()
    config = problem.default_config()
    config.pop("target_dir")
    config["build_upstream"] = {"name": "hubert_large_ll60k", "extra_conf": {
        "dtype": "bf16", "flash": True, "quantize": True, "seed": 0}}
    config["train"] = {**config["train"], "tensorboard": False}
    forwards = 4 + 4 + 2
    launches = speaker_recipe(problem, exp_dir / "SluExample", config, wrapper)
    want = expect((forwards, PROBE_RUN))
    check(launches == {k: want.get(k, 0) for k in wrapper}, f"SluExample launches {launches}")
    result = yaml.safe_load((exp_dir / "SluExample" / "result.yaml").read_text())["test"]
    check(set(result) == {"accuracy", "loss"} and 0.0 <= result["accuracy"] <= 1.0
          and np.isfinite(result["loss"]), f"SluExample result.yaml {result}")
    log(f"[recipe] SluExample with hubert_large_ll60k int8 in {time.perf_counter() - t0:.1f} s: "
        f"{result}, launches {forwards} forwards x {PROBE_RUN}")


def slu_phase(wrapper, gen, dev, smi):
    """Phase 12: the mel-domain upstreams and the MOS predictors against the
    CPU with their rates; the SluATIS (B=1) and MoseiSentiment (B=3)
    micro-steps over SUpstream's HuBERT-Large int8 (launches, one update
    against the CPU, timing, peak memory, idle share); then SluExample
    through Problem.run, in a temporary directory."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch.nn import SUpstream

    t0 = time.perf_counter()
    check_mel_models(gen, dev, smi)
    log(f"[slu] the mel models: {time.perf_counter() - t0:.1f} s")
    sup = SUpstream(MODELS["hubert"], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                  "quantize": True, "seed": 0})
    with tempfile.TemporaryDirectory() as tmp:
        for name in SLU:
            t0 = time.perf_counter()
            batches = slu_batches(name, gen, dev)
            trainer = check_slu_training(name, sup.upstream, wrapper, batches, Path(tmp) / name)
            check_slu_update_on_cpu(name, sup.upstream, trainer, batches)
            time_recipe_step(name, sup.upstream, trainer, batches[0], smi)
            del trainer, batches
            log(f"[slu] {name}: {time.perf_counter() - t0:.1f} s")
        del sup
        check_slu_example(wrapper, Path(tmp))


# phase 13: the upstream in train mode (K7 / K9 inside a train step) and VC.
# model -> (quantize, the attention kernel its train-mode forward launches a layer)
TRAIN_MODE = {"hubert": (True, "fused_qkv_attention"), "wavlm": (False, "gated_bias_attention")}
TM_STEPS = 4  # train steps on one fixed batch
TM_CPU = ("B=2 x 2 s", [32000, 20000])  # the card-vs-CPU batch at rates 0
# VC: VcVcc2020's recipe at full width over fbank, batches of 6 utterances of 1-5 s
VC_SPEAKERS, VC_UTTS, VC_SECS, VC_STEPS = ("SEF1", "SEF2"), 10, (1.0, 5.0), 4
# Griffin-Lim card vs CPU: the zero-phase synthesis (no round: no phase taken
# from a spectrum) within GL_ATOL of the peak 0.95, and 32 rounds' spectral
# convergence within GL_SC_RTOL of the CPU's (their waves part: the phase of
# an inconsistent bin is rounding in either FFT library, and each round feeds
# it back; `ops.vocoder.spectral_convergence`)
GL_ATOL, GL_SC_RTOL = 1e-5, 1e-2


def dropout_rates(model):
    """{module path.field: rate} of every nonzero train-mode rate of `model`
    (the trunk's config fields and the layers' attributes)."""
    rates = {f"cfg.{k}": v for k, v in vars(model.cfg).items()
             if "dropout" in k and isinstance(v, float) and v}
    for name, m in model.named_modules():
        for field in ("dropout", "activation_dropout"):
            value = getattr(m, field, None)
            if isinstance(value, float) and value:
                rates[f"{name}.{field}"] = value
    return rates


def zero_dropouts(model):
    """Sets every train-mode rate of `model` to 0; returns the restorer."""
    import dataclasses

    cfg = model.cfg
    saved = []
    model.cfg = dataclasses.replace(cfg, **{k: 0.0 for k, v in vars(cfg).items()
                                            if "dropout" in k and isinstance(v, float)})
    for m in model.modules():
        for field in ("dropout", "activation_dropout"):
            if isinstance(getattr(m, field, None), float):
                saved.append((m, field, getattr(m, field)))
                setattr(m, field, 0.0)

    def restore():
        model.cfg = cfg
        for m, field, value in saved:
            setattr(m, field, value)

    return restore


def time_steps(label, fns, audio, smi, iters=6):
    """Each of `fns` by phase 7's protocol (chains of iters // 3 and iters,
    marginal, best of 3; CUDA events) with its audio-s/s and peak device
    memory, then under the profiler (the device's idle share): {what: ms}."""
    lo, hi = max(iters // 3, 1), iters
    best = {(what, n): float("inf") for what in fns for n in (lo, hi)}
    for _ in range(3):
        for what, fn in fns.items():
            for n in (lo, hi):
                best[what, n] = min(best[what, n], n * cuda_ms(fn, n))
    out = {}
    for what, fn in fns.items():
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[what] = (best[what, hi] - best[what, lo]) / (hi - lo)
        idle, kernels = profile_calls(fn)
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
        log(f"[timing] {label} {what}: {out[what]:.2f} ms/step, {audio / (out[what] / 1e3):.1f} "
            f"audio-s/s (chains {lo}: {best[what, lo]:.1f} ms, {hi}: {best[what, hi]:.1f} ms), "
            f"peak device memory {peak:.2f} GiB, device idle share {idle_text(idle)}; {smi}")
        log(f"[profile] {label} {what}: kernel time {sum(kernels.values()):.2f} ms a call; the "
            "largest (ms a call): " + "; ".join(f"{k[:70]} {ms:.3f}" for k, ms in top))
    return out


def check_train_mode_steps(model, up, wrapper, batch, exp_dir):
    """TM_STEPS steps of the Trainer with upstream_trainable on one batch
    at the config's rates: each step's launches (TRAIN_MODE's kernel once a
    layer, every other count 0: no block kernel, no K3; read just after
    the step with every count set to 0 just before it, so a refuse_grad
    error would have raised), the upstream in train(), no upstream
    parameter with a gradient, the loss finite."""
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    kernel = TRAIN_MODE[model][1]
    trainer = Trainer(up, probe_task(up), exp_dir, TrainerConfig(
        total_steps=1000, tensorboard=False, upstream_trainable=True,
        optimizer={"name": "Adam", "lr": PROBE_LR}))
    trainer.init(resume=False)
    losses = []
    for _ in range(TM_STEPS):
        for w in wrapper.values():
            w.launches = 0
        loss, _, grad_norm = trainer.train_step(batch)
        torch.cuda.synchronize()
        launches = {name: w.launches for name, w in wrapper.items()}
        check(launches == {name: 24 if name == kernel else 0 for name in wrapper},
              f"{model} train-mode step launches {launches}")
        check(up.model.training and trainer.task.module.training,
              "the upstream or the probe left train()")
        check(all(p.grad is None for p in up.model.parameters()),
              f"{model}: an upstream parameter has a gradient")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"loss {losses}")
    log(f"[train mode] {model} B={PROBE_B} x {PROBE_SECS:.0f} s, upstream_trainable, rates "
        f"{dropout_rates(up.model)}: launches a step {{{kernel!r}: 24}} (every other count 0), "
        f"the upstream in train(), no upstream gradient; losses over {TM_STEPS} steps "
        + " ".join(f"{v:.5f}" for v in losses))
    return trainer


def check_train_mode_on_cpu(model, up, trainer, wrapper, probe_batch, gen, dev):
    """At rates 0: the card's train-mode states against the same seed's
    model on the CPU in train mode (TM_CPU's batch; its launches), per-layer
    cosine > 0.999 over the valid frames; then one probe step from the
    card's train-mode states of `batch` on the card and on the CPU."""
    from s3prl_tpu_torch import hub

    quantize, kernel = TRAIN_MODE[model]
    cpu = hub.load(MODELS[model], dtype=torch.bfloat16, flash=True, quantize=quantize,
                   device="cpu", seed=0)
    restore = [zero_dropouts(up.model), zero_dropouts(cpu.model)]
    try:
        label, lens = TM_CPU
        x, lens_t = batch(lens, max(lens), gen, "cpu")
        hs_cpu, hl_cpu = cpu(x, lens_t, train=True)
        for w in wrapper.values():
            w.launches = 0
        hs_gpu, hl_gpu = up(x.to(dev), lens_t.to(dev), train=True)
        torch.cuda.synchronize()
        check(wrapper[kernel].launches == 24, f"{model} card train-mode forward launches")
        check(hl_cpu.tolist() == hl_gpu.tolist(), "h_lens CPU vs card")
        coss = layer_cosines(hs_gpu.float().cpu(), hs_cpu.float(), hl_cpu.tolist())
        log(f"[train mode] {model} rates 0, {label}, card vs CPU in train(): per-layer cosine "
            f"min {min(coss):.6f}: " + " ".join(f"{c:.5f}" for c in coss))
        check(min(coss) > COS_LAYER, f"{model} train-mode states card vs CPU")
        check_probe_step_on_cpu(up, trainer, probe_batch, train=True)
    finally:
        for fn in restore:
            fn()
    del cpu


def vc_tree(root, gen):
    """A VCC2020-shaped tree: <root>/<speaker>/E1000{i}.wav for the source
    speakers and TEF1, each 1-5 s of a tone under noise (the target a fifth
    above the source)."""
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    rng = np.random.RandomState(13)
    for i in range(VC_UTTS):
        n = int(SR * rng.uniform(*VC_SECS))
        t = np.arange(n) / SR
        f0 = rng.uniform(100, 250)
        for spk, f in [(s, f0) for s in VC_SPEAKERS] + [("TEF1", 1.5 * f0)]:
            (root / spk).mkdir(parents=True, exist_ok=True)
            wav = 0.3 * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(n)
            _write_wav(root / spk / f"E1000{i}.wav", wav.astype(np.float32))


def vc_config(tree):
    import s3prl_tpu_torch.problem as problems

    problem = problems.VcVcc2020()
    config = problem.default_config()
    config.pop("target_dir")
    config["prepare_data"] = {"vcc2020": str(tree), "target_speaker": "TEF1",
                              "source_speakers": list(VC_SPEAKERS)}
    config["train"] = {"total_steps": VC_STEPS, "log_step": 1, "eval_step": VC_STEPS,
                       "save_step": VC_STEPS, "tensorboard": False}
    return problem, config


def check_vc(wrapper, gen, dev, smi, root):
    """VcVcc2020 at full width over fbank on the card: Problem.run (train
    VC_STEPS steps on batches of 6, valid, the evaluate stage's MCD and
    Griffin-Lim waves, no kernel launched); then one train step timed; with
    the prenet's dropout off on both sides, one step from the same weights
    and AdamW state on the card and on the CPU (loss and gradient norm at
    rtol 1e-3, update cosines > 0.999); Griffin-Lim of the predicted mels
    on the card against the CPU (GL_ATOL)."""
    import copy

    import yaml

    import s3prl_tpu_torch.models.taco2ar as taco2ar
    from s3prl_tpu_torch.ops.vocoder import (griffin_lim, log_mel_to_wav, mel_magnitudes,
                                             spectral_convergence)
    from s3prl_tpu_torch.train import Optimizer
    from s3prl_tpu_torch.train.optimizers import global_norm
    from s3prl_tpu_torch.train.trainer import _split_batch

    vc_tree(root / "vcc2020", gen)
    problem, config = vc_config(root / "vcc2020")
    work = root / "vc"
    t0 = time.perf_counter()
    for w in wrapper.values():
        w.launches = 0
    problem.run(str(work), **config)
    check(all(w.launches == 0 for w in wrapper.values()), "VC over fbank launched a kernel")
    result = yaml.safe_load((work / "result.yaml").read_text())["test"]
    waves = sorted((work / "wav_hyp").glob("*.wav"))
    test_rows = len((work / "test.csv").read_text().splitlines()) - 1
    check(np.isfinite(result["l1"]) and np.isfinite(result["mcd"]) and len(waves) == test_rows,
          f"VcVcc2020 result.yaml {result}, waves {[p.name for p in waves]}")
    log(f"[vc] VcVcc2020 (Taco2-AR: prenet 256, 2 LSTM x 512, postnet 256 x 5 x 3) over fbank "
        f"through Problem.run, {VC_STEPS} steps of 6 + valid + evaluate, in "
        f"{time.perf_counter() - t0:.1f} s: result.yaml {result}, waves "
        f"{[p.name for p in waves]}")
    # a trainer whose schedule outlasts the timed steps
    trainer = problem._trainer(work, {**config, "train": {**config["train"], "total_steps": 1000}})
    trainer.init(resume=False)
    batch_ = next(iter(problem._loader(work, "train.csv", "train", config)))
    device = {k: torch.as_tensor(v).to(dev) if k in ("x", "x_len") else v
              for k, v in _split_batch(batch_)[0].items()}
    audio = float(np.sum(batch_["x_len"])) / SR
    fns = {"VC train step": lambda: trainer.train_step(device),
           "fbank forward alone": lambda: trainer.forward_upstream(device)}
    time_steps(f"VcVcc2020 B=6 ({audio:.1f} s of audio, padded to "
               f"{batch_['x'].shape[1] / SR:.2f} s)", fns, audio, smi)
    saved = taco2ar.PRENET_DROPOUT
    taco2ar.PRENET_DROPOUT = 0.0  # the two devices' generators differ
    try:
        hs, h_lens = trainer.forward_upstream(device)
        task_cpu = problem.build_task(problem.build_upstream(
            "fbank", extra_conf={"device": "cpu"}), config)
        task_cpu.module.load_state_dict({k: v.cpu() for k, v in
                                         trainer.task.module.state_dict().items()})
        cfg = trainer.cfg
        opt_cpu = Optimizer(task_cpu.module.parameters(), gradient_clipping=cfg.gradient_clipping,
                            gradient_accumulate=cfg.gradient_accumulate,
                            total_steps=cfg.total_steps, **cfg.optimizer)
        opt_cpu.load_state_dict(copy.deepcopy(trainer.optimizer.state_dict()))
        before = {k: v.detach().cpu().clone() for k, v in
                  trainer.task.module.state_dict().items()}
        loss_card, cache, norm_card = trainer.probe_step(hs, h_lens, device)
        loss_cpu, _ = task_cpu.loss_and_cache(hs.cpu(), h_lens.cpu(), device, None, True)
        loss_cpu.backward()
        loss_cpu = loss_cpu.detach()
        norm_cpu = global_norm([p.grad for p in opt_cpu.params])
        opt_cpu.step()
    finally:
        taco2ar.PRENET_DROPOUT = saved
    after_card, after_cpu = trainer.task.module.state_dict(), task_cpu.module.state_dict()
    coss = {}
    for k, p0 in before.items():
        a = (after_card[k].cpu() - p0).double().flatten()
        b = (after_cpu[k] - p0).double().flatten()
        if a.norm() > 0 or b.norm() > 0:  # bias_ih: held at zero
            coss[k] = float(a @ b / (a.norm() * b.norm()))
    rel = (abs(float(loss_card) / float(loss_cpu) - 1), abs(float(norm_card) / float(norm_cpu) - 1))
    log(f"[vc] one step from the card's fbank states, prenet dropout off, card vs CPU: loss "
        f"{float(loss_card):.6f} / {float(loss_cpu):.6f}, grad norm {float(norm_card):.6f} / "
        f"{float(norm_cpu):.6f} (rel {rel[0]:.2e}, {rel[1]:.2e}), update cosines min "
        f"{min(coss.values()):.6f}")
    check(max(rel) < 1e-3 and min(coss.values()) > PROBE_COS, "VC step card vs CPU")
    mels = cache["pred_mel"].detach()
    torch.cuda.synchronize()
    gl_ms = cuda_ms(lambda: log_mel_to_wav(mels, n_iter=32), 3)
    wav_card = log_mel_to_wav(mels, n_iter=0).cpu()
    err = float((wav_card - log_mel_to_wav(mels.cpu(), n_iter=0)).abs().max())
    mag = mel_magnitudes(mels)
    sc_card = float(spectral_convergence(griffin_lim(mag, n_iter=32), mag))
    sc_cpu = float(spectral_convergence(griffin_lim(mag.cpu(), n_iter=32), mag.cpu()))
    log(f"[vc] Griffin-Lim of the predicted mels [{', '.join(map(str, mels.shape))}]: 32 "
        f"iterations {gl_ms:.2f} ms on the card (cuFFT); card vs CPU: the zero-phase waves max "
        f"|err| {err:.2e} (peak 0.95), 32 rounds' spectral convergence {sc_card:.6f} / "
        f"{sc_cpu:.6f}")
    check(err < GL_ATOL and abs(sc_card / sc_cpu - 1) < GL_SC_RTOL
          and bool(torch.isfinite(wav_card).all()), "Griffin-Lim card vs CPU")


def train_mode_phase(wrapper, gen, dev, smi):
    """Phase 13: SUpstream's HuBERT-Large int8 and WavLM-Large bf16 with
    flash=True under the Trainer with upstream_trainable at their config's
    rates on B=32 x 10 s (launches, no upstream gradient), the card vs the
    CPU at rates 0 (states and one update), the train-mode step timed beside
    the frozen step; then VcVcc2020 at full width (`check_vc`)."""
    import tempfile
    from pathlib import Path

    from s3prl_tpu_torch.nn import SUpstream
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    n = int(PROBE_SECS * SR)
    labels = np.random.RandomState(0).randint(0, PROBE_CLASSES, PROBE_B).astype(np.int32)
    batch_ = {"x": torch.randn(PROBE_B, n, generator=gen).to(dev),
              "x_len": torch.full((PROBE_B,), n).to(dev), "class_id": labels}
    with tempfile.TemporaryDirectory() as tmp:
        for model, (quantize, _) in TRAIN_MODE.items():
            t0 = time.perf_counter()
            up = SUpstream(MODELS[model], extra_conf={"dtype": torch.bfloat16, "flash": True,
                                                      "quantize": quantize, "seed": 0}).upstream
            trainer = check_train_mode_steps(model, up, wrapper, batch_, Path(tmp) / model)
            check_train_mode_on_cpu(model, up, trainer, wrapper, batch_, gen, dev)
            frozen = Trainer(up, probe_task(up), Path(tmp) / f"{model}-frozen", TrainerConfig(
                total_steps=1000, tensorboard=False, optimizer={"name": "Adam", "lr": PROBE_LR}))
            frozen.init(resume=False)
            path = "int8" if quantize else "bf16"
            time_steps(f"{model} {path} flash B={PROBE_B} x {PROBE_SECS:.0f} s",
                       {"train-mode step": lambda: trainer.train_step(batch_),
                        "frozen step": lambda: frozen.train_step(batch_)},
                       PROBE_B * PROBE_SECS, smi)
            up.model.eval()
            del up, trainer, frozen
            log(f"[train mode] {model}: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        check_vc(wrapper, gen, dev, smi, Path(tmp))
        log(f"[vc] {time.perf_counter() - t0:.1f} s")


# the rest of the wav2vec2-style zoo: (entry, dtype, flash) -> the kernel
# launches of one forward (every other count 0). The Conformer's layers and
# the stock families' run no kernel; K3 serves every layer-norm extractor
ZOO = {("wav2vec2_conformer_relpos", "bf16", False): {"conv0_ln_gelu": 1},
       ("wav2vec2_conformer_relpos", "f32", False): {"conv0_ln_gelu": 1},
       ("wav2vec2_conformer_rope", "bf16", False): {"conv0_ln_gelu": 1},
       ("wav2vec2_conformer_rope", "f32", False): {"conv0_ln_gelu": 1},
       ("espnet_hubert_large_gs_ll60k", "bf16", True): {
           "conv0_ln_gelu": 1, "fused_attention_block_bf16": 24, "fused_bf16_ffn": 24},
       ("distilhubert", "f32", False): {},
       ("lighthubert_base", "f32", False): {"conv0_ln_gelu": 1},
       ("lighthubert_small", "f32", False): {"conv0_ln_gelu": 1},
       ("multires_hubert_base", "f32", False): {}}
ZOO_B, ZOO_SECS, ZOO_ITERS = 8, 10, 3


def zoo_phase(wrapper, gen, dev, smi):
    """Phase 14: each ZOO entry from seed 0 at its published width through
    hub.load on the card: one apply_standardized on B=8 x 2-10 s with its
    launches (the counts set to 0 just before, read just after), shape,
    lengths and finite values; the forward timed by CUDA events with its
    audio-s/s and the profiler's device idle share; then the same model
    moved to the CPU (the port's CPU path: the wrappers' plain versions, the
    stock ops) against the card on B=2 x 1.3-2 s, per-layer cosine > 0.999
    over the valid frames."""
    from s3prl_tpu_torch import hub

    rng = np.random.RandomState(14)
    n = ZOO_SECS * SR
    lens = torch.from_numpy(np.concatenate([[n], rng.randint(2 * SR, n, ZOO_B - 1)]))
    x = (torch.randn(ZOO_B, n, generator=gen) * (torch.arange(n)[None] < lens[:, None])).to(dev)
    lens_d = lens.to(dev)
    small_lens = torch.tensor([2 * SR, int(1.3 * SR)])
    x_small = torch.randn(2, 2 * SR, generator=gen) * (torch.arange(2 * SR)[None] <
                                                       small_lens[:, None])
    audio = float(lens.sum()) / SR
    for (name, dtype, flash), run in ZOO.items():
        t0 = time.perf_counter()
        card = hub.load(name, dtype={"bf16": torch.bfloat16, "f32": torch.float32}[dtype],
                        flash=flash, seed=0)
        loaded = time.perf_counter() - t0
        for w in wrapper.values():
            w.launches = 0
        hs, h_lens = card.apply_standardized(x, lens_d)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == {k: run.get(k, 0) for k in wrapper}, f"{name} {dtype} launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        T = (n - 1) // 320 + 1
        check(tuple(hs.shape) == (card.num_layers, ZOO_B, T, card.hidden_size)
              and torch.equal(h_lens.cpu(), (lens - 1) // 320 + 1)
              and bool(torch.isfinite(hs).all()), f"{name} {dtype} {tuple(hs.shape)}")
        del hs
        fn = lambda: card.apply_standardized(x, lens_d)  # noqa: E731
        ms = cuda_ms(fn, ZOO_ITERS)
        idle, _ = profile_calls(fn, iters=2)
        cpu = on_cpu(card)
        got, got_lens = card.apply_standardized(x_small.to(dev), small_lens.to(dev))
        t0 = time.perf_counter()
        want, want_lens = cpu.apply_standardized(x_small, small_lens)
        cpu_s = time.perf_counter() - t0
        check(torch.equal(got_lens.cpu(), want_lens), f"{name} {dtype} CPU lengths")
        coss = layer_cosines(got.float().cpu(), want.float(), want_lens.tolist())
        params = sum(p.numel() for p in card.model.parameters()) / 1e6
        log(f"[zoo] {name} {dtype}{' flash' if flash else ''} ({params:.1f}M parameters, "
            f"{card.num_layers} x {card.hidden_size}) B={ZOO_B} x 2-{ZOO_SECS} s: launches "
            f"{run or 'none'} (every other count 0); {ms:.2f} ms a forward "
            f"({audio / (ms / 1e3):.1f} audio-s/s), device idle share {idle_text(idle)}; card "
            f"vs CPU "
            f"B=2 x 1.3-2 s layer cosines min {min(coss):.6f}; loads {loaded:.1f} s, CPU "
            f"forward {cpu_s:.1f} s; {smi}")
        check(min(coss) > COS_LAYER, f"{name} {dtype} card vs CPU {coss}")
        del card, cpu, got, want


# the conv, recurrent and windowed families and the small front ends: (entry,
# dtype; None for an entry that takes none). None of them runs a kernel
ZOO2 = (("wav2vec_large", "f32"), ("vq_wav2vec", "f32"), ("vq_wav2vec_kmeans", "f32"),
        ("cpc", "f32"), ("decoar", "f32"), ("decoar_layers", "f32"), ("decoar2", "f32"),
        ("decoar2", "bf16"), ("byol_a", "f32"), ("byol_s", "f32"), ("byol_s_resnetish34", "f32"),
        ("byol_s_cvt", "f32"), ("wav", None), ("log_stft", None), ("example", None))
# vq-wav2vec card vs CPU: the codes equal on this share of the valid frames
# (random codebooks leave near-ties that the last bits of z move), z at
# COS_LAYER, the aggregator's states at VQ_COS (a moved code brings another
# codeword into the causal aggregator's next frames)
VQ_SHARE, VQ_COS = 0.995, 0.99


def code_share(card, cpu, x, lens):
    """The share of vq-wav2vec's codes equal on the card and on the CPU over
    the valid frames of (x, lens) (a CPU batch); `card` and `cpu` are the
    two copies of the Wav2Vec1Model."""
    dev = next(card.parameters()).device
    with torch.inference_mode():
        _, h_lens, got = card(x.to(dev), lens.to(dev), return_code_ids=True)
        _, _, want = cpu(x, lens, return_code_ids=True)
    valid = torch.arange(want.shape[1])[None] < h_lens.cpu()[:, None]
    return float((got.cpu() == want)[valid].float().mean())


def zoo2_phase(wrapper, gen, dev, smi):
    """Phase 15: each ZOO2 entry from seed 0 at its published width through
    hub.load on the card: one apply_standardized on B=8 x 2-10 s with no
    kernel launched (the counts set to 0 just before, read just after),
    shape, lengths and finite values; the forward timed by CUDA events with
    its audio-s/s and the profiler's device idle share; then the same model
    moved to the CPU against the card on B=2 x 1.3-2 s, per-layer cosine >
    0.999 over the valid frames, and vq-wav2vec's code share."""
    from s3prl_tpu_torch import hub

    rng = np.random.RandomState(15)
    n = ZOO_SECS * SR
    lens = torch.from_numpy(np.concatenate([[n], rng.randint(2 * SR, n, ZOO_B - 1)]))
    x = (torch.randn(ZOO_B, n, generator=gen) * (torch.arange(n)[None] < lens[:, None])).to(dev)
    lens_d = lens.to(dev)
    small_lens = torch.tensor([2 * SR, int(1.3 * SR)])
    x_small = torch.randn(2, 2 * SR, generator=gen) * (torch.arange(2 * SR)[None] <
                                                       small_lens[:, None])
    audio = float(lens.sum()) / SR
    for name, dtype in ZOO2:
        t0 = time.perf_counter()
        card = hub.load(name) if dtype is None else hub.load(
            name, dtype={"bf16": torch.bfloat16, "f32": torch.float32}[dtype], seed=0)
        loaded = time.perf_counter() - t0
        for w in wrapper.values():
            w.launches = 0
        hs, h_lens = card.apply_standardized(x, lens_d)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrapper.items() if w.launches}
        check(not launches, f"{name} {dtype} launches {launches}")
        stride = card.downsample_rate
        check(tuple(hs.shape) == (card.num_layers, ZOO_B, (n - 1) // stride + 1, card.hidden_size)
              and torch.equal(h_lens.cpu(), (lens - 1) // stride + 1)
              and bool(torch.isfinite(hs).all()), f"{name} {dtype} {tuple(hs.shape)}")
        del hs
        fn = lambda: card.apply_standardized(x, lens_d)  # noqa: E731
        ms = cuda_ms(fn, ZOO_ITERS)
        idle, _ = profile_calls(fn, iters=2)
        cpu = on_cpu(card)
        got, got_lens = card.apply_standardized(x_small.to(dev), small_lens.to(dev))
        t0 = time.perf_counter()
        want, want_lens = cpu.apply_standardized(x_small, small_lens)
        cpu_s = time.perf_counter() - t0
        check(torch.equal(got_lens.cpu(), want_lens), f"{name} {dtype} CPU lengths")
        coss = layer_cosines(got.float().cpu(), want.float(), want_lens.tolist())
        share = (code_share(card.model, cpu.model, x_small, small_lens)
                 if name.startswith("vq_") else None)
        params = sum(p.numel() for p in card.model.parameters()) / 1e6
        log(f"[zoo2] {name} {dtype or ''} ({params:.1f}M parameters, {card.num_layers} x "
            f"{card.hidden_size}, stride {stride}) B={ZOO_B} x 2-{ZOO_SECS} s: no launch; "
            f"{ms:.2f} ms a forward ({audio / (ms / 1e3):.1f} audio-s/s), device idle share "
            f"{idle_text(idle)}; card vs CPU B=2 x 1.3-2 s layer cosines min {min(coss):.6f}"
            f"{'' if share is None else f', codes equal {share:.4f}'}; loads {loaded:.1f} s, "
            f"CPU forward {cpu_s:.1f} s; {smi}")
        check(min(coss) > COS_LAYER if share is None else (
            coss[0] > COS_LAYER and min(coss[1:]) > VQ_COS and share >= VQ_SHARE),
            f"{name} {dtype} card vs CPU {coss}, codes {share}")
        del card, cpu, got, want
        torch.cuda.empty_cache()


# the rest of the hub (phase 16): (entry, its hub.load keywords, the launches
# of one apply_standardized on the B=8 batch; every other count 0). "swish
# f32" / "swish int8" are HuBERT-Large's shape with activation_fn swish,
# loaded through ckpt= from a temporary s3prl checkpoint (SWISH_CFG)
ZOO3 = (("ssast_patch_base", {"dtype": torch.float32}, {}),
        ("ssast_frame_base", {"dtype": torch.float32}, {}),
        ("passt_base", {"dtype": torch.float32}, {}),
        ("passt_base2levelmel", {"dtype": torch.float32}, {}),
        ("passt_hop100base2lvlmel", {"dtype": torch.float32}, {}),
        ("vggish", {}, {}), ("vq_wav2vec_kmeans_roberta", {}, {}),
        ("pase_plus", {"dtype": torch.float32}, {}), ("spec_augment", {}, {}),
        ("hf_wav2vec2", {}, {"conv0_ln_gelu": 1}),
        ("swish f32", {"dtype": torch.float32}, {"conv0_ln_gelu": 1}),
        ("swish int8", {"dtype": torch.bfloat16, "flash": True, "quantize": True},
         {"conv0_ln_gelu": 1, "fused_qkv_attention": 24}))
SWISH_CFG = {"_name": "hubert", "extractor_mode": "layer_norm", "encoder_layers": 24,
             "encoder_embed_dim": 1024, "encoder_ffn_embed_dim": 4096,
             "encoder_attention_heads": 16, "activation_fn": "swish", "layer_norm_first": True,
             "dropout": 0.0, "attention_dropout": 0.0, "dropout_input": 0.0}


def spec_augment_check(card, x, lens, dev):
    """SpecAugment's train mode on the card, seeded: at most 2 frequency
    bands of <= 27 bins and 2 time bands of <= 100 frames an utterance
    (the bands redrawn from the same seed), the time bands inside each
    utterance's frames, every other value eval mode's; its seconds."""
    from s3prl_tpu_torch.nn import specaug

    model = card.model
    with torch.inference_mode():
        plain, feat_lens = model(x, lens)
        t0 = time.perf_counter()
        masked, _ = model.train()(x, lens, generator=torch.Generator(device=dev).manual_seed(16))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        model.eval()
    B, T, D = plain.shape[1:]
    gen = torch.Generator(device=dev).manual_seed(16)
    fb, tb = specaug.draw_bands(gen, B, D, 2, 27), specaug.draw_bands(gen, B, T, 2, 100)
    check(int(fb[1].max()) <= 27 and int(tb[1].max()) <= 100, "spec_augment band widths")
    check(torch.equal(masked[0], specaug.mask_bands(plain[0], feat_lens, fb, tb)),
          "spec_augment masks")
    changed = masked[0] != plain[0]
    outside = torch.arange(T, device=dev)[None] >= feat_lens[:, None]
    freq = (masked[0] == 0).all(dim=1)
    check(bool(((masked[0] == 0) | ~changed).all())
          and not bool((changed & outside[..., None] & ~freq[:, None, :]).any())
          and bool(changed.any()), "spec_augment masked values")
    return secs, int(changed.sum())


# ZOO3 entries whose B=8 x 10 s forward takes seconds: timed over one call
SLOW_ZOO3 = ("passt_hop100base2lvlmel",)


def zoo3_phase(wrapper, gen, dev, smi):
    """Phase 16: each ZOO3 entry from seed 0 at its published width through
    hub.load on the card: one apply_standardized on B=8 x 2-10 s with its
    launches (the counts set to 0 just before, read just after), shape,
    lengths and finite values; the forward timed by CUDA events with its
    audio-s/s and the profiler's device idle share; then the same model
    moved to the CPU against the card on B=2 x 1.3-2 s: equal lengths (the
    upstream's and the model's own), per-layer cosine > 0.999 over the valid
    frames (the RoBERTa pipeline: its k-means codes equal on >= 99.5% of
    the frames, its states > 0.99, as phase 15's vq-wav2vec); SpecAugment's
    train mode on the card (`spec_augment_check`)."""
    import tempfile

    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.upstream.base import standardize_hidden_states

    rng = np.random.RandomState(16)
    n = ZOO_SECS * SR
    lens = torch.from_numpy(np.concatenate([[n], rng.randint(2 * SR, n, ZOO_B - 1)]))
    x = (torch.randn(ZOO_B, n, generator=gen) * (torch.arange(n)[None] < lens[:, None])).to(dev)
    lens_d = lens.to(dev)
    small_lens = torch.tensor([2 * SR, int(1.3 * SR)])
    x_small = torch.randn(2, 2 * SR, generator=gen) * (torch.arange(2 * SR)[None] <
                                                       small_lens[:, None])
    audio = float(lens.sum()) / SR
    with tempfile.TemporaryDirectory() as tmp:
        swish = os.path.join(tmp, "swish.ckpt")
        t0 = time.perf_counter()
        base = hub.load("hubert_large_ll60k", seed=0, device="cpu")
        torch.save({"model_weight": base.model.state_dict(), "model_cfg": SWISH_CFG,
                    "task_cfg": {"normalize": True}}, swish)
        del base
        log(f"[zoo3] the swish checkpoint written in {time.perf_counter() - t0:.1f} s")
        for name, kw, run in ZOO3:
            t0 = time.perf_counter()
            card = (hub.load("hubert_large_ll60k", ckpt=swish, **kw) if name.startswith("swish")
                    else hub.load(name, seed=0, **kw))
            loaded = time.perf_counter() - t0
            for w in wrapper.values():
                w.launches = 0
            hs, h_lens = card.apply_standardized(x, lens_d)
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrapper.items()}
            check(launches == {k: run.get(k, 0) for k in wrapper},
                  f"{name} launches { {k: v for k, v in launches.items() if v} }")
            stride = card.downsample_rate
            check(tuple(hs.shape) == (card.num_layers, ZOO_B, (n - 1) // stride + 1,
                                      card.hidden_size)
                  and torch.equal(h_lens.cpu(), (lens - 1) // stride + 1)
                  and bool(torch.isfinite(hs).all()), f"{name} {tuple(hs.shape)}")
            del hs
            fn = lambda: card.apply_standardized(x, lens_d)  # noqa: E731
            slow = name in SLOW_ZOO3  # a forward of seconds: one timed, one profiled
            ms = cuda_ms(fn, 1 if slow else ZOO_ITERS)
            idle, _ = profile_calls(fn, iters=1 if slow else 2)
            cpu = on_cpu(card)
            # one forward a side gives both the model's lengths and the states
            # (`Upstream.standardized`'s rule on them: 2 s needs no padding)
            with torch.inference_mode():
                raw_hs, raw = card.model(x_small.to(dev), small_lens.to(dev))
                t0 = time.perf_counter()
                raw_hs_cpu, raw_cpu = cpu.model(x_small, small_lens)
                cpu_s = time.perf_counter() - t0
            check(torch.equal(raw.cpu(), raw_cpu), f"{name} the model's lengths {raw} {raw_cpu}")
            got, got_lens = standardize_hidden_states(raw_hs, small_lens.to(dev),
                                                      x_small.shape[1], stride)
            want, want_lens = standardize_hidden_states(raw_hs_cpu, small_lens,
                                                        x_small.shape[1], stride)
            check(torch.equal(got_lens.cpu(), want_lens), f"{name} CPU lengths")
            coss = layer_cosines(got.float().cpu(), want.float(), want_lens.tolist())
            share = None
            if name == "vq_wav2vec_kmeans_roberta":
                share = code_share(card.model.w2v, cpu.model.w2v, x_small, small_lens)
            extra = ""
            if name == "spec_augment":
                secs, masked = spec_augment_check(card, x, lens_d, dev)
                extra = (f"; train mode on the card: {masked} values masked, bands within "
                         f"2 x 27 bins and 2 x 100 frames, {secs * 1e3:.2f} ms")
            params = sum(p.numel() for p in card.model.parameters()) / 1e6
            log(f"[zoo3] {name} ({params:.1f}M parameters, {card.num_layers} x "
                f"{card.hidden_size}, stride {stride}) B={ZOO_B} x 2-{ZOO_SECS} s: launches "
                f"{run or 'none'} (every other count 0); {ms:.2f} ms a forward "
                f"({audio / (ms / 1e3):.1f} audio-s/s), device idle share "
                f"{idle_text(idle)}; card vs "
                f"CPU B=2 x 1.3-2 s layer cosines min {min(coss):.6f}"
                f"{'' if share is None else f', codes equal {share:.4f}'}{extra}; loads "
                f"{loaded:.1f} s, CPU forward {cpu_s:.1f} s; {smi}")
            check(min(coss) > COS_LAYER if share is None else (
                min(coss) > VQ_COS and share >= VQ_SHARE),
                f"{name} card vs CPU {coss}, codes {share}")
            del card, cpu, got, want
            torch.cuda.empty_cache()


# -- phase 17: SSL pretraining at published widths
# recipe -> the JAX recipe's default batch size (problem/pretrain.py)
PRETRAIN = {"PretrainMockingjay": 8, "PretrainTera": 8, "PretrainAudioAlbert": 8,
            "PretrainSpecAugment": 8, "PretrainAPC": 32, "PretrainVqApc": 32,
            "PretrainNPC": 32, "PretrainDistiller": 12, "PretrainHubert": 8,
            "PretrainData2Vec": 8}
PT_STEPS = 3  # checked train steps a recipe
PT_SECS = (2, 15)  # the batches' wave lengths, seconds
PT_CPU = [2 * SR, int(1.5 * SR)]  # the card-vs-CPU update's batch
PT_UNITS = 100  # the HuBERT batch's unit classes (prepare_units' k-means default)
PT_RTOL = 1e-3  # card vs CPU: the loss and the gradient norm
PT_ZERO = 1e-5  # a gradient below this share of the whole one's norm is zero but rounding
PT_K3_ATOL = 1e-4  # K3 on f32 waves against its plain version
PT_STEP_RTOL = 1e-3  # the update on the card against its CPU replay, in norm


def pt_batch(name, lens, rng):
    """A recipe's batch as its loader gives it: waves (0.1 N(0, 1)) padded
    to the next whole second, their lengths, and for HuBERT random units,
    one a 320 samples, padded with 0."""
    T = -(-max(lens) // SR) * SR
    lens = np.asarray(lens)
    x = (rng.randn(len(lens), T) * 0.1).astype(np.float32) * (np.arange(T)[None] < lens[:, None])
    out = {"x": x, "x_len": lens.astype(np.int32)}
    if name == "PretrainHubert":
        n = lens // 320
        units = (rng.randint(0, PT_UNITS, (len(lens), n.max()))
                 * (np.arange(n.max())[None] < n[:, None]))
        out.update(units=units.astype(np.int32), units_len=n.astype(np.int32))
    return out


class same_draws:
    """The pretraining tasks' draws (span masks, MAM masks, SpecAugment
    bands, Gumbel noise) from one CPU generator of seed 0, moved to `dev`:
    a run on the card and one on the CPU draw the same."""

    def __init__(self, dev):
        self.dev = dev

    def __enter__(self):
        import s3prl_tpu_torch.task.data2vec_pretrain as d2v
        import s3prl_tpu_torch.task.hubert_pretrain as hub_task
        import s3prl_tpu_torch.task.reconstruction as rec
        from s3prl_tpu_torch.models.apc import VQLayer
        from s3prl_tpu_torch.ops import mam, masking

        gen, dev = torch.Generator().manual_seed(0), self.dev

        def span(_, shape, pad, *a, device=None, **k):
            return masking.compute_mask_indices(gen, shape, pad.cpu(), *a, **k).to(dev)

        def mam_mask(_, feats, lens, **kw):
            u = mam.draw_mam_uniforms(gen, *feats.shape[:2], **kw)
            return mam.mam_mask_from_uniforms({k: v.to(dev) for k, v in u.items()}, feats, lens,
                                              **kw)

        def spec(_, *a, **k):
            return tuple(m.to(dev) for m in self.saved[3][2](gen, *a, **k))

        def gumbel(logits, _):
            return self.saved[4][2](torch.empty(logits.shape), gen).to(logits.device)

        self.saved = [(hub_task, "compute_mask_indices", hub_task.compute_mask_indices, span),
                      (d2v, "compute_mask_indices", d2v.compute_mask_indices, span),
                      (rec, "mam_mask", rec.mam_mask, mam_mask),
                      (rec, "spec_masks", rec.spec_masks, spec),
                      (VQLayer, "draw_gumbel", VQLayer.draw_gumbel, staticmethod(gumbel))]
        for owner, attr, _, new in self.saved:
            setattr(owner, attr, new)

    def __exit__(self, *exc):
        for owner, attr, old, _ in self.saved:
            setattr(owner, attr, staticmethod(old) if attr == "draw_gumbel" else old)


def pt_no_dropout(module):
    """Every dropout rate in `module` set to 0: its modules' config fields
    and their rate attributes (NPC's blocks' ``p``)."""
    import dataclasses

    for m in module.modules():
        cfg = getattr(m, "cfg", None)
        if dataclasses.is_dataclass(cfg):
            m.cfg = dataclasses.replace(cfg, **{
                f.name: 0.0 for f in dataclasses.fields(cfg)
                if "dropout" in f.name and isinstance(getattr(cfg, f.name), float)})
        for field in ("dropout", "activation_dropout", "p"):
            if isinstance(getattr(m, field, None), float):
                setattr(m, field, 0.0)


def pt_update_on_cpu(name, up, task, opt_cfg, batch):
    """One update of a copy of the recipe's task (its weights after the
    timed steps, every dropout 0, the optimizer fresh at the recipe's peak
    lr) on the card and on the CPU with the same draws (`same_draws`): the
    loss and the gradient norm within PT_RTOL, every gradient whose norm is
    above PT_ZERO of the whole at cosine > PROBE_COS. The update itself (the
    optimizer's step and `post_update`) is held against the same update
    replayed on the CPU from the card's gradients: each state tensor's
    change within PT_STEP_RTOL of the replay's in norm, plus two f32
    roundings of the tensor (`pt_step_error`)."""
    import copy

    from s3prl_tpu_torch.train.optimizers import Optimizer, global_norm

    opt_cfg = {k: v for k, v in opt_cfg.items() if k != "scheduler"}
    card = copy.deepcopy(task)
    pt_no_dropout(card.module)
    cpu = copy.deepcopy(card)
    cpu.module.cpu()
    replay = copy.deepcopy(cpu)
    before = {k: v.detach().double() for k, v in cpu.module.state_dict().items()}
    runs = {}
    t0 = time.perf_counter()
    for where, t, u in (("card", card, up), ("cpu", cpu, on_cpu(up))):
        opt = Optimizer(t.module.parameters(), **opt_cfg)
        hs, h_lens = u(batch["x"], batch["x_len"])
        with same_draws(u.device):
            loss, _ = t.loss_and_cache(hs, h_lens, batch, None, True)
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in t.module.named_parameters()
                 if p.grad is not None}
        norm = float(global_norm([g.double() for g in grads.values()]))
        moved = opt.step()
        if hasattr(t, "post_update"):
            with torch.no_grad():
                t.post_update()
        runs[where] = (float(loss.detach()), norm, grads, moved,
                       {k: v.detach().double().cpu() for k, v in t.module.state_dict().items()})
        if where == "card":
            torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    (l_card, n_card, g_card, moved, w_card), (l_cpu, n_cpu, g_cpu, _, _) = runs["card"], runs["cpu"]
    rel = (abs(l_card / l_cpu - 1), abs(n_card / n_cpu - 1))
    coss = {k: float(g_card[k].double().flatten() @ g_cpu[k].double().flatten()
                     / (g_card[k].double().norm() * g_cpu[k].double().norm()))
            for k in g_cpu if float(g_cpu[k].double().norm()) > PT_ZERO * n_cpu}
    opt = Optimizer(replay.module.parameters(), **opt_cfg)
    for n, p in replay.module.named_parameters():
        if n in g_card:
            p.grad = g_card[n].to(p.dtype)
    opt.step()
    if hasattr(replay, "post_update"):
        with torch.no_grad():
            replay.post_update()
    w_replay = {k: v.detach().double() for k, v in replay.module.state_dict().items()}
    err, changed = pt_step_error(before, w_card, w_replay)
    log(f"[pretrain] {name} one update card vs CPU on B=2 x 1.5-2 s (dropouts 0, the same "
        f"draws; {seconds:.1f} s): loss {l_card:.6f} / {l_cpu:.6f}, grad norm {n_card:.6f} / "
        f"{n_cpu:.6f} (rel {rel[0]:.2e}, {rel[1]:.2e}), gradient cosines min "
        f"{min(coss.values()):.6f} over {len(coss)} of {len(g_cpu)} tensors; the update "
        f"(step{' and post_update' if hasattr(card, 'post_update') else ''}) against its "
        f"replay on the CPU from the card's gradients: {changed} of {len(w_replay)} state "
        f"tensors changed, largest change error {err:.2e} of its bound")
    check(max(rel) < PT_RTOL and min(coss.values()) > PROBE_COS and moved and changed > 0
          and err <= 1.0, f"{name} update card vs CPU")


def pt_step_error(before, after, expected):
    """The largest over state tensors of ||(after - before) - (expected -
    before)|| over its bound, PT_STEP_RTOL ||expected - before|| + 2 eps_f32
    ||before|| (a wrong, skipped or partial step or EMA gives > 1), and the
    number of tensors the expected update changed."""
    eps = float(torch.finfo(torch.float32).eps)
    worst, changed = 0.0, 0
    for k, w0 in before.items():
        want = expected[k] - w0
        changed += bool(want.abs().max() > 0) if want.numel() else 0
        bound = PT_STEP_RTOL * float(want.norm()) + 2 * eps * float(w0.norm())
        miss = float((after[k] - w0 - want).norm())
        worst = max(worst, miss / bound if bound > 0 else (0.0 if miss == 0 else float("inf")))
    return worst, changed


def pt_teacher_k3(task, wavs, lens, wrapper):
    """data2vec's teacher on the card: K3 on the waves the step gave it
    against its plain version (f32 at PT_K3_ATOL); then the teacher moved by
    an EMA toward a perturbed student (decay 0 for the one update): its next
    forward launches K3 once with the moved weights, the output the plain
    version's on them and away from the old weights' one."""
    import s3prl_tpu_torch.models.convfe as convfe
    from s3prl_tpu_torch.kernels.conv_frontend import conv0_ln_gelu, conv0_ln_gelu_reference

    layer0 = task.module.teacher.feature_extractor.conv_layers[0]
    seen = []
    kernel = convfe.conv0_ln_gelu
    convfe.conv0_ln_gelu = lambda *a, **k: seen.append((a, k)) or kernel(*a, **k)
    try:
        old = [t.detach().clone() for t in (layer0.conv.weight, layer0.norm.weight,
                                           layer0.norm.bias)]
        results = []
        for step in ("before", "after"):
            if step == "after":
                with torch.no_grad():
                    s0 = task.module.student.feature_extractor.conv_layers[0].conv.weight
                    s0.add_(0.05 * torch.randn_like(s0))
                decay, task.ema_decay = task.ema_decay, 0.0
                task.post_update()
                task.ema_decay = decay
            for w in wrapper.values():
                w.launches = 0
            task.targets(wavs, lens)
            torch.cuda.synchronize()
            check(wrapper["conv0_ln_gelu"].launches == 1 and len(seen) == 1,
                  f"data2vec teacher forward: K3 launches {wrapper['conv0_ln_gelu'].launches}")
            (x, weight, scale, bias), kw = seen.pop()
            check(torch.equal(weight, layer0.conv.weight), "K3 read the teacher's weights")
            with torch.no_grad():
                got = conv0_ln_gelu(x, weight, scale, bias, **kw)
                want = conv0_ln_gelu_reference(x, weight, scale, bias, kw.get("stride", 5),
                                               kw.get("k", 10), kw.get("gelu_mode", "erf"))
            cos, err = compare(got, want)
            results.append((tuple(got.shape), cos, err))
            check(cos > COS_KERNEL and err <= PT_K3_ATOL, f"K3 {step} the EMA vs plain")
        with torch.no_grad():
            stale = conv0_ln_gelu_reference(x, old[0], old[1], old[2], kw.get("stride", 5),
                                             kw.get("k", 10), kw.get("gelu_mode", "erf"))
        moved = float((got.double() - stale.double()).abs().max())
        check(moved > 100 * PT_K3_ATOL, f"the moved teacher's K3 output moved {moved}")
    finally:
        convfe.conv0_ln_gelu = kernel
    (shape, cos, err), (_, cos2, err2) = results
    log(f"[pretrain] data2vec teacher K3 (erf, f32 waves) {shape} vs plain: cos {cos:.7f} "
        f"max_abs_err {err:.3e}; after the EMA moved it (decay 0 toward a perturbed student): "
        f"one launch on the moved weights, cos {cos2:.7f} max_abs_err {err2:.3e}, "
        f"{moved:.3e} from the old weights' output")
    return err


def pt_recipe(name, B, wrapper, rng, dev, smi, exp_dir):
    """Recipe `name` at its JAX default config on the card: the problem's
    feature upstream and task, the Trainer with the recipe's optimizer;
    PT_STEPS steps on B waves of 2-15 s (each step's launches: K3 once in
    data2vec's teacher, nothing elsewhere; losses finite; all but the first
    timed by CUDA events: ms, audio-s/s, peak memory), one more under the
    profiler tracing the device alone (device idle share, `idle_text`);
    data2vec's teacher K3 (`pt_teacher_k3`); one update against the CPU
    (`pt_update_on_cpu`)."""
    import s3prl_tpu_torch.problem.pretrain as port_pretrain
    from s3prl_tpu_torch.task.hubert_pretrain import device_wavs
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    t0 = time.perf_counter()
    problem = getattr(port_pretrain, name)()
    config = problem.default_config()
    up = problem.build_feature_upstream(config)
    task = problem.build_task(config)
    trainer = Trainer(up, task, exp_dir / name, TrainerConfig(
        optimizer=config["build_optimizer"], total_steps=config["train"]["total_steps"],
        tensorboard=False))
    trainer.init(resume=False)
    built = time.perf_counter() - t0
    lens = [PT_SECS[1] * SR] + rng.randint(PT_SECS[0] * SR, PT_SECS[1] * SR, B - 1).tolist()
    data = pt_batch(name, lens, rng)
    expected = {k: int(name == "PretrainData2Vec" and k == "conv0_ln_gelu") for k in wrapper}
    losses, times = [], []
    t1 = time.perf_counter()
    for i in range(PT_STEPS):  # the first warms up; the others are timed
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        for w in wrapper.values():
            w.launches = 0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _, grad_norm = trainer.train_step(data)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        launches = {k: w.launches for k, w in wrapper.items()}
        check(launches == expected, f"{name} step launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        losses.append(float(loss))
        check(np.isfinite(losses[-1]) and np.isfinite(float(grad_norm)), f"{name} {losses}")
    ms = float(np.mean(times[1:]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    t2 = time.perf_counter()
    idle, kernels = profile_calls(lambda: trainer.train_step(data), iters=1, warm=False)
    check(sum(kernels.values()) > 0, f"{name}: the device trace holds no kernel")
    t3 = time.perf_counter()
    audio = sum(lens) / SR
    params = sum(p.numel() for p in task.module.parameters()) / 1e6
    log(f"[pretrain] {name} ({params:.1f}M parameters, upstream {up.name}, "
        f"{config['build_optimizer']['name']}) B={B} x {PT_SECS[0]}-{PT_SECS[1]} s: launches a "
        f"step {({'conv0_ln_gelu': 1} if any(expected.values()) else 'none')} (every other "
        f"count 0); losses {' '.join(f'{v:.5f}' for v in losses)}; {ms:.2f} ms a step (steps "
        f"2-{PT_STEPS}: {' '.join(f'{t:.2f}' for t in times[1:])}; {audio / (ms / 1e3):.1f} "
        f"audio-s/s), peak device memory {peak:.2f} GiB, device idle share {idle_text(idle)}; "
        f"seconds: "
        f"built {built:.1f}, steps {t2 - t1:.1f}, profiled step {t3 - t2:.1f}; {smi}")
    if name == "PretrainData2Vec":
        pt_teacher_k3(task, *device_wavs(data, dev), wrapper)
    pt_update_on_cpu(name, up, task, config["build_optimizer"], pt_batch(name, PT_CPU, rng))
    return ms


def pt_units(exp_dir, rng, dev, smi):
    """PretrainHubert's prepare_units on the card on a minute of audio (six
    10-s waves of tones under noise): the MFCC, k-means (100 clusters, 20
    iterations) and a units file an utterance, each one label a 20 ms; then
    five Lloyd iterations from one init on the card and on the CPU: the
    centroids within 1e-3 of their scale, the assignments equal on >= 99.9%."""
    import pandas as pd

    import s3prl_tpu_torch.problem.pretrain as port_pretrain
    from s3prl_tpu_torch.models.baseline import baseline_features
    from s3prl_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit_from, kmeans_init
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    class Units(port_pretrain.PretrainHubert):
        def prepare_data(self, workspace, config):
            (workspace / "wavs").mkdir(parents=True, exist_ok=True)
            rows = []
            t = np.arange(10 * SR) / SR
            for i in range(6):
                f0 = np.repeat(rng.choice([200.0, 450.0, 900.0, 1800.0], 20), SR // 2)
                wav = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR) + 0.05 * rng.randn(len(t))
                path = workspace / "wavs" / f"u{i}.wav"
                _write_wav(path, wav.astype(np.float32))
                rows.append({"id": f"u{i}", "wav_path": str(path), "duration": 10.0})
            pd.DataFrame(rows).to_csv(workspace / "train.csv", index=False)

    problem, ws = Units(), exp_dir / "units"
    config = problem.default_config()
    problem.prepare_data(ws, config)
    t0 = time.perf_counter()
    problem.prepare_units(ws, config)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    centroids = np.load(ws / "units" / "centroids.npy")
    check(centroids.shape == (100, 39) and np.isfinite(centroids).all(), "centroids")
    df = pd.read_csv(ws / "train.csv")
    frames = []
    for path, upath in zip(df["wav_path"], df["units_path"]):
        from s3prl_tpu_torch.data.audio import load_wav

        wav, _ = load_wav(path, SR, 0.0, 15.0)
        with torch.no_grad():
            f, fl = baseline_features(torch.from_numpy(wav).to(dev)[None],
                                      torch.tensor([len(wav)], device=dev), feat_type="mfcc",
                                      num_ceps=13, delta_order=2, cmvn=False)
        f = f[0, :int(fl[0])][::2].float()
        frames.append(f)
        units = np.load(upath)
        check(units.dtype == np.int32 and len(units) == len(f)
              and units.min() >= 0 and units.max() < 100, f"units of {path}")
        check(np.array_equal(units, kmeans_assign(f, torch.from_numpy(centroids).to(dev))
                             .cpu().numpy()), f"units of {path} vs the centroids")
    sample = torch.cat(frames)
    init = kmeans_init(torch.Generator().manual_seed(0), sample.cpu(), 100)
    c_card = kmeans_fit_from(sample, init.to(dev), 5).cpu()
    c_cpu = kmeans_fit_from(sample.cpu(), init, 5)
    err = float((c_card - c_cpu).abs().max()) / float(c_cpu.abs().max())
    same = float((kmeans_assign(sample.cpu(), c_card) == kmeans_assign(sample.cpu(), c_cpu))
                 .float().mean())
    log(f"[pretrain] prepare_units on {len(sample)} frames of 60 s (6 x 10 s) on the card: "
        f"{secs:.2f} s (MFCC, k-means 100 x 20 iterations, the units files); five iterations "
        f"card vs CPU from one init: centroids within {err:.2e} of their scale, assignments "
        f"equal {same:.5f}; {smi}")
    check(err <= 1e-3 and same >= 0.999, "k-means card vs CPU")


def pt_problem_run(exp_dir, rng, wrapper, dev):
    """A whole PretrainData2Vec Problem.run of 2 steps at B=8 over 2-15 s
    pseudo waves (K3 once a step in the teacher, nothing else), then
    hub.load("data2vec", ckpt=<its train dir>) on the card: K3 once a
    forward and its states those of the trained student (cosine >
    0.99999, max abs error <= 1e-4)."""
    import s3prl_tpu_torch.problem.pretrain as port_pretrain
    from s3prl_tpu_torch import hub

    class D2V(port_pretrain.PretrainData2Vec):
        def prepare_data(self, workspace, config):
            (workspace / "wavs").mkdir(parents=True, exist_ok=True)
            for split, n in (("train", 8), ("valid", 2)):
                port_pretrain._write_pseudo_split(workspace, rng, split, n, PT_SECS)

    problem, ws = D2V(), exp_dir / "d2v_run"
    config = problem.default_config()
    config.pop("target_dir")
    # the Trainer's closing save writes the one checkpoint (2.2 GB with Adam's state)
    config["train"] = {"total_steps": 2, "log_step": 1, "eval_step": 10**9, "save_step": 10**9}
    for w in wrapper.values():
        w.launches = 0
    t0 = time.perf_counter()
    trainer = problem.run(str(ws), **config)["train_stage"]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrapper.items()}
    check(launches == {k: 2 * (k == "conv0_ln_gelu") for k in wrapper},
          f"PretrainData2Vec run launches { {k: v for k, v in launches.items() if v} }")
    up = hub.load("data2vec", ckpt=str(ws / "train"))
    x, lens = batch([10 * SR, 7 * SR], 10 * SR, torch.Generator().manual_seed(1), dev)
    for w in wrapper.values():
        w.launches = 0
    with torch.no_grad():
        got, _ = up.model(x, lens)
        torch.cuda.synchronize()
        check(wrapper["conv0_ln_gelu"].launches == 1, "hub.load('data2vec') forward: K3 once")
        want, _ = trainer.task.module.student.eval()(x, lens)
    cos, err = compare(got, want)
    log(f"[pretrain] PretrainData2Vec Problem.run (2 steps, B=8 x 2-15 s, the checkpoint "
        f"written): {secs:.1f} s, K3 launches {launches['conv0_ln_gelu']} (every other count 0); "
        f"hub.load('data2vec', ckpt=<train dir>) on the card: K3 once a forward, states "
        f"{tuple(got.shape)} vs the student's cos {cos:.7f} max_abs_err {err:.2e}")
    check(cos > 0.99999 and err <= 1e-4, "the loaded data2vec vs the trained student")


def pretrain_phase(wrapper, gen, dev, smi):
    """Phase 17: every pretraining recipe but the Examples at its JAX
    default config on the card (`pt_recipe`), prepare_units (`pt_units`)
    and a whole PretrainData2Vec run loaded back through the hub
    (`pt_problem_run`)."""
    import tempfile
    from pathlib import Path

    rng = np.random.RandomState(17)
    with tempfile.TemporaryDirectory() as tmp:
        exp_dir = Path(tmp)
        for name, B in PRETRAIN.items():
            pt_recipe(name, B, wrapper, rng, dev, smi, exp_dir)
            torch.cuda.empty_cache()
        pt_units(exp_dir, rng, dev, smi)
        pt_problem_run(exp_dir, rng, wrapper, dev)
    torch.cuda.empty_cache()


# -- 18. parallelism: two ranks sharing the one card --------------------------------

PAR_STEPS = 3  # probe steps of case (a); the first is not timed
PAR_SECS = {"dp": 10, "tp": 10, "sp": 30}  # the longest utterance of each case's batch


def par_batch(B, secs, seed):
    """B waves of up to `secs` s from a seed, the lengths ragged
    (numpy: every rank draws the same)."""
    rng = np.random.RandomState(seed)
    T = int(secs * SR)
    lens = np.array([T - (i * T) // (3 * B) for i in range(B)])
    return (rng.randn(B, T) * (np.arange(T) < lens[:, None])).astype(np.float32), lens


def par_launches():
    from s3prl_tpu_torch.kernels import wrappers

    return {w.__name__: w.launches for w in wrappers() if w.launches}


def par_reset():
    from s3prl_tpu_torch.kernels import wrappers

    for w in wrappers():
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def par_timed(fn):
    """(fn's result, its host ms to a synchronised end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def halves_step(trainer, batch, groups):
    """One step of `trainer` (a mesh of one rank) on the global `batch`
    whose frozen upstream runs on the dp ranks' row `groups`, as each rank
    runs it: the stock bf16 ops around the kernels pick their algorithms by
    batch shape, so one B=8 forward of HuBERT-Large int8 rounds otherwise
    than two B=4 ones (21% of the states' elements, up to 0.69 of 22.5 at
    layer 18 on an H100; PERF.md), which no dp mechanism is at fault for.
    The loss."""
    rows = len(batch["x"]) // groups
    parts = [trainer.upstream(batch["x"][i:i + rows], batch["x_len"][i:i + rows])
             for i in range(0, len(batch["x"]), rows)]
    hs, h_lens = torch.cat([h for h, _ in parts], 1), torch.cat([n for _, n in parts])
    loss = float(trainer.probe_step(hs, h_lens, batch)[0])
    trainer.step += 1
    return loss


def par_dp(hub, tmp):
    """(a) dp = 2: HuBERT-Large int8 + flash, frozen, an utterance probe,
    PAR_STEPS steps on the global B=8 x 10 s; the same steps by this process
    alone (a mesh of its own rank) first, its upstream on the ranks' row
    groups (`halves_step`), and the natural one-process step for the log."""
    from s3prl_tpu_torch.nn import UpstreamDownstreamModel, UtteranceLevel
    from s3prl_tpu_torch.parallel.mesh import make_mesh
    from s3prl_tpu_torch.parallel.distributed import rank
    from s3prl_tpu_torch.task import UtteranceClassificationTask
    from s3prl_tpu_torch.train import Trainer, TrainerConfig

    up = hub.load("hubert_large_ll60k", dtype=torch.bfloat16, flash=True, quantize=True)
    wavs, lens = par_batch(8, PAR_SECS["dp"], 21)
    batch = {"x": wavs, "x_len": lens, "class_id": np.arange(8) % 4}

    def trainer(mesh, where):
        task = UtteranceClassificationTask(
            UpstreamDownstreamModel(UtteranceLevel(1024, 4, (256,)), up.num_layers), 4)
        t = Trainer(up, task, os.path.join(tmp, f"{where}{rank()}"), TrainerConfig(
            total_steps=PAR_STEPS, tensorboard=False, optimizer={"name": "Adam", "lr": 1e-3}),
            mesh=mesh)
        t.init(resume=False)
        return t

    alone = make_mesh(ranks=[rank()])
    one = trainer(alone, "one")
    want = [halves_step(one, batch, 2) for _ in range(PAR_STEPS)]
    natural = float(trainer(alone, "natural").train_step(batch)[0])
    dp = trainer(None, "dp")  # the world's mesh: dp = 2
    check(dp.dp == 2, f"dp {dp.dp}")
    out = {"want": want, "natural": natural, "losses": [], "launches": [], "ms": []}
    for _ in range(PAR_STEPS):
        par_reset()
        (loss, _, _), ms = par_timed(lambda: dp.train_step(batch))
        out["losses"].append(float(loss))
        out["launches"].append(par_launches())
        out["ms"].append(ms)
    out["ms"] = out["ms"][1:]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["max_abs"] = max(float((a - b).abs().max()) for a, b in zip(
        dp.task.module.state_dict().values(), one.task.module.state_dict().values()))
    return out


def par_tp(hub):
    """(b) tp = 2: HuBERT-Large and WavLM-Large bf16 + flash on B=4 x 10 s,
    against the tp = 1 forward of the same weights (K4 / K5 for HuBERT)."""
    from s3prl_tpu_torch.parallel.mesh import make_mesh, shard_params

    mesh = make_mesh(tp=2)
    wavs, lens = par_batch(4, PAR_SECS["tp"], 22)
    x, n = torch.from_numpy(wavs).cuda(), torch.from_numpy(lens).cuda()
    out = {}
    for name in ("hubert_large_ll60k", "wavlm_large"):
        up = hub.load(name, dtype=torch.bfloat16, flash=True, quantize=False)
        want, want_lens = up.apply_standardized(x, n)
        shard_params(mesh, up.model)
        up.apply_standardized(x, n)  # warm
        par_reset()
        (hs, h_lens), ms = par_timed(lambda: up.apply_standardized(x, n))
        out[name] = {"launches": par_launches(), "ms": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "lens_equal": torch.equal(h_lens, want_lens),
                     "cos": layer_cosines(hs, want, want_lens.tolist())}
        del up, want, hs
        torch.cuda.empty_cache()
    return out


def par_sp(hub):
    """(c) sp = 2: HuBERT-Large bf16 without flash and HuBERT-Base f32 (the
    group-norm statistics) on B=2 x 30 s of ragged lengths, against the
    one-process forward."""
    from s3prl_tpu_torch.parallel.mesh import (gather_hidden_states, make_mesh,
                                               sequence_sharded_extraction)

    mesh = make_mesh(dp=1, sp=2)
    wavs, lens = par_batch(2, PAR_SECS["sp"], 23)
    out = {}
    for name, dtype in (("hubert_large_ll60k", torch.bfloat16), ("hubert_base", torch.float32)):
        up = hub.load(name, dtype=dtype, flash=False, quantize=False)
        want, want_lens = up.apply_standardized(wavs, lens)
        sequence_sharded_extraction(up, mesh, wavs, lens)  # warm
        par_reset()
        (hs, h_lens), ms = par_timed(lambda: sequence_sharded_extraction(up, mesh, wavs, lens))
        launches, frames = par_launches(), hs.shape[2]
        whole = gather_hidden_states(mesh, hs)
        out[name] = {"launches": launches, "ms": ms, "frames": frames,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "lens_equal": torch.equal(h_lens, want_lens),
                     "cos": layer_cosines(whole, want, want_lens.tolist()),
                     "max_abs": float((whole.float() - want.float()).abs().max())}
        del up, want, hs, whole
        torch.cuda.empty_cache()
    return out


def parallel_rank(tmp):
    """Phase 18's cases on this rank (module docstring)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from s3prl_tpu_torch import hub

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"dp": par_dp(hub, tmp), "tp": par_tp(hub), "sp": par_sp(hub)}


def parallel_phase(smi):
    """Phase 18: two ranks sharing the one card over gloo (NCCL refuses two
    ranks on one device; the gloo collectives stage CUDA tensors through
    host memory), spawned with a ``file://`` store, each case checked on
    every rank against one process on the card; then the multichip dry run
    through its entry point, which spawns its own ranks. A rank's exception
    or a mismatch ends the run. The times are of two ranks sharing one
    card, not scaling figures."""
    import tempfile

    from s3prl_tpu_torch.parallel import dryrun
    from s3prl_tpu_torch.parallel.distributed import spawn

    label = f"two ranks sharing one card ({smi})"
    with tempfile.TemporaryDirectory() as tmp:
        (ranks, spawn_ms) = par_timed(lambda: spawn(parallel_rank, 2, tmp, backend="gloo"))
    log(f"[parallel] spawn and cases (a)-(c): {spawn_ms:.0f} ms, {label}")
    dry, dry_ms = par_timed(lambda: dryrun.dryrun_multichip(2))
    want, _ = dryrun.run(1, "cuda", B=2)
    int8_step = {"conv0_ln_gelu": 1, "fused_attention_block": 24, "fused_int8_ffn": 24}
    for r, out in enumerate(ranks):
        dp = out["dp"]
        log(f"[parallel a] rank {r} dp=2 HuBERT-Large int8 probe, global B=8 x "
            f"{PAR_SECS['dp']} s: losses {dp['losses']} (one process {dp['want']}; its first "
            f"with one B=8 upstream forward {dp['natural']}), probe "
            f"max abs {dp['max_abs']:.2e}, ms a step {[round(m, 1) for m in dp['ms']]}, peak "
            f"{dp['peak_gib']:.2f} GiB, launches a step {dp['launches'][-1]}; {label}")
        np.testing.assert_allclose(dp["losses"], dp["want"], rtol=1e-4)
        np.testing.assert_allclose(dp["natural"], dp["want"][0], rtol=1e-2)
        check(dp["max_abs"] <= 5e-4, f"rank {r} dp probe weights {dp['max_abs']}")
        check(all(n == int8_step for n in dp["launches"]), f"rank {r} dp launches")
        for name, kernel in (("hubert_large_ll60k", "fused_qkv_attention"),
                             ("wavlm_large", "gated_bias_attention")):
            tp = out["tp"][name]
            log(f"[parallel b] rank {r} tp=2 {name} bf16 flash B=4 x {PAR_SECS['tp']} s: "
                f"min layer cos {min(tp['cos']):.5f} vs tp=1, {tp['ms']:.1f} ms a forward, "
                f"peak {tp['peak_gib']:.2f} GiB, launches {tp['launches']}; {label}")
            check(tp["lens_equal"] and min(tp["cos"]) >= COS_LAYER, f"rank {r} tp {name}")
            check(tp["launches"] == {"conv0_ln_gelu": 1, kernel: 24},
                  f"rank {r} tp {name} launches {tp['launches']}")
        for name in ("hubert_large_ll60k", "hubert_base"):
            sp = out["sp"][name]
            log(f"[parallel c] rank {r} sp=2 {name} B=2 x {PAR_SECS['sp']} s: {sp['frames']} "
                f"frames on this rank, min layer cos {min(sp['cos']):.6f}, max abs "
                f"{sp['max_abs']:.2e} vs one process, {sp['ms']:.1f} ms, peak "
                f"{sp['peak_gib']:.2f} GiB, launches {sp['launches']}; {label}")
            check(sp["lens_equal"], f"rank {r} sp {name} lengths")
            if name == "hubert_base":
                check(sp["max_abs"] <= 1e-3 and sp["launches"] == {}, f"rank {r} sp {name}")
            else:
                check(min(sp["cos"]) >= COS_LAYER and sp["launches"] == {"conv0_ln_gelu": 1},
                      f"rank {r} sp {name}")
    for r, (loss, _) in enumerate(dry):
        log(f"[parallel d] rank {r} dryrun_multichip(2), dp=1 tp=2: loss {loss} (one process "
            f"{want}); {dry_ms:.0f} ms for the call, spawn and the model's build included; "
            f"{label}")
        check(np.isfinite(loss), "dry run loss")
        np.testing.assert_allclose(loss, want, rtol=1e-4)


ALL_PHASES = frozenset(range(3, 19))
KERNEL_PHASES = frozenset(range(3, 7))


def parse_phases(argv):
    """``--phases 7,12`` -> the phases to run beside 1 and 2 (any of 3-6
    runs the four: they share their models); every phase by default."""
    import argparse

    parser = argparse.ArgumentParser(description="On-card check of s3prl_tpu_torch.")
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases among 3-18 (default: all); phases 1 "
                             "and 2 always run, and a partial run prints no result line")
    args = parser.parse_args(argv)
    if args.phases is None:
        return ALL_PHASES
    phases = {int(p) for p in args.phases.split(",")}
    if not phases <= ALL_PHASES:
        parser.error(f"--phases {args.phases}: phases 3-18")
    return frozenset(phases | (KERNEL_PHASES if phases & KERNEL_PHASES else set()))


def main():
    phases = parse_phases(sys.argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from s3prl_tpu_torch import hub
    from s3prl_tpu_torch.kernels import _build, wrappers
    from s3prl_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    wrapper = {w.__name__: w for w in wrappers()}
    check(sorted(wrapper) == sorted(KERNELS), f"wrappers {sorted(wrapper)}")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")

    # 2. build
    with Phase("2 build"):
        lib = _build.library()
        log(f"[build] {lib._name}")
        build_report(lib)

    gen = torch.Generator().manual_seed(0)
    if KERNEL_PHASES & phases:  # 3-6 share their models and fill the kernels line
        # 3. kernel vs plain at main-path shapes
        from s3prl_tpu_torch.kernels import _common as kc
        from s3prl_tpu_torch.ops.quant import int_mm

        max_err = {}
        with Phase("3 kernels vs plain"):
            inp = kernel_inputs(4, 499, gen, dev)
            inp_base = kernel_inputs(4, 499, gen, dev, C=768, F=3072, H=12)
            inp_long = long_inputs(4, 1499, gen, dev)
            inp8 = long_inputs(2, 2999, gen, dev)
            check_kernels(kernel_calls(inp, inp_base), max_err)
            check_projection_routes(inp, kernel_inputs(2, 499, gen, dev, C=1280, F=1280, H=20))
            check_panel_edges(gen, dev)
            check_kernels(long_kernel_calls(
                [inp_long, *(long_inputs(7, T, gen, dev, edges=True) for T in (65, 127))],
                [inp8, long_inputs(7, 2049, gen, dev, edges=True)]), max_err)
            check_k6_panel(long_inputs(8, 1499, gen, dev))
            check_kernels(gated_kernel_calls(
                [gated_inputs(4, 499, gen, dev), gated_inputs(4, 1499, gen, dev),
                 gated_inputs(4, 499, gen, dev, form="f32"),
                 *(gated_inputs(7, T, gen, dev, form=form, edges=True)
                   for T in (65, 127, 499) for form in ("bf16", "f32"))],
                [gated_inputs(2, 2999, gen, dev), gated_inputs(2, 2999, gen, dev, form="f32"),
                 gated_inputs(7, 2049, gen, dev, edges=True),
                 gated_inputs(7, 65, gen, dev, form="f32", edges=True)]), max_err)
            inp11 = [k11_inputs(4, 499, gen, dev), k11_inputs(4, 1499, gen, dev),
                     k11_inputs(4, 499, gen, dev, form="f32"),
                     *(k11_inputs(7, T, gen, dev, edges=True) for T in (65, 127, 499))]
            check_kernels(k11_calls(inp11), max_err)
            for what, share in code_mismatch(inp, inp_long, inp11[0]).items():
                log(f"[int8 codes] {what}: {share:.3e} of codes differ from the plain version's")
            x8 = kc.quant_rows(inp["x"].view(-1, 1024), ln=inp["ln"])[0]
            for w8, lo, hi in ((inp["wq8"][0], 0, 1024), (inp["w28"][0], 0, 2048),
                               (inp["w28"][0], 2048, 4096)):
                a8 = kc.quant_rows(torch.randn(x8.shape[0], 4096, generator=gen).to(dev))[0] \
                    if hi > 1024 else x8
                got = kc.gemm_s8(a8[:, lo:hi], w8[:, lo:hi])
                check(torch.equal(got, int_mm(a8[:, lo:hi].contiguous(),
                                              w8[:, lo:hi].contiguous())),
                      f"gemm_s8 [{a8.shape[0]}, {hi - lo}] x [{w8.shape[0]}, {hi - lo}] "
                      "vs torch._int_mm")
            log("[kernel] gemm_s8 alone equals torch._int_mm exactly (QKV, fc2 chunks 1 and 2)")
            check_gemm_s8_edges(gen, dev)
            check_gemm_bf16_edges(gen, dev)
            ties = torch.tensor([[127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5] * 128], device=dev)
            q, s = kc.quant_rows(ties)
            check(float(s[0]) == 1.0 and torch.equal(q[0], torch.round(ties[0]).to(torch.int8)),
                  f"quantizer ties: {q[0, :8].tolist()}")
            log(f"[kernel] quant_rows rounds ties half to even: {q[0, :8].tolist()}")
            del inp, inp_base, inp_long, inp8, inp11
            inp_fe = frontend_inputs(2, gen, dev, layers=(0, 4))  # layer 1 (k=3), layer 5 (k=2)
            check_kernels(frontend_calls(inp_fe), max_err)
            check_q8_kernels(frontend_q8_calls(inp_fe), max_err)
            del inp_fe
            inp16 = [posconv_inputs(4, 499, gen, dev), posconv_inputs(4, 1499, gen, dev),
                     posconv_inputs(3, 257, gen, dev)]
            check_kernels(posconv_calls(inp16), max_err)
            check_posconv_codes(inp16)
            check_kernels(k17_calls([gated_inputs(4, 499, gen, dev),
                                     *(gated_inputs(7, T, gen, dev, edges=True) for T in (65, 127))]),
                          max_err)
            del inp16
            check_kernels(base_kernel_calls(gen, dev)[0], max_err)
            check_kernels(base_kernel_calls(gen, dev, C=1024, F=4096, H=16, gated=False)[0],
                          max_err)
            check_kernels(zero_kv_calls(gen, dev), max_err)

        # 4. the main paths at full width, int8 (the serving default) then bf16,
        # HuBERT-Large then WavLM-Large, then the options, then the Base models,
        # then wav2vec2-Large, data2vec-Large and UniSpeech-SAT Base; then the
        # fused weighted sum and a checkpoint loaded back
        with Phase("4 loads (the models of phases 4-6, four at a time)"):
            ups = load_all(hub, dev)
        launches = {}
        with Phase("4 main paths"):
            for run, expected in RUNS.items():
                model, path, length = run
                lens = LENS[length]
                wavs, lens_t = batch(lens, max(lens), gen, dev)
                for w in wrapper.values():
                    w.launches = 0
                hs, h_lens = ups[model, path].apply_standardized(wavs, lens_t)
                torch.cuda.synchronize()
                launches[run] = {name: w.launches for name, w in wrapper.items()}
                frames = (max(lens) - 1) // 320 + 1
                up = ups[model, path]
                log(f"[slice {model} {path} {length}] hs {tuple(hs.shape)} {hs.dtype}, "
                    f"h_lens {h_lens.tolist()}, launches {launches[run]}")
                check(tuple(hs.shape) == (up.num_layers, len(lens), frames, up.hidden_size),
                      f"hs shape {tuple(hs.shape)}")
                check(h_lens.tolist() == [(n - 1) // 320 + 1 for n in lens],
                      f"h_lens {h_lens.tolist()}")
                check(bool(torch.isfinite(hs).all()), "non-finite hidden states")
                check(launches[run] == {name: expected.get(name, 0) for name in wrapper},
                      f"{model} {path} {length} launch counts {launches[run]}")
                del hs, wavs
            check_weighted(ups["hubert", "int8"], wrapper, gen, dev)
            check_checkpoint(hub, ups["wav2vec2", "int8"], gen, dev)

        # 5. the same seed's models on the CPU (plain versions) vs the card; the
        # CPU model takes the kernel route, whose wrappers run their plain
        # versions there. Then the JAX package's quality gates against f32.
        import s3prl_tpu_torch.models.transformer as port_transformer

        from s3prl_tpu_torch.kernels import posconv as pc

        short, long_ = ("B=2 x 1.5 s", [24000, 15000]), [48000, 30000]
        # the conv-rule models' batches hold a 1-sample utterance (no frame: kv_len 0)
        zshort, zlong = ("B=3 x 1.5 s with 1 sample", [24000, 15000, 1]), [48000, 30000, 1]
        mbt, mkt, mpt = {"MAX_BLOCK_T": 64}, {"MAX_KERNEL_T": 128}, {"MAX_POSCONV_T": 64}
        holder = {"MAX_BLOCK_T": fa, "MAX_KERNEL_T": fa, "MAX_POSCONV_T": pc}  # threshold -> module
        # (model, path) -> (label, lengths, patched thresholds, {kernel: launches} checked)
        cases = {
            ("hubert", "int8"): (
                (*short, {}, {}),
                ("B=2 x 3 s, MAX_BLOCK_T=64", long_, mbt, {"fused_qkv_attention_outproj": 24}),
                ("B=2 x 3 s, MAX_BLOCK_T=64, MAX_KERNEL_T=128", long_, {**mbt, **mkt},
                 {"online_flash_attention": 24})),
            ("hubert", "bf16"): (
                (*short, {}, {}),
                ("B=2 x 3 s, MAX_BLOCK_T=64", long_, mbt, {"fused_qkv_attention": 24}),
                ("B=2 x 3 s, MAX_BLOCK_T=64, MAX_KERNEL_T=128", long_, {**mbt, **mkt},
                 {"online_flash_attention": 24})),
            **{("wavlm", path): (
                (*short, {}, {"gated_bias_attention": 24}),
                ("B=2 x 3 s, MAX_KERNEL_T=128", long_, mkt, {"gated_online_flash_attention": 24}))
               for path in ("int8", "bf16")},
            ("hubert", "int8 full_fuse"): (
                (*short, {}, {"fused_int8_linear": 48, "fused_qkv_attention": 24}),
                ("B=2 x 3 s, MAX_KERNEL_T=128", long_, mkt,
                 {"fused_int8_linear": 48, "online_flash_attention": 24})),
            ("hubert", "int8 qkv_fuse"): (
                ("B=2 x 3 s, MAX_BLOCK_T=64", long_, mbt,
                 {"fused_int8_linear": 24, "fused_qkv_attention_outproj": 24}),),
            ("wavlm", "int8 wavlm_fuse"): (
                (*short, {}, {"gated_bias_attention_outproj": 24}),
                ("B=2 x 3 s, MAX_KERNEL_T=128", long_, mkt,
                 {"gated_online_flash_attention": 24, "gated_bias_attention_outproj": 0})),
            ("hubert", "int8 int8_conv"): (
                (*short, {}, {"conv0_ln_gelu_q8": 1, "fused_int8_conv_ln_gelu": 6,
                              "conv0_ln_gelu": 0}),),
            ("hubert", "bf16 fused_conv"): ((*short, {}, {"conv0_ln_gelu": 1,
                                                          "fused_conv_ln_gelu": 6}),),
            ("hubert", "int8 fused_midln"): ((*short, {}, {"conv0_ln_gelu": 1, "ln_gelu": 6}),),
            ("wavlm", "bf16 fused_conv"): ((*short, {}, {"conv0_ln_gelu": 1,
                                                         "fused_conv_ln_gelu": 6}),),
            **{("hubert", path): ((*short, {}, {name: 1}),
                                  ("B=2 x 1.5 s, MAX_POSCONV_T=64", short[1], mpt, {name: 0}))
               for path, name in (("bf16 fused_posconv", "pos_conv_gelu"),
                                  ("int8 int8_posconv", "pos_conv_gelu_q8"))},
            **{("hubert_base", path): (
                (*short, {}, {block: 12, ffn: 12, "conv0_ln_gelu": 0}),
                ("B=2 x 3 s, MAX_BLOCK_T=64", long_, mbt, {split: 12, ffn: 12}))
               for path, block, split, ffn in (
                   ("int8", "fused_attention_block", "fused_qkv_attention_outproj",
                    "fused_int8_ffn"),
                   ("bf16", "fused_attention_block_bf16", "fused_qkv_attention", "fused_bf16_ffn"))},
            **{("wavlm_base", path): ((*short, {}, {"gated_bias_attention": 12}),)
               for path in ("int8", "bf16")},
            ("wavlm_base", "int8 wavlm_fuse"): ((*short, {}, {"gated_bias_attention_outproj": 12}),),
            # (their K8 case, HuBERT's route, was cut in PR 24 for phase 13's time)
            **{(model, path): (
                (*zshort, {}, {"conv0_ln_gelu": 1, block: 24, ffn: 24}),
                ("B=3 x 3 s with 1 sample, MAX_BLOCK_T=64", zlong, mbt, {split: 24, ffn: 24}))
               for model in ("wav2vec2", "data2vec") for path, block, split, ffn in (
                   ("int8", "fused_attention_block", "fused_qkv_attention_outproj",
                    "fused_int8_ffn"),
                   ("bf16", "fused_attention_block_bf16", "fused_qkv_attention", "fused_bf16_ffn"))},
            **{("unispeech_sat", path): ((*short, {}, {"gated_bias_attention": 12}),)
               for path in ("int8", "bf16")},
        }
        options = {"hubert": ("int8 full_fuse", "int8 qkv_fuse", "int8 int8_conv", "int8 fused_midln",
                              "int8 int8_posconv"),
                   "wavlm": ("int8 wavlm_fuse", "bf16 fused_conv"), "wav2vec2": (), "data2vec": ()}
        # HuBERT's bf16 paths (and the other pre-/post-LN Large trunks'): 30 s
        long_only = {"hubert": ("bf16 fused_conv", "bf16 fused_posconv"), "wavlm": (),
                     "wav2vec2": (), "data2vec": ()}
        quality = {  # model -> (label, lengths, paths gated against f32)
            model: (("B=2 x 0.5 s", [8000, 6400],
                     ("int8", "bf16")[:1 if model != "wavlm" else 2] + options[model]),
                    ("B=2 x 30 s", [480000, 400000], ("int8", "bf16") + options[model]
                     + long_only[model]),
                    ("B=1 x 60 s", [960000], ("int8", "bf16")))[:3 if model in BENCH_MODELS else 2]
            for model in ("hubert", "wavlm", "wav2vec2", "data2vec")}
        # the Base models: the JAX gates (tests/test_quant.py:553-591) on its batch and at 30 s
        quality.update({model: tuple((label, lens, ("int8", "bf16") + extra) for label, lens in (
            ("B=2 x 0.5 s", [8000, 6400]), ("B=2 x 30 s", [480000, 400000])))
            for model, extra in (("hubert_base", ()), ("wavlm_base", ("int8 wavlm_fuse",)),
                                 ("unispeech_sat", ()))})
        available = port_transformer._fused_block_available
        with Phase("5 card vs CPU, quality vs f32"):
            for (model, path), up in ups.items():
                up_cpu, up_ref = on_cpu(up), None
                for label, lens, patch, expected in cases[model, path]:
                    small, small_lens = batch(lens, max(lens), gen, "cpu")
                    saved = {name: getattr(holder[name], name) for name in patch}
                    try:
                        for name, value in patch.items():
                            setattr(holder[name], name, value)
                        port_transformer._fused_block_available = lambda x: True
                        hs_cpu, hl_cpu = up_cpu.apply_standardized(small, small_lens)
                        port_transformer._fused_block_available = available
                        for w in wrapper.values():
                            w.launches = 0
                        hs_gpu, hl_gpu = up.apply_standardized(small.to(dev), small_lens.to(dev))
                        torch.cuda.synchronize()
                    finally:
                        port_transformer._fused_block_available = available
                        for name, value in saved.items():
                            setattr(holder[name], name, value)
                    for name, count in expected.items():
                        launched = wrapper[name].launches
                        check(launched == count, f"{model} {path} {label}: {name} launched "
                              f"{launched} times, not {count}")
                    check(hl_cpu.tolist() == hl_gpu.tolist(), "h_lens CPU vs card")
                    coss = layer_cosines(hs_gpu.cpu(), hs_cpu, hl_cpu.tolist())
                    log(f"[cpu-vs-card {model} {path} {label}] per-layer cosine min "
                        f"{min(coss):.6f}: " + " ".join(f"{c:.5f}" for c in coss))
                    if (model, path) in DRIFT_PATHS:
                        if up_ref is None:
                            up_ref = hub.load(MODELS[model], device="cpu", seed=0)
                        hs_ref, _ = up_ref.apply_standardized(small, small_lens)
                        check_drift(hs_gpu.cpu(), hs_cpu, hs_ref, hl_cpu.tolist(),
                                    f"{model} {path} {label}, card and CPU vs the CPU's f32")
                    else:
                        check(min(coss) > COS_LAYER,
                              f"per-layer cosine CPU vs card ({model} {path}, {label})")
                    del hs_cpu, hs_gpu
                del up_cpu, up_ref
            cpu_models = {}
            for model, entry in MODELS.items():
                up_f32 = hub.load(entry, dtype=torch.float32, flash=False, device=dev, seed=0)
                for label, lens, paths in quality[model]:
                    wavs, lens_t = batch(lens, max(lens), gen, dev)
                    hs_f, hl = up_f32.apply_standardized(wavs, lens_t)
                    for path in paths:
                        hs_q, _ = ups[model, path].apply_standardized(wavs, lens_t)
                        coss = layer_cosines(hs_q.float(), hs_f, hl.tolist())
                        log(f"[{model} {path}-vs-f32 {label}] {len(coss) - 1}L per-layer cosine min "
                            f"{min(coss):.6f}: " + " ".join(f"{c:.5f}" for c in coss))
                        if (model, path) in DRIFT_PATHS:  # the CPU's plain versions on this batch
                            if (model, path) not in cpu_models:
                                cpu_models[model, path] = on_cpu(ups[model, path])
                            port_transformer._fused_block_available = lambda x: True
                            try:
                                hs_cpu, _ = cpu_models[model, path].apply_standardized(
                                    wavs.cpu(), lens_t.cpu())
                            finally:
                                port_transformer._fused_block_available = available
                            check_drift(hs_q.cpu(), hs_cpu, hs_f.cpu(), hl.tolist(),
                                        f"{model} {path} {label}, card and CPU vs the card's f32")
                            del hs_cpu
                        else:
                            check(min(coss) > COS_F32[path.split()[0]],
                                  f"per-layer cosine {model} {path} vs f32 ({label})")
                        del hs_q
                    del hs_f
                del up_f32
            del cpu_models

        # 6. timing: both paths on each main-path batch, then each kernel vs its plain version
        with Phase("6 timing"):
            it_lo, it_hi = 5, 15
            forward_ms = {}  # (model, path) -> ms a forward at B=32 x 10 s
            for label, B, secs in (("10 s", 32, 10.0), ("30 s", 8, 30.0), ("60 s", 4, 60.0)):
                wavs, lens_t = batch([int(secs * SR)] * B, int(secs * SR), gen, dev)
                for (model, path), up in ups.items():
                    if label not in timed_lengths(model, path):
                        continue
                    torch.cuda.reset_peak_memory_stats()
                    best = {it: min(it * cuda_ms(lambda: up.apply_standardized(wavs, lens_t), it)
                                    for _ in range(timing_reps(model, path)))
                            for it in (it_lo, it_hi)}
                    per_iter = (best[it_hi] - best[it_lo]) / (it_hi - it_lo)
                    if label == "10 s":
                        forward_ms[model, path] = per_iter
                    rate = B * secs / (per_iter / 1e3)
                    log(f"[timing] slice {model} {path} B={B} x {secs:.0f} s: "
                        f"{per_iter:.2f} ms/forward, "
                        f"{rate:.1f} audio-s/s (chains {it_lo}: {best[it_lo]:.1f} ms, "
                        f"{it_hi}: {best[it_hi]:.1f} ms), peak device memory "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
                if label == "10 s":  # each path's feature extractor alone, in turns
                    fe_paths = [(key, up) for key, up in ups.items() if key[1] in FRONT_END_PATHS]
                    fe_ms = {key: [] for key, _ in fe_paths}
                    with torch.inference_mode():
                        for key, up in fe_paths + fe_paths[::-1]:
                            fe_ms[key].append(cuda_ms(lambda: up.model.feature_extractor(wavs), 5))
                    for (model, path), t in fe_ms.items():
                        ms = sum(t) / len(t)
                        log(f"[timing] front end {model} {path} B={B} x {secs:.0f} s: "
                            f"{ms:.3f} ms (runs {t[0]:.3f}, {t[1]:.3f}), "
                            f"{100 * ms / forward_ms[model, path]:.1f}% of the forward's "
                            f"{forward_ms[model, path]:.2f} ms")
                if label == "10 s":  # the fused weighted sum beside apply_standardized
                    time_weighted(ups["hubert", "int8"], wavs, lens_t, gen, it_lo, it_hi)
                del wavs
            del ups, up

            log("[timing] plain versions run stock PyTorch on the card: f32 cuBLAS GEMMs (TF32 "
                "off) for the bf16 blocks and attention, torch._int_mm (cuBLASLt int8) plus f32 "
                "elementwise passes for the int8 blocks")
            entries = {}
            inp = kernel_inputs(32, 499, gen, dev)
            calls = kernel_calls(inp)
            inputs = {name: inp for name in calls}
            time_kernels({"conv0_ln_gelu": calls.pop("conv0_ln_gelu")}, inputs, "B=32", entries,
                         launches, max_err, first_only=False)
            time_kernels({"fused_int8_linear": calls.pop("fused_int8_linear")}, inputs, "B=32",
                         entries, launches, max_err, first_only=False)
            time_kernels(calls, inputs, "B=32", entries, launches, max_err)
            inp11 = k11_inputs(32, 499, gen, dev)
            time_kernels(k11_calls([inp11]), {"gated_bias_attention_outproj": inp11}, "B=32",
                         entries, launches, max_err)
            inp11_f32 = k11_inputs(32, 499, gen, dev, form="f32")
            time_kernels(k11_calls([inp11_f32]), {"gated_bias_attention_outproj": inp11_f32},
                         "B=32 (unpadded f32 bias)", {}, launches, max_err)
            del inp11_f32
            for name, pairs in split_pairs(inp, inp11).items():
                for what, fn in pairs:
                    t = (cuda_ms(fn, 10) + cuda_ms(fn, 10)) / 2
                    log(f"[timing] {name} split pair it replaces B=32, {what}: {t:.3f} ms")
            for what_k, stage_fn in (("fused_int8_ffn (K2) stages B=32 x 499, F=4096", k2_stages),
                                     ("fused_attention_block (K1) stages B=32 x 499", k1_stages),
                                     ("fused_int8_linear (K12) launches B=32 x 499", k12_stages)):
                stages = [(what, (cuda_ms(fn, 10) + cuda_ms(fn, 10)) / 2)
                          for what, fn in stage_fn(inp)]
                total = "" if stage_fn is k12_stages else \
                    f"; sum {sum(ms for _, ms in stages):.4f} ms"
                log(f"[timing] {what_k}: " + ", ".join(f"{what} {ms:.4f} ms" for what, ms in stages)
                    + total)
            time_gemm_s8(gen, dev)
            time_gemm_bf16(gen, dev)
            del inp, calls, inputs, inp11
            inp_long, inp8 = long_inputs(8, 1499, gen, dev), long_inputs(4, 2999, gen, dev)
            inputs = {"fused_qkv_attention_outproj": inp_long, "fused_qkv_attention": inp_long,
                      "online_flash_attention": inp8}
            time_kernels(long_kernel_calls([inp_long], [inp8]), inputs, "(30 s: B=8; 60 s: B=4)",
                         entries, launches, max_err)
            time_attention_core([long_inputs(32, 499, gen, dev), inp_long])
            del inp_long, inp8, inputs
            for form in ("bf16", "f32"):  # the main path's padded bf16 bias first: the kernels line
                inp9, inp10 = (gated_inputs(32, 499, gen, dev, form=form),
                               gated_inputs(4, 2999, gen, dev, form=form))
                time_kernels(gated_kernel_calls([inp9], [inp10]),
                             {"gated_bias_attention": inp9, "gated_online_flash_attention": inp10},
                             f"(10 s: B=32; 60 s: B=4; {form} bias)",
                             entries if form == "bf16" else {}, launches, max_err)
                del inp9, inp10
            inp_fe = frontend_inputs(32, gen, dev)
            check_int8_conv_bits(inp_fe)
            time_frontend(inp_fe, entries, launches, max_err)
            del inp_fe
            inp16 = posconv_inputs(32, 499, gen, dev)
            time_kernels(posconv_calls([inp16]), {"pos_conv_gelu": inp16, "pos_conv_gelu_q8": inp16},
                         "B=32", entries, launches, max_err)
            x, w, b = inp16["x"], inp16["w"].to(torch.bfloat16), inp16["bias"].to(torch.bfloat16)

            def stock_posconv():  # ConvPositionalEmbedding's stock path
                y = torch.nn.functional.conv1d(x.transpose(1, 2), w, b, padding=w.shape[-1] // 2,
                                               groups=inp16["G"])
                return torch.nn.functional.gelu(y[..., :-1]).transpose(1, 2)

            t = (cuda_ms(stock_posconv, 10) + cuda_ms(stock_posconv, 10)) / 2
            log(f"[timing] pos-conv stock path it replaces B=32 x 499, grouped F.conv1d + bias + "
                f"GELU: {t:.3f} ms")
            for what, fn in (("posconv_quant alone (scales and codes)",
                              lambda: pc.posconv_quant(x, inp16["G"])),
                             ("its scale pass alone (in K16b's launch)",
                              lambda: pc._quant_launch(x, inp16["G"], codes=False))):
                t = (cuda_ms(fn, 10) + cuda_ms(fn, 10)) / 2
                log(f"[timing] K16b quantizer B=32 x 499 bf16, {what}: {t:.4f} ms")
            del inp16, x, w, b
            inp17 = gated_inputs(32, 499, gen, dev)
            time_kernels(k17_calls([inp17]), {"flash_attention": inp17}, "B=32", entries, launches,
                         max_err)
            del inp17
            time_base_kernels(*base_kernel_calls(gen, dev))
            time_base_kernels(*base_kernel_calls(gen, dev, C=1024, F=4096, H=16, gated=False))
    # 7. SUPERB's frozen-upstream probe training at full width: the Trainer's
    # steps, one step against the CPU, the step's rate, a whole recipe
    if 7 in phases:
        with Phase("7 probe training"):
            probe_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 8. SUPERB ASR: the BLSTM-CTC probe's steps, one against the CPU, the
    # CTC edge rows, the step's rate, decoding, the SuperbASR recipe on FLAC
    if 8 in phases:
        with Phase("8 asr"):
            asr_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 9. SUPERB's speaker tasks: ASV, GE2E and SD steps, one update of each
    # against the CPU, their rates, the SuperbASV, segment-eval and SuperbSD
    # recipes
    if 9 in phases:
        with Phase("9 speaker"):
            speaker_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 10. SUPERB's frame probes, QbE, HEAR and MOS: QbE's extraction and DTW
    # against the CPU, a step of each head, one update of each against the
    # CPU, their rates, the Example recipes and a HEAR k-fold recipe
    if 10 in phases:
        with Phase("10 recipes"):
            recipes_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 11. the baseline front ends and SUPERB-SG's SE, SS and ST: the six
    # entries against the CPU, the STFT round trip, a step of each head, one
    # update of each against the CPU, their rates, ST's greedy decoding,
    # SeExample and StExample
    if 11 in phases:
        with Phase("11 sg recipes"):
            sg_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 12. SUPERB's SLU recipes and the mel-domain upstreams: the nine models
    # behind the ten new names against the CPU with their rates, the SLU and
    # MOSEI steps (launches, one update against the CPU, their rates) and
    # SluExample
    if 12 in phases:
        with Phase("12 slu and mel upstreams"):
            slu_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 13. the upstream in train mode with its dropouts (K7 / K9 inside a train
    # step) against the CPU and timed beside the frozen step; VcVcc2020 at
    # full width with its Griffin-Lim waves
    if 13 in phases:
        with Phase("13 train mode and vc"):
            train_mode_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 14. the rest of the wav2vec2-style zoo: the Conformers (K3), ESPnet
    # HuBERT-Large bf16 + flash (K3, K4, K5), DistilHuBERT, LightHuBERT (K3) and
    # MR-HuBERT at full width with their launches, times and the CPU check
    if 14 in phases:
        with Phase("14 zoo trunks"):
            zoo_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 15. the conv, recurrent and windowed families (wav2vec 1.0, vq-wav2vec,
    # CPC, DeCoAR 1 / 2, BYOL-A / BYOL-S) and the small front ends at full
    # width: no kernel launched, their times and the CPU check
    if 15 in phases:
        with Phase("15 conv, recurrent and windowed zoo"):
            zoo2_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 16. the rest of the hub: the AST family, PaSST, VGGish, the vq-wav2vec
    # RoBERTa pipeline, PASE+, SpecAugment, hf_wav2vec2 (K3) and a swish trunk
    # (no fused block or FFN kernel) at full width with their times and the
    # CPU check
    if 16 in phases:
        with Phase("16 rest of the zoo"):
            zoo3_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 17. SSL pretraining: every recipe's steps at its published width (K3 in
    # data2vec's teacher), one update of each against the CPU, prepare_units,
    # a whole PretrainData2Vec run loaded back through the hub
    if 17 in phases:
        with Phase("17 pretraining"):
            pretrain_phase(wrapper, gen, dev, smi.splitlines()[0])
    # 18. parallelism: dp, tp and sp on two ranks sharing the card, each
    # against one process, and the multichip dry run
    if 18 in phases:
        with Phase("18 parallel (two ranks sharing one card)"):
            parallel_phase(smi.splitlines()[0])
    if phases != ALL_PHASES:
        log(f"partial run: phases 1, 2 and {sorted(phases)} (the kernels line and the result "
            "line come from a run of every phase)")
        return
    log(json.dumps({"kernels": [entries[name] for name in wrapper]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
