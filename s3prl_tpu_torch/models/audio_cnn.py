"""VGGish (port of the VGGish half of s3prl_tpu/models/audio_cnn.py).

Google's VGG-style CNN over 0.96-s log-mel patches (s3prl/upstream/vggish):
64-bin `audio.log_mel` cut into 96-frame patches, four stages of 3 x 3
SAME convs (64; 128; 256, 256; 512, 512) with ReLU and a 2 x 2 max pool
each, then the embeddings 12,288 -> 4,096 -> 4,096 -> 128, each with ReLU:
one 128-wide state a patch, stride 96 x 160 samples. The modules keep the
reference's keys (torchvggish's ``features`` and ``embeddings``
Sequentials); the convolutions run in full f32 (TF32 off, `ieee_call`),
the flatten reads the pooled maps in (H, W, C) order as torchvggish and
the JAX package do.
"""

from __future__ import annotations

import types

import torch
import torch.nn as nn

from ..nn.heads import ieee_call
from ..ops import audio

PATCH_FRAMES, N_MELS = 96, 64
# (channels, convs) of the four stages (audio_cnn.py:29)
STAGES = ((64, 1), (128, 1), (256, 2), (512, 2))


class VGGish(nn.Module):
    """(wavs [B, T], wav_lens [B]) -> (embeddings [1, B, P, 128], lengths
    max(mel_lens // 96, 1)), P = max(T' // 96, 1) patches of the T'-frame
    log-mel (audio_cnn.py:53-62). A batch of fewer than 96 frames raises,
    as the JAX reshape does."""

    def __init__(self, device=None):
        super().__init__()
        self.cfg = types.SimpleNamespace()
        layers, c_in = [], 1
        for channels, convs in STAGES:
            for _ in range(convs):
                layers += [nn.Conv2d(c_in, channels, 3, padding=1, device=device), nn.ReLU()]
                c_in = channels
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        flat = c_in * (PATCH_FRAMES >> len(STAGES)) * (N_MELS >> len(STAGES))
        self.embeddings = nn.Sequential(
            nn.Linear(flat, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, 4096, device=device), nn.ReLU(),
            nn.Linear(4096, 128, device=device), nn.ReLU())

    def forward(self, wavs: torch.Tensor, wav_lens: torch.Tensor, generator=None):
        mel, mel_lens = audio.log_mel(wavs, wav_lens, n_mels=N_MELS)
        B, T, _ = mel.shape
        P = max(T // PATCH_FRAMES, 1)
        if T < P * PATCH_FRAMES:
            raise ValueError(f"vggish: {T} log-mel frames, fewer than one {PATCH_FRAMES}-frame "
                             "patch (the JAX package's reshape fails on this batch too)")
        x = mel[:, :P * PATCH_FRAMES].reshape(B * P, 1, PATCH_FRAMES, N_MELS)
        x = ieee_call(self.features, x, self.features.parameters())
        x = self.embeddings(x.permute(0, 2, 3, 1).reshape(B * P, -1))
        return x.reshape(1, B, P, -1), torch.clamp(mel_lens // PATCH_FRAMES, min=1)
