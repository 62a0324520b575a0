"""Audio featurization (port of ``gofr_tpu/ops/audio.py``): the
Whisper-style log-mel frontend on the device. 16 kHz PCM -> frames under
numpy's symmetric Hann window -> ``torch.fft.rfft`` power -> a triangular
mel filterbank (host numpy, a copy of the reference's) -> log10 with the
dynamic range clamped per row to 8 below its maximum."""

from __future__ import annotations

import math

import numpy as np
import torch


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int = 16000) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular filters (host-side constant)."""
    n_freqs = n_fft // 2 + 1
    fmin, fmax = 0.0, sample_rate / 2

    def hz_to_mel(f: float) -> float:
        return 2595.0 * math.log10(1.0 + f / 700.0)

    def mel_to_hz(m: np.ndarray) -> np.ndarray:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.floor((n_fft + 1) * hz_pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_freqs), np.float32)
    for m in range(1, n_mels + 1):
        left, center, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, center):
            if center > left:
                fb[m - 1, k] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fb[m - 1, k] = (right - k) / (right - center)
    return fb


def log_mel_spectrogram(
    audio: torch.Tensor,  # [B, n_samples] f32 in [-1, 1]
    *,
    n_fft: int = 400,
    hop: int = 160,
    n_mels: int = 80,
    sample_rate: int = 16000,
) -> torch.Tensor:
    """[B, n_frames, n_mels] f32 log-mel features on ``audio``'s device.
    A clip shorter than one window is zero-padded to one frame."""
    n = audio.shape[1]
    dev = audio.device
    audio = audio.float()
    if n < n_fft:
        audio = torch.nn.functional.pad(audio, (0, n_fft - n))
    frames = audio.unfold(-1, n_fft, hop)  # [B, n_frames, n_fft]
    window = torch.from_numpy(np.hanning(n_fft).astype(np.float32)).to(dev)
    power = torch.fft.rfft(frames * window, dim=-1).abs() ** 2
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(dev)
    mel = torch.einsum("btf,mf->btm", power, fb)
    logmel = torch.log10(torch.clamp_min(mel, 1e-10))
    logmel = torch.maximum(logmel, logmel.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logmel + 4.0) / 4.0
