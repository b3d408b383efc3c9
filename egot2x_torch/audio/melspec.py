"""The ResNetSE audio frontend: log-mel spectrogram and instance norm.

The port's own copy of ``egot2x/audio/melspec.py``, which replaces the
reference's ``torchaudio.transforms.MelSpectrogram`` in ``ResNetSE``
(HHI/models/ttm/resse.py:37-45, 99-105): pre-emphasis 0.97, sample rate
16 kHz, n_fft 512, window 400 (periodic Hamming, centred in the n_fft
frame), hop 160, centre padding by reflection, power 2, 64 HTK mel bands,
then ``log(x + 1e-6)`` and ``InstanceNorm1d`` over time. Everything runs
in the input's type (f32, as the JAX package computes it) on its device;
the filterbank is a numpy table made once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE = 16000
N_FFT = 512
WIN_LENGTH = 400
HOP_LENGTH = 160
N_MELS = 64


def hamming_window() -> np.ndarray:
    """The periodic Hamming window of ``WIN_LENGTH`` (torch.hamming_window
    semantics: it divides by N, not N - 1)."""
    n = np.arange(WIN_LENGTH, dtype=np.float64)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / WIN_LENGTH)).astype(
        np.float32)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank() -> np.ndarray:
    """(N_FFT // 2 + 1, N_MELS) triangular HTK-mel filterbank from 0 Hz to
    Nyquist (torchaudio ``MelScale``, norm None, mel_scale 'htk')."""
    n_freqs = N_FFT // 2 + 1
    all_freqs = np.linspace(0, SAMPLE_RATE // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(0.0), hz_to_mel_htk(SAMPLE_RATE / 2.0),
                        N_MELS + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def pre_emphasis(x: torch.Tensor) -> torch.Tensor:
    """x[t] - 0.97 x[t - 1], with x[-1] taken as x[1] (reflection)."""
    padded = torch.cat([x[..., 1:2], x], dim=-1)
    return padded[..., 1:] - 0.97 * padded[..., :-1]


def spectrogram_power(x: torch.Tensor) -> torch.Tensor:
    """|STFT|^2 with ``torch.stft``'s centre/reflect semantics:
    (..., samples) -> (..., N_FFT // 2 + 1, frames)."""
    lpad = (N_FFT - WIN_LENGTH) // 2
    window = np.pad(hamming_window(), (lpad, N_FFT - WIN_LENGTH - lpad))
    pad = N_FFT // 2
    x = torch.cat([x[..., 1:pad + 1].flip(-1), x,
                   x[..., -pad - 1:-1].flip(-1)], dim=-1)
    frames = x.unfold(-1, N_FFT, HOP_LENGTH) * torch.from_numpy(window).to(x)
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    return (spec.real ** 2 + spec.imag ** 2).transpose(-1, -2)


def melspectrogram(x: torch.Tensor) -> torch.Tensor:
    """Mel power spectrogram: (..., samples) -> (..., N_MELS, frames)."""
    power = spectrogram_power(x)
    fb = torch.from_numpy(mel_filterbank())
    return torch.einsum("...ft,fm->...mt", power, fb.to(power))


def instance_norm_1d(x: torch.Tensor) -> torch.Tensor:
    """InstanceNorm1d without affine (eps 1e-5): each (batch, channel) over
    time."""
    var, mean = torch.var_mean(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + 1e-5)


@torch.no_grad()
def resse_frontend(wave: torch.Tensor) -> torch.Tensor:
    """(B, samples) raw 16 kHz audio (float) -> (B, 64, frames)
    normalized log-mels in its type, outside autograd (the reference's
    ``no_grad`` block, the JAX package's ``stop_gradient``)."""
    x = melspectrogram(pre_emphasis(wave)) + 1e-6
    return instance_norm_1d(torch.log(x))
