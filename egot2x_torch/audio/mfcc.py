"""MFCC on the host, python_speech_features-compatible.

Counterpart of ``egot2x/audio/mfcc.py::mfcc_np`` and its helpers: the ASD
and TTM 2-loader datasets compute 13 MFCCs per track on the host with the
reference's fps-scaled window (winlen 0.025 * 25 / fps, winstep 0.010 *
25 / fps: 4 MFCC rows a video frame), as the reference calls
``python_speech_features.mfcc``. Numpy, in float64, cast to float32:
pre-emphasis 0.97, rectangular frames zero-padded at the tail, the power
spectrum of a 512-point rFFT over 512, 26 HTK-mel triangles with psf's
floor-binned edges, log, the orthonormal DCT-II, liftering 22, and c0
replaced by the log frame energy.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


@functools.lru_cache(maxsize=None)
def _psf_filterbank(nfilt: int, nfft: int, samplerate: int, lowfreq: float,
                    highfreq: float) -> np.ndarray:
    """(nfilt, nfft // 2 + 1) filterbank with psf's floor-binned
    triangles."""
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)
    mel2hz = lambda m: 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    melpoints = np.linspace(hz2mel(lowfreq), hz2mel(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel2hz(melpoints) / samplerate).astype(int)
    fbank = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct2_ortho_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) orthonormal DCT-II matrix (scipy.fftpack.dct,
    norm='ortho')."""
    k = np.arange(n_out)[None, :]
    n = np.arange(n_in)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2 * n + 1) / (2.0 * n_in))
    scale = np.where(k[0] == 0, np.sqrt(1.0 / (4.0 * n_in)),
                     np.sqrt(1.0 / (2.0 * n_in)))
    return (mat * scale[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lifter_coeffs(numcep: int, ceplifter: int) -> np.ndarray:
    n = np.arange(numcep)
    return (1.0 + (ceplifter / 2.0) * np.sin(np.pi * n / ceplifter)).astype(
        np.float32)


def mfcc_np(signal: np.ndarray, samplerate: int = 16000,
            winlen: float = 0.025, winstep: float = 0.01, numcep: int = 13,
            nfilt: int = 26, nfft: int = 512, ceplifter: int = 22,
            num_frames: Optional[int] = None) -> np.ndarray:
    """(frames, numcep) float32 MFCCs of a 1-D signal; ``num_frames``
    fixes the frame count (zero-padding or cutting the tail)."""
    signal = np.asarray(signal, dtype=np.float64)
    frame_len = _round_half_up(winlen * samplerate)
    frame_step = _round_half_up(winstep * samplerate)
    emph = np.concatenate([signal[:1], signal[1:] - 0.97 * signal[:-1]])
    n = len(emph)
    psf_frames = (1 if n <= frame_len
                  else 1 + int(math.ceil((n - frame_len) / frame_step)))
    out_frames = num_frames if num_frames is not None else psf_frames
    padlen = (out_frames - 1) * frame_step + frame_len
    if padlen > n:
        emph = np.concatenate([emph, np.zeros(padlen - n)])
    idx = (np.arange(out_frames)[:, None] * frame_step
           + np.arange(frame_len)[None, :])
    pspec = np.abs(np.fft.rfft(emph[idx], nfft)) ** 2 / nfft
    energy = pspec.sum(axis=1)
    energy = np.where(energy == 0, np.finfo(np.float32).eps, energy)
    fb = _psf_filterbank(nfilt, nfft, samplerate, 0.0,
                         samplerate / 2.0).astype(np.float64)
    feat = pspec @ fb.T
    feat = np.log(np.where(feat == 0, np.finfo(np.float32).eps, feat))
    feat = feat @ _dct2_ortho_matrix(nfilt, numcep).astype(np.float64)
    feat = feat * _lifter_coeffs(numcep, ceplifter).astype(np.float64)
    feat[:, 0] = np.log(energy)
    return feat.astype(np.float32)
