"""Analog-matched biquad EQ closed forms (Vicanek 2016/2024;
`dsptoolbox_tpu/filterbanks/matched_eq.py`): host numpy designs."""

from __future__ import annotations

import numpy as np


def _matched_eq_helpers(omega0: float, q: float):
    q = 1 / (2 * q)
    if q <= 1:
        a1 = -2 * np.exp(-q * omega0) * np.cos((1 - q**2) ** 0.5 * omega0)
    else:
        a1 = -2 * np.exp(-q * omega0) * np.cosh((q**2 - 1) ** 0.5 * omega0)
    a2 = np.exp(-2 * q * omega0)
    A = np.array([(1 + a1 + a2) ** 2, (1 - a1 + a2) ** 2, -4 * a2]).squeeze()
    sin_omega = np.sin(omega0 / 2) ** 2
    phi = np.array([1 - sin_omega, sin_omega, 0])
    phi[2] = 4 * phi[0] * phi[1]
    return np.array([1, a1, a2]), A, phi


def matched_peaking_eq(f, g_db, q, q_factor, fs):
    if q_factor is None:
        q_factor = np.max([np.abs(0.0868 * g_db + 1.264), 0.55])
    assert q_factor > 0, "Q-factor should be greater than 0"
    omega0 = 2 * np.pi * f / fs
    g = 10 ** (g_db / 20)
    q = q * q_factor
    a, A, phi = _matched_eq_helpers(omega0, q)
    R1 = g**2 * (A @ phi)
    R2 = g**2 * (-A[0] + A[1] + 4 * (phi[0] - phi[1]) * A[2])
    B0 = A[0]
    B2 = (R1 - R2 * phi[1] - B0) / (4 * phi[1] ** 2)
    B1 = R2 + B0 + 4 * (phi[1] - phi[0]) * B2
    W = 0.5 * (B0**0.5 + B1**0.5)
    b0 = 0.5 * (W + (W**2 + B2) ** 0.5)
    b1 = 0.5 * (B0**0.5 - B1**0.5)
    b2 = -B2 / (4 * b0)
    return np.array([b0, b1, b2]), a


def matched_lowpass_eq(f, g_db, q, fs):
    omega0 = 2 * np.pi * f / fs
    Q = q
    a, A, phi = _matched_eq_helpers(omega0, q)
    R1 = Q**2 * (A @ phi)
    B0 = A[0]
    B1 = (R1 - B0 * phi[0]) / phi[1]
    b0 = 0.5 * (np.sum(a) + B1**0.5)
    b1 = np.sum(a) - b0
    b2 = 0
    return np.array([b0, b1, b2]) * 10 ** (g_db / 20), a


def matched_highpass_eq(f, g_db, q, fs):
    omega0 = 2 * np.pi * f / fs
    Q = q
    a, A, phi = _matched_eq_helpers(omega0, q)
    b0 = (A @ phi) ** 0.5 / 4 / phi[1] * Q * 10 ** (g_db / 20)
    return np.array([b0, -2 * b0, b0]), a


def matched_bandpass_eq(f, g_db, q, fs):
    omega0 = 2 * np.pi * f / fs
    a, A, phi = _matched_eq_helpers(omega0, q)
    R1 = A @ phi
    R2 = -A[0] + A[1] + 4 * (phi[0] - phi[1]) * A[2]
    B2 = (R1 - R2 * phi[1]) / 4 / phi[1] ** 2
    B1 = R2 + 4 * (phi[1] - phi[0]) * B2
    b1 = -0.5 * B1**0.5
    b0 = 0.5 * ((B2 + b1**2) ** 0.5 - b1)
    b2 = -b0 - b1
    return np.array([b0, b1, b2]) * 10 ** (g_db / 20), a


def matched_shelving_eq(f, g_db, fs, lowshelf: bool):
    """Vicanek 2024 shelving filters with q fixed to sqrt(2)/2."""
    fc = f / (fs / 2)
    G = 10 ** (g_db / 20)
    if lowshelf:
        G = 1 / G
    if np.abs(1 - G) < 1e-6:
        G = 1 + 1e-6
    f1 = fc / (0.16 + 1.543 * fc**2) ** 0.5
    f2 = fc / (0.947 + 3.806 * fc**2) ** 0.5
    hny = (fc**4 + G) / (fc**4 + 1 / G)
    phi1 = np.sin(np.pi / 2 * f1) ** 2
    phi2 = np.sin(np.pi / 2 * f2) ** 2
    h1 = (fc**4 + f1**4 * G) / (fc**4 + f1**4 / G)
    h2 = (fc**4 + f2**4 * G) / (fc**4 + f2**4 / G)
    d1 = (h1 - 1) * (1 - phi1)
    c11 = -phi1 * d1
    c12 = (hny - h1) * phi1**2
    d2 = (h2 - 1) * (1 - phi2)
    c21 = -phi2 * d2
    c22 = (hny - h2) * phi2**2
    alpha1 = (c22 * d1 - c12 * d2) / (c11 * c22 - c12 * c21)
    alpha2 = (d1 - c11 * alpha1) / c12
    beta1 = alpha1
    beta2 = hny * alpha2
    A0, A1, A2 = 1, alpha2, 0.25 * (alpha1 - alpha2)
    B0, B1, B2 = 1, beta2, 0.25 * (beta1 - beta2)
    V = 0.5 * (A0**0.5 + A1**0.5)
    a0 = 0.5 * (V + (V**2 + A2) ** 0.5)
    a1 = 1 - V
    a2 = -0.25 * A2 / a0
    W = 0.5 * (B0**0.5 + B1**0.5)
    b0 = 0.5 * (W + (W**2 + B2) ** 0.5)
    b1 = 1 - W
    b2 = -0.25 * B2 / b0
    return (
        np.array([b0, b1, b2]) / (G if lowshelf else 1.0),
        np.array([a0, a1, a2]),
    )
