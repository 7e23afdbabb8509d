"""Plain reference of the filter-bank chain (config 3): the Linkwitz-Riley
crossover bands, the gammatone bands, the resampled signal and the
fractional-octave bands, each from its own design, in float64 with scipy
on the host.

The designs follow their published definitions, not the program's code:
Linkwitz-Riley crossovers as squared Butterworth sections with the later
crossovers' allpass sums on each lower band (upstream dsptoolbox's
``LRFilterBank``); Hohmann's (2002) 4th-order complex gammatone on the ERB
scale (eq. 13-16: a_gamma = π·(2n-2)!·2^-(2n-2) / ((n-1)!)², gain
2(1-|λ|)^4); IEC 61260-1 base-10 fractional-octave bands as Butterworth
band-passes between fc·10^(∓3/(20·b)); ``scipy.signal.resample_poly``.

Only a sample of the channels is compared (the recursions run at scipy's
speed): two channels from each quarter of the channels, drawn from the
seed, so that a fault that leaves out half of the channels is always seen.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction

import numpy as np
import torch
from scipy import signal as ss

ROWS_PER_QUARTER = 2


def _fs(config: dict) -> int:
    return int(config["sampling_rate_hz"])


def crossover_pairs(config: dict) -> list:
    """The Linkwitz-Riley crossovers, lowest first, as ``(lowpass,
    highpass)`` SOS pairs: each the Butterworth of half the order, twice."""
    fs = _fs(config)
    freqs = [float(f) for f in config["crossover"]["frequencies_hz"]]
    orders = [int(o) for o in config["crossover"]["orders"]]
    pairs = []
    for f, o in sorted(zip(freqs, orders)):
        if o % 4:
            raise ValueError("the crossover reference takes Linkwitz-Riley orders divisible by 4")
        lp = ss.butter(o // 2, f, "lowpass", fs=fs, output="sos")
        hp = ss.butter(o // 2, f, "highpass", fs=fs, output="sos")
        pairs.append((np.vstack([lp, lp]), np.vstack([hp, hp])))
    return pairs


def crossover(config: dict, x: np.ndarray) -> list:
    """The crossover's bands of ``x (rows, T)``, lowest first."""
    pairs = crossover_pairs(config)
    bands, rest = [], x
    for n, (lp, hp) in enumerate(pairs):
        band = ss.sosfilt(lp, rest, axis=-1)
        rest = ss.sosfilt(hp, rest, axis=-1)
        for lp2, hp2 in pairs[n + 1:]:
            band = ss.sosfilt(lp2, band, axis=-1) + ss.sosfilt(hp2, band, axis=-1)
        bands.append(band)
    bands.append(rest)
    return bands


def erb_frequencies(lo: float, hi: float, resolution: float, ref_hz: float = 1000.0) -> np.ndarray:
    """Centre frequencies spaced by ``resolution`` on the ERB-number scale
    through ``ref_hz`` (Hohmann 2002, eq. 16)."""
    def erb(f):
        return 9.2645 * math.copysign(1.0, f) * math.log(1 + abs(f) * 0.00437)

    e_ref = erb(ref_hz)
    n_lo = math.floor((e_ref - erb(lo)) / resolution)
    n_hi = math.floor((erb(hi) - e_ref) / resolution)
    e = np.arange(-n_lo, n_hi + 1) * resolution + e_ref
    return np.sign(e) * (np.exp(np.abs(e) / 9.2645) - 1) / 0.00437


def gammatone_poles(config: dict) -> tuple:
    """``(poles, gains)`` of the 4th-order complex gammatone bands
    (Hohmann 2002, eq. 13-14): λ·e^{iβ} with λ = exp(-2π b / fs), b =
    ERB(f) / a_gamma, β = 2π f / fs; gain 2(1 - |λ e^{iβ}|)^4."""
    fs = _fs(config)
    g = config["gammatone"]
    f = erb_frequencies(*map(float, g["frequency_range_hz"]), float(g["resolution"]))
    n = 4
    a_gamma = (math.pi * math.factorial(2 * n - 2) * 2.0 ** -(2 * n - 2)
               / math.factorial(n - 1) ** 2)
    b = (24.7 + f / 9.265) / a_gamma
    poles = np.exp(-2 * np.pi * b / fs) * np.exp(1j * 2 * np.pi * f / fs)
    return poles, 2 * (1 - np.abs(poles)) ** n


def gammatone_band(x: np.ndarray, pole: complex, gain: float) -> np.ndarray:
    """One band: ``gain · x`` through four complex one-pole sections."""
    sos = np.tile(np.array([1, 0, 0, 1, -pole, 0], dtype=np.complex128), (4, 1))
    return gain * ss.sosfilt(sos, x.astype(np.complex128), axis=-1)


def octave_bands(config: dict) -> list:
    """The fractional-octave Butterworth SOS, lowest first: centres
    1000·10^(3k/(10·b)) Hz whose nominal lies in the range, edges
    fc·10^(∓3/(20·b)); a band above Nyquist a high-pass."""
    fs = _fs(config)
    o = config["fractional_octave"]
    b = int(o["fraction"])
    lo, hi = map(float, o["frequency_range_hz"])
    k_lo = round(10 * b / 3 * math.log10(lo / 1000))
    k_hi = round(10 * b / 3 * math.log10(hi / 1000))
    out = []
    for k in range(k_lo, k_hi + 1):
        fc = 1000 * 10 ** (3 * k / (10 * b))
        f1, f2 = fc * 10 ** (-3 / (20 * b)), fc * 10 ** (3 / (20 * b))
        if f2 > fs // 2:
            out.append(ss.butter(int(o["order"]), f1, "highpass", fs=fs, output="sos"))
        else:
            out.append(ss.butter(int(o["order"]), [f1, f2], "bandpass", fs=fs, output="sos"))
    return out


def resample(config: dict, x: np.ndarray) -> np.ndarray:
    up, down = Fraction(int(config["resample_hz"]), _fs(config)).as_integer_ratio()
    return ss.resample_poly(x, up, down, axis=-1)


def tasks(config: dict, x: np.ndarray) -> dict:
    """Every output of ``x (rows, T)`` float64 as work for a pool: ``{name:
    [callable, ...]}``, one callable a band (the crossover's bands come
    from one callable, since each stage feeds the next), each returning a
    list of bands."""
    poles, gains = gammatone_poles(config)
    return {
        "lr": [lambda: crossover(config, x)],
        "gammatone": [lambda p=p, g=g: [gammatone_band(x, p, g)] for p, g in zip(poles, gains)],
        "resampled": [lambda: [resample(config, x)]],
        "third": [lambda sos=sos: [ss.sosfilt(sos, x, axis=-1)] for sos in octave_bands(config)],
    }


def sample_rows(config: dict, rng) -> list:
    """Two channels from each quarter of the channels (all of them when
    there are at most eight)."""
    C = int(config["channels"])
    if C <= 4 * ROWS_PER_QUARTER:
        return list(range(C))
    edges = np.linspace(0, C, 5).astype(int)
    rows = []
    for a, b in zip(edges[:-1], edges[1:]):
        rows += sorted(rng.choice(np.arange(a, b), ROWS_PER_QUARTER, replace=False).tolist())
    return rows


def _workers() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def compare(config: dict, x: torch.Tensor, got: dict, rows: list) -> dict:
    """The numbers compared for one call on the recording ``x (C, T)``,
    on the sampled ``rows``: each ``<output>_gap`` is the largest over the
    rows of max |got - ref| over the output's bands and samples, divided by
    the row's max |ref| over them (a channel's bank against its own
    scale)."""
    xr = x[rows].double().cpu().numpy()
    got = {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in got.items()}
    for k in ("lr", "gammatone", "third"):
        got[k] = list(got[k])
    got["resampled"] = [got["resampled"]]

    def judged(name, fn, first):
        """Per row: max |got - ref| and max |ref| over the callable's bands."""
        refs = fn()
        if first + len(refs) > len(got[name]) or (name == "lr" and len(refs) != len(got[name])):
            return None
        err = np.zeros(len(rows))
        scale = np.zeros(len(rows))
        for j, r in enumerate(refs):
            g = got[name][first + j]
            if g.shape != r.shape:
                return None
            err = np.maximum(err, np.abs(g - r).max(axis=-1))
            scale = np.maximum(scale, np.abs(r).max(axis=-1))
        return err, scale

    with ThreadPoolExecutor(_workers()) as pool:
        futs = {}
        for name, fns in tasks(config, xr).items():
            n_bands = len(got[name])
            if name != "lr" and len(fns) != n_bands:
                futs[name] = None
                continue
            futs[name] = [pool.submit(judged, name, fn, j) for j, fn in enumerate(fns)]
        res = {}
        for name, fs in futs.items():
            parts = None if fs is None else [f.result() for f in fs]
            if parts is None or any(p is None for p in parts):
                res[f"{name}_gap"] = float("nan")
                continue
            err = np.max([p[0] for p in parts], axis=0)
            scale = np.max([p[1] for p in parts], axis=0)
            res[f"{name}_gap"] = float((err / np.where(scale > 0, scale, 1.0)).max())
    return res


def _round_bf16(a: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.is_complex():
        return torch.complex(t.real.to(torch.bfloat16).double(),
                             t.imag.to(torch.bfloat16).double()).numpy()
    return t.to(torch.bfloat16).double().numpy()


class Control:
    """The reference in the program's place with the data in bfloat16: the
    recording rounded to bfloat16, filtered in float64, every output
    rounded to bfloat16 (the storage a later change would be tempted to
    halve the bank's output bytes with). It computes the compared rows
    only; the numbers compared are the same."""

    def __init__(self, config: dict, traffic: dict, recordings: torch.Tensor, device,
                 rows: list):
        self.config, self.recordings, self.rows = config, recordings, rows

    def call(self, index: int, span) -> dict:
        x = _round_bf16(self.recordings[index][self.rows].double().cpu().numpy())
        with ThreadPoolExecutor(_workers()) as pool:
            futs = {k: [pool.submit(fn) for fn in fns] for k, fns in tasks(self.config, x).items()}
            out = {k: _round_bf16(np.stack([b for f in fs for b in f.result()]))
                   for k, fs in futs.items()}
        out["resampled"] = out["resampled"][0]
        return out

    @staticmethod
    def extract(outputs: dict, rows: list) -> dict:
        return outputs
