"""Audio hardware IO wrappers, host side, on sounddevice
(`dsptoolbox_tpu/audio_io/audio_io.py`).

sounddevice is optional: without it every function raises a
``RuntimeError`` at call time while the module stays importable. Playback
data leaves a `Signal` through one device-to-host copy; recordings become a
`Signal` through one upload (to the default device).
"""

from __future__ import annotations

import numpy as np
import torch

from ..classes import Signal
from ..helpers.gain_and_level import normalize as _normalize


def _sd():
    try:
        import sounddevice as sd

        return sd
    except ImportError as e:
        raise RuntimeError(
            "sounddevice is not available in this environment; audio "
            "hardware IO is disabled. Install sounddevice to use "
            "dsptoolbox_tpu_torch.audio_io."
        ) from e


class _DefaultConfig:
    """Lazy proxy for ``sounddevice.default`` — the reference exposes it
    as the module attribute ``default_config`` (`audio_io/audio_io.py:22`).
    Attribute access resolves against sounddevice at call time so the
    module stays importable without audio hardware."""

    def __getattr__(self, name):
        return getattr(_sd().default, name)

    def __setattr__(self, name, value):
        setattr(_sd().default, name, value)

    def __repr__(self):  # pragma: no cover
        try:
            return repr(_sd().default)
        except RuntimeError:
            return "<default_config: sounddevice unavailable>"


default_config = _DefaultConfig()


def print_device_info(device_number: int | None = None):
    """Print available audio devices, or a single device's info when a
    device number is given; returns what was printed
    (`audio_io.py:25-50`)."""
    sd = _sd()
    if device_number is None:
        info = sd.query_devices()
    else:
        info = sd.query_devices(device_number)
    print(info)
    return info


def set_latency(input_low: bool, output_low: bool):
    """Request "low" or "high" latency per direction on the sounddevice
    default (`audio_io.py:53-74`): sounddevice only supports these two
    levels, as an (input, output) pair."""
    _sd().default.latency = (
        "low" if input_low else "high",
        "low" if output_low else "high",
    )


def set_blocksize(blocksize: int):
    """Set the default stream block size (`audio_io.py:77-89`)."""
    _sd().default.blocksize = blocksize


def get_interface_number_by_name(name: str, device_list) -> tuple[int, str]:
    """Find a device by (case-insensitive) substring of its name → first
    matching ``(index, full_name)`` (`audio_io.py:177-200`)."""
    for ind, dev in enumerate(device_list):
        full_name: str = dev["name"]
        if name.lower() in full_name.lower():
            return ind, full_name
    raise ValueError(f"No device was found with name {name}")


def set_device(
    device: list[int] | list[str] | str | int | None = None,
    sampling_rate_hz: int | None = None,
):
    """Set the default input/output device from an index, a name
    substring, a 2-list of either, or interactively when `None`
    (`audio_io.py:92-174`). Optionally also sets the default sampling
    rate. Returns the device list."""
    sd = _sd()
    if device is None:
        txt = "List of available devices"
        print(txt + "\n" + "-" * len(txt))
        print(sd.query_devices())
        print("-" * len(txt))
        device = input(
            "Which device should be set as default? Between "
            + f"0 and {len(sd.query_devices()) - 1}: "
        )
        device = [int(d) for d in device.split(",")]
        if len(device) == 1:
            device = device[0]
    device_list = sd.query_devices()
    if type(device) is int:
        print(f"{device_list[device]['name']} will be used for input and "
              "output!")
        sd.default.device = device
    elif type(device) is str:
        d_id, d_name = get_interface_number_by_name(device, device_list)
        print(f"{d_name} will be used for input and output!")
        sd.default.device = d_id
    elif type(device) is list:
        assert len(device) == 2, "List with device numbers must be exactly 2"
        if type(device[0]) is int and type(device[1]) is int:
            print(f"{device_list[device[0]]['name']} will be used for "
                  "input!")
            print(f"{device_list[device[1]]['name']} will be used for "
                  "output!")
            sd.default.device = device
        elif type(device[0]) is str and type(device[1]) is str:
            d_id_in, d_name_in = get_interface_number_by_name(
                device[0], device_list
            )
            print(f"{d_name_in} will be used for input!")
            d_id_out, d_name_out = get_interface_number_by_name(
                device[1], device_list
            )
            print(f"{d_name_out} will be used for output!")
            sd.default.device = [d_id_in, d_id_out]
        else:
            raise TypeError(
                "device must be either a homogenouos list of int and "
                + "str, or an int or a str"
            )
    else:
        raise TypeError(
            "device must be either a homogenouos list of int and "
            + "str, or an int or a str"
        )
    if sampling_rate_hz is not None:
        sd.default.samplerate = sampling_rate_hz
    return sd.query_devices()


def _prepare_playback(
    signal: Signal,
    duration_seconds: float | None,
    normalized_dbfs: float | None,
) -> tuple[np.ndarray, float]:
    """Trim to duration and peak-normalize playback data
    (`audio_io.py:260-276,383-397`)."""
    if duration_seconds is not None:
        assert duration_seconds > 0, "Duration must be positive"
        duration_samples = int(duration_seconds * signal.sampling_rate_hz)
    else:
        duration_seconds = signal.length_samples / signal.sampling_rate_hz
        duration_samples = signal.length_samples
    play_data = signal.time_data[:duration_samples].cpu().numpy()
    if normalized_dbfs is not None:
        assert normalized_dbfs <= 0, "Only values beneath 0 dBFS are allowed"
        # normalization along the sample axis (time_data is (T, C))
        play_data = _normalize(
            torch.from_numpy(play_data),
            dbfs=normalized_dbfs,
            peak_normalization=True,
            per_channel=False,
            axis=0,
        ).numpy()
    return play_data, duration_seconds


def play_and_record(
    signal: Signal,
    duration_seconds: float | None = None,
    normalized_dbfs: float | None = -6,
    device: str | None = None,
    play_channels=None,
    rec_channels=[1],
) -> Signal:
    """Blocking duplex play+record; channel numbers are 1-based
    (`audio_io.py:203-292`)."""
    sd = _sd()
    if play_channels is None:
        play_channels = list(range(1, signal.number_of_channels + 1))
    if type(play_channels) is int:
        play_channels = [play_channels]
    if type(rec_channels) is int:
        rec_channels = [rec_channels]
    play_channels = sorted(play_channels)
    rec_channels = sorted(rec_channels)
    assert signal.number_of_channels == len(play_channels), (
        "The number of channels in signal does not match the number of "
        + "channels in play_channels"
    )
    assert not any(p < 1 for p in play_channels), \
        "Play channel has to be 1 or more"
    assert not any(r < 1 for r in rec_channels), \
        "Recording channel has to be 1 or more"
    play_data, duration_seconds = _prepare_playback(
        signal, duration_seconds, normalized_dbfs
    )
    if device is not None:
        sd.default.device = device
    print(
        "Playback and recording have started "
        + f"({duration_seconds:.1f} s)..."
    )
    rec_time_data = sd.playrec(
        data=play_data,
        samplerate=signal.sampling_rate_hz,
        input_mapping=rec_channels,
        output_mapping=play_channels,
        blocking=True,
    )
    print("Playback and recording have ended\n")
    return Signal(None, np.asarray(rec_time_data), signal.sampling_rate_hz)


def record(
    duration_seconds: float = 5,
    sampling_rate_hz: int = 48000,
    device: str | int | None = None,
    rec_channels=[1],
) -> Signal:
    """Blocking recording; channel numbers are 1-based
    (`audio_io.py:295-343`)."""
    sd = _sd()
    if type(rec_channels) is int:
        rec_channels = [rec_channels]
    rec_channels = sorted(rec_channels)
    assert not any(r < 1 for r in rec_channels), \
        "Recording channel has to be 1 or more"
    if device is not None:
        sd.default.device = device
    print(f"\nRecording started ({duration_seconds:.1f} s)...")
    rec_time_data = sd.rec(
        frames=int(duration_seconds * sampling_rate_hz),
        samplerate=sampling_rate_hz,
        mapping=rec_channels,
        blocking=True,
    )
    print("Recording has ended\n")
    return Signal(None, np.asarray(rec_time_data), sampling_rate_hz)


def play(
    signal: Signal,
    duration_seconds: float | None = None,
    normalized_dbfs: float | None = -6,
    device: str | None = None,
    play_channels: int | list | tuple | None = None,
):
    """Blocking playback; channel numbers are 1-based
    (`audio_io.py:346-409`)."""
    sd = _sd()
    if play_channels is None:
        play_channels = list(range(1, signal.number_of_channels + 1))
    if type(play_channels) is int:
        play_channels = [play_channels]
    play_channels = sorted(play_channels)
    assert not any(r < 1 for r in play_channels), \
        "Play channel has to be 1 or more"
    play_data, duration_seconds = _prepare_playback(
        signal, duration_seconds, normalized_dbfs
    )
    if device is not None:
        sd.default.device = device
    print(f"Playback started ({duration_seconds:.1f} s)...")
    sd.play(
        data=play_data,
        samplerate=signal.sampling_rate_hz,
        mapping=play_channels,
        blocking=True,
    )
    print("Playback has ended\n")


def CallbackStop():
    """Stop an active stream from inside its callback — wraps
    sounddevice's CallbackStop (`audio_io.py:412-417`)."""
    _sd().CallbackStop()


def sleep(seconds: float):
    """Wait while a stream runs (`audio_io.py:420-430`)."""
    _sd().sleep(int(seconds * 1000))


def output_stream(
    signal: Signal,
    blocksize=2048,
    device=None,
    latency=None,
    extra_settings=None,
    callback=None,
    finished_callback=None,
    clip_off=None,
    dither_off=None,
    never_drop_input=None,
    prime_output_buffers_using_stream_callback=None,
):
    """Create a sounddevice OutputStream configured for the signal
    (`audio_io.py:433-495`)."""
    sd = _sd()
    return sd.OutputStream(
        samplerate=signal.sampling_rate_hz,
        blocksize=blocksize,
        device=device,
        channels=signal.number_of_channels,
        dtype=None,
        latency=latency,
        extra_settings=extra_settings,
        callback=callback,
        finished_callback=finished_callback,
        clip_off=clip_off,
        dither_off=dither_off,
        never_drop_input=never_drop_input,
        prime_output_buffers_using_stream_callback=(
            prime_output_buffers_using_stream_callback
        ),
    )
