"""Audio hardware IO (`dsptoolbox_tpu/audio_io`), on sounddevice when it is installed."""

from .audio_io import (
    CallbackStop,
    default_config,
    output_stream,
    play,
    play_and_record,
    print_device_info,
    record,
    set_blocksize,
    set_device,
    set_latency,
    sleep,
)

__all__ = [
    "default_config",
    "print_device_info",
    "set_latency",
    "set_blocksize",
    "set_device",
    "play_and_record",
    "record",
    "play",
    "CallbackStop",
    "sleep",
    "output_stream",
]
