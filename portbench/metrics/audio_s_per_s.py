"""Input audio completed per second: the window's calls × the audio
seconds of a call's input, over the window (first call's start to the last
call's synchronize): all the work over all the time."""


def read(run):
    return len(run.calls) * run.work["audio_s"] / run.window_s
