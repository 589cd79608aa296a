"""Audio-seconds served in the window over the window's seconds (host
clock): every completed call's audio, B x 0.12 s a stream call, a file's
length a file call."""


def read(ctx):
    return ctx.audio_s / ctx.window_s
