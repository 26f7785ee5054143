"""Host milliseconds from a round's call to its return, the mean over the
measured window (untraced) of a traced run.  Where the device is the
bottleneck the host waits on the launch queue inside the call, so this
reads the round time; where the host is, it reads the host's work."""


def read(ctx):
    d = ctx.window["dispatch_s"]
    return 1e3 * sum(d) / len(d) if d else None
