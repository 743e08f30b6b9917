"""Engine stage 1, the quantized forward replay: EngineReport
forward_seconds summed over the window's attests over their number."""


def read(run):
    return run.mean("forward_s")
